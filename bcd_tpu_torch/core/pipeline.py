"""Top-level denoise pipeline (port of ``bcd_tpu/core/pipeline.py``; the
CLI's launch path, reference src/cli/main.cpp:422-476): optional
spike-removal prefilter, mono- or multiscale denoise, NaN/negative output
sanitization."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from bcd_tpu_torch.chrono import PhaseStats, device_phase
from bcd_tpu_torch.params import PipelineParameters
from bcd_tpu_torch.convert import to_device
from bcd_tpu_torch.core.monoscale import denoise_monoscale
from bcd_tpu_torch.core.multiscale import denoise_multiscale
from bcd_tpu_torch.ops.spike_removal import spike_removal


def sanitize_output(image: torch.Tensor) -> torch.Tensor:
    """Zero out negative / NaN / Inf values (reference
    checkAndPutToZeroNegativeInfNaNValues, cli/main.cpp:389-420)."""
    bad = (image < 0) | ~torch.isfinite(image)
    return torch.where(bad, 0.0, image)


def denoise_pipeline(colors, nb_of_samples, histograms, sample_covariances,
                     device, pipeline_params: Optional[
                         PipelineParameters] = None,
                     tile: Optional[int] = None,
                     skip_stride: int = 1,
                     progress_callback: Optional[
                         Callable[[float], None]] = None,
                     stats: Optional[PhaseStats] = None) -> torch.Tensor:
    """Full pipeline on in-memory (H, W, C) arrays (numpy or tensors),
    computed on ``device``; returns the sanitized (H, W, 3) float32 tensor
    on ``device``. ``skip_stride`` > 1 solves only every skip_stride-th patch
    center on both axes (``MonoscaleConfig.skip_stride``).

    ``stats``: phase timers (prefilter, pyramid, a denoise per scale,
    merge), each ending in a device synchronize, and the reference's
    DenoisingStatistics pixel counters (DenoisingUnit.cpp:56-69); the
    output is the same, bit for bit."""
    p = pipeline_params or PipelineParameters()
    color, nb, histo, cov = to_device(colors, nb_of_samples, histograms,
                                      sample_covariances, device)

    if p.prefiltering.perform_spike_removal:
        with device_phase(stats, "spike-removal prefilter", device):
            color, nb, histo, cov = spike_removal(
                color, nb, histo, cov,
                float(p.prefiltering.spike_removal_threshold_stdev_factor))

    if p.denoiser.nb_of_scales > 1:
        out = denoise_multiscale(
            color, nb, histo, cov, p.denoiser.monoscale, device,
            nb_of_scales=p.denoiser.nb_of_scales, tile=tile,
            skip_stride=skip_stride, progress_callback=progress_callback,
            stats=stats)
    else:
        out = denoise_monoscale(color, nb, histo, cov, p.denoiser.monoscale,
                                device, tile=tile, skip_stride=skip_stride,
                                progress_callback=progress_callback,
                                stats=stats)
        if progress_callback is not None:
            progress_callback(1.0)
    return sanitize_output(out)
