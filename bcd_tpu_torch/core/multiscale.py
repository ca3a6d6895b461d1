"""Multiscale denoiser (port of ``bcd_tpu/core/multiscale.py``; reference
src/core/MultiscaleDenoiser.cpp).

The pyramid (reference :41-53): colors by 2x2 average, sample counts and
histograms by 2x2 sum, sample covariances by the weighted sum
w_i = (1/16) * sum(N) / N_i. The coarsest scale is denoised first, then each
finer scale is denoised and merged as
``merged = H - interpolate(downscale(H)) + interpolate(L)`` (reference
:121-126, :453-466). Progress is re-weighted by the 4^s per-scale cost
model (reference :103-112).
"""

from __future__ import annotations

from typing import Callable, Optional

from bcd_tpu_torch.chrono import PhaseStats, device_phase
from bcd_tpu_torch.params import DenoiserParameters
from bcd_tpu_torch.convert import to_device
from bcd_tpu_torch.core.monoscale import denoise_monoscale
from bcd_tpu_torch.ops import resample


def _scale_progress_mapper(nb_of_scales: int, scale: int):
    """Map per-scale progress to global progress with the 4^s cost model:
    the work of scales s..coarsest is (4^(s+1) - 1)/3 units out of
    (4^nbOfScales - 1)/3 total (reference MultiscaleDenoiser.cpp:103-112)."""
    s = nb_of_scales - 1 - scale
    factor = 1.0 / float(((1 << (2 * nb_of_scales)) - 1) // 3)
    lo = factor * float(((1 << (2 * s)) - 1) // 3)
    hi = factor * float(((1 << (2 * (s + 1))) - 1) // 3)
    return lambda p: lo + p * (hi - lo)


def denoise_multiscale(color, nb, histo, cov, params: DenoiserParameters,
                       device, nb_of_scales: int = 3,
                       tile: Optional[int] = None,
                       skip_stride: int = 1,
                       progress_callback: Optional[
                           Callable[[float], None]] = None,
                       stats: Optional[PhaseStats] = None):
    """Full multiscale denoise on ``device``; returns an (H, W, 3) tensor.

    ``stats``: the phases ``pyramid build``, ``denoise WxH`` a scale (with
    the DenoisingStatistics counters) and ``merge``, each ending in a
    device synchronize."""
    with device_phase(stats, "pyramid build", device):
        inputs = [to_device(color, nb, histo, cov, device)]
        for _ in range(nb_of_scales - 1):
            c, n, h, sc = inputs[-1]
            inputs.append((
                resample.downscale_average(c),
                resample.downscale_sum(n),
                resample.downscale_sum(h),
                resample.downscale_sample_covariance_sum(sc, n),
            ))

    merged = None
    for scale in range(nb_of_scales - 1, -1, -1):
        mapper = _scale_progress_mapper(nb_of_scales, scale)
        scale_cb = None
        if progress_callback is not None:
            progress_callback(mapper(0.0))
            scale_cb = lambda p, m=mapper: progress_callback(m(p))  # noqa: E731
        out = denoise_monoscale(*inputs[scale], params, device, tile=tile,
                                skip_stride=skip_stride,
                                progress_callback=scale_cb, stats=stats)
        if progress_callback is not None:
            progress_callback(mapper(1.0))
        if merged is None:
            merged = out
        else:
            with device_phase(stats, "merge", device):
                merged = resample.merge_outputs(out, merged)
    return merged
