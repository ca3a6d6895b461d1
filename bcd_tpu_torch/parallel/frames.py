"""Renderfarm mode: batches of frames over devices (port of
``bcd_tpu/parallel/frames.py``).

JAX shards the frame axis of a batch over a ``frames`` mesh axis, and each
device maps over its local frames one after the other (``lax.map``). Here
the frames are cut into the same contiguous blocks, one per device, and
each device denoises its block frame after frame. The devices take their
blocks in turn from one host thread; running them concurrently waits for
the multi-card work (ROADMAP Queue 1, item 4).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bcd_tpu_torch.convert import resolve_device, to_device
from bcd_tpu_torch.core.monoscale import auto_engine_config, denoise_image
from bcd_tpu_torch.core.multiscale import denoise_multiscale
from bcd_tpu_torch.params import DenoiserParameters


def denoise_frames(colors, nbs, histos, covs, params: DenoiserParameters,
                   devices: Sequence, nb_of_scales: int = 1,
                   tile: Optional[int] = None) -> torch.Tensor:
    """Denoise a batch of frames: arrays (F, H, W, C) (numpy or tensors),
    F a multiple of ``len(devices)``. Device i takes frames
    [i F / n, (i + 1) F / n), moved to it once. Returns the (F, H, W, 3)
    tensor on ``devices[0]``.

    One scale runs the engine on the statistics as they are (no
    prefilter, no output sanitizing), as JAX's ``_denoise_image``; more
    run ``denoise_multiscale``."""
    devices = [resolve_device(d) for d in devices]
    n_frames = len(colors)
    if not devices or n_frames % len(devices):
        raise ValueError(f"{n_frames} frames do not split evenly over "
                         f"{len(devices)} devices")
    cfg = auto_engine_config(params, tile=tile)
    threshold = float(params.histogram_distance_threshold)
    min_eigen = float(params.min_eigen_value)
    per = n_frames // len(devices)
    outs = []
    for i, device in enumerate(devices):
        block = to_device(*(a[i * per : (i + 1) * per]
                            for a in (colors, nbs, histos, covs)), device)
        for frame in zip(*block):
            if nb_of_scales > 1:
                out = denoise_multiscale(*frame, params, device,
                                         nb_of_scales=nb_of_scales, tile=tile)
            else:
                out = denoise_image(cfg, *frame, threshold, min_eigen)
            outs.append(out.to(devices[0]))
    return torch.stack(outs)
