"""Pyramid resampling (port of ``bcd_tpu/ops/resample.py``; reference
MultiscaleDenoiser.cpp).

- ``downscale_sum``/``downscale_average``: 2x2 block reductions
  (reference :243-295); an odd last row or column is dropped.
- ``downscale_sample_covariance_sum``: weighted 2x2 sum with
  w_i = (1/16) * sum(N) / N_i (reference :297-334).
- ``interpolate``: the 9/16, 3/16, 1/16 2x upsample with edge clamps
  (reference :473-512); handles odd target sizes.
- ``merge_outputs``: merged = H - interpolate(downscale(H)) + interpolate(L)
  (reference :453-466, 541-548).

Arrays are (H, W, C) tensors.
"""

from __future__ import annotations

import torch


def _quads(img: torch.Tensor):
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    v = img[: 2 * h2, : 2 * w2]
    return v[0::2, 0::2], v[1::2, 0::2], v[0::2, 1::2], v[1::2, 1::2]


def downscale_sum(img: torch.Tensor) -> torch.Tensor:
    a, b, c, d = _quads(img)
    return a + b + c + d


def downscale_average(img: torch.Tensor) -> torch.Tensor:
    return 0.25 * downscale_sum(img)


def downscale_sample_covariance_sum(cov: torch.Tensor,
                                    nb: torch.Tensor) -> torch.Tensor:
    """cov: (H, W, 6); nb: (H, W, 1) or (H, W)."""
    if nb.dim() == 3:
        nb = nb[..., 0]
    cov_quads = _quads(cov)
    nb_quads = _quads(nb)
    nsum = nb_quads[0] + nb_quads[1] + nb_quads[2] + nb_quads[3]
    out = torch.zeros_like(cov_quads[0])
    for ci, ni in zip(cov_quads, nb_quads):
        out = out + (nsum / (16.0 * ni))[..., None] * ci
    return out


def interpolate(img: torch.Tensor, up_h: int, up_w: int) -> torch.Tensor:
    """2x upsample of (H, W, C) to (up_h, up_w, C), where H == up_h // 2
    and W == up_w // 2."""
    h, w = img.shape[:2]
    if h != up_h // 2 or w != up_w // 2:
        raise ValueError(f"cannot interpolate {tuple(img.shape)} to "
                         f"({up_h}, {up_w})")
    ul = torch.arange(up_h, device=img.device)
    uc = torch.arange(up_w, device=img.device)
    line = torch.clamp(ul // 2, max=h - 1)
    col = torch.clamp(uc // 2, max=w - 1)
    adj_line = torch.clamp(ul // 2 + (ul % 2) * 2 - 1, 0, h - 1)
    adj_col = torch.clamp(uc // 2 + (uc % 2) * 2 - 1, 0, w - 1)

    main = img[line[:, None], col[None, :]]
    right = img[line[:, None], adj_col[None, :]]
    down = img[adj_line[:, None], col[None, :]]
    diag = img[adj_line[:, None], adj_col[None, :]]
    return ((9.0 / 16.0) * main + (3.0 / 16.0) * (right + down)
            + (1.0 / 16.0) * diag)


def merge_outputs(high: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """Replace the low-frequency band of ``high`` with the (denoised)
    coarser-scale image ``low``."""
    up_h, up_w = high.shape[:2]
    low_pass = interpolate(downscale_average(high), up_h, up_w)
    return high - low_pass + interpolate(low, up_h, up_w)
