"""Fused tile pipeline K1 -> K2 -> K4 (port of
``bcd_tpu/core/fused.py::denoise_tile_fused``), for a batch of tiles.

Only per-pixel moments and filter matrices pass between the kernels:

  K1 masks_moments     -> similar-set masks + raw masked moments per center
  K2 solve_matrices_pm -> per-pixel filter (A2^T, b2) + main/fallback gates
  K4 apply_scatter     -> apron-inclusive overlap-add contribution

The glue here builds the validity maps in global coordinates, exactly as
``bcd_tpu/core/monoscale._distance_masks`` evaluates them.
"""

from __future__ import annotations

import torch

from bcd_tpu_torch.core.monoscale import _stride_center_mask
from bcd_tpu_torch.ops.fused import apply_scatter, masks_moments
from bcd_tpu_torch.ops.solve_filter import D, solve_matrices_pm


def validity_maps(cfg, gy, gx, ly, lx, core_h: int, core_w: int,
                  height: int, width: int) -> torch.Tensor:
    """(N, tp, tp, 2) float32 = [center_valid, candidate interior] for N
    tiles whose core origins are (gy, gx) globally and (ly, lx) in the
    owned slab; padded coordinate i maps to global gy + i - h.

    center_valid = interior & in_core & owned (& on the stride grid), so
    padded and apron centers are never solved and sharded slabs never solve
    a neighbor's centers."""
    t, r, h = cfg.tile, cfg.patch_radius, cfg.halo
    tp = t + 2 * h
    i = torch.arange(tp, device=gy.device)
    rows_g = gy[:, None] - h + i  # (N, tp)
    cols_g = gx[:, None] - h + i
    row_in = (rows_g >= r) & (rows_g <= height - 1 - r)
    col_in = (cols_g >= r) & (cols_g <= width - 1 - r)
    interior = row_in[:, :, None] & col_in[:, None, :]
    core = (i >= h) & (i < h + t)
    row_ok = core & ((ly[:, None] + i - h) < core_h)
    col_ok = core & ((lx[:, None] + i - h) < core_w)
    center_valid = interior & row_ok[:, :, None] & col_ok[:, None, :]
    stride = _stride_center_mask(cfg, rows_g[:, :, None], cols_g[:, None, :],
                                 height, width)
    if stride is not None:
        center_valid = center_valid & stride
    return torch.stack([center_valid, interior], dim=-1).float()


def denoise_tiles_fused(cfg, color, nb, histo, pixcov, gy, gx, ly, lx,
                        core_h: int, core_w: int, height: int, width: int,
                        threshold: float, min_eigen: float):
    """Denoise N tiles. Inputs are (N, tp, tp, C) halo-padded slabs and
    (N,) integer tile origins; returns (out_sum (N, tp, tp, 3),
    count (N, tp, tp)), the apron-inclusive contributions for the global
    overlap-add, and with ``cfg.collect_stats`` the batch's (main-path,
    fallback) pixel counts, an int64 tensor (2,)."""
    t, b, h = cfg.tile, cfg.search_radius, cfg.halo
    n_tiles = color.shape[0]
    valid = validity_maps(cfg, gy, gx, ly, lx, core_h, core_w, height, width)
    masks, m2, misc = masks_moments(histo, nb, color, pixcov, valid,
                                    threshold, t=t, h=h, b=b)
    a2t, small = solve_matrices_pm(m2.reshape(n_tiles * t * t, -1),
                                   misc.reshape(n_tiles * t * t, -1),
                                   min_eigen, sweeps=cfg.solve_sweeps)
    out = apply_scatter(masks, a2t.reshape(n_tiles, t * t, -1),
                        small.reshape(n_tiles, t * t, -1), color,
                        t=t, h=h, b=b)
    if cfg.collect_stats:
        # K2's small rows carry the gates (main path at column d, fallback
        # at 2d + 1; 0 on padded and invalid rows), so the counters are sums
        return out[..., 0:3], out[..., 3], \
            (small[:, [D, 2 * D + 1]] > 0).sum(0)
    return out[..., 0:3], out[..., 3]
