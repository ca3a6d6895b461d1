"""Monoscale Bayesian collaborative denoiser: the tiled engine (port of
``bcd_tpu/core/monoscale.py``; reference Denoiser.cpp + DenoisingUnit.cpp).

The image is cut into t x t core tiles with a halo of h = b + r pixels. Each
tile is denoised by the fused K1 -> K2 -> K4 pipeline (``core/fused.py``),
which returns the apron-inclusive (out_sum, count) contribution of its
centers; the contributions are overlap-added in one deterministic pass
(``torch.nn.functional.fold``, a gather) and normalized as sum / count.
Tiles go through the kernels in batches: each kernel launches once per
batch of ``tile_batch`` tiles, not once per tile.

This slice carries the reference's default geometry only: patch radius 1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from bcd_tpu_torch.params import DenoiserParameters
from bcd_tpu_torch.convert import to_device
from bcd_tpu_torch.core.fused import denoise_tiles_fused


@dataclass(frozen=True)
class MonoscaleConfig:
    """Configuration of the engine."""

    patch_radius: int = 1
    search_radius: int = 6
    tile: int = 32  # core tile side, in pixels
    solve_sweeps: int = 4  # Jacobi sweeps of K2's eigenvalue clamp
    # tiles per kernel launch; only the tile-grid test sets it, to split a
    # small image's grid into several batches
    tile_batch: int = 128
    skip_stride: int = 1
    collect_stats: bool = False

    def __post_init__(self):
        if self.patch_radius != 1:
            raise NotImplementedError(
                f"patch radius {self.patch_radius}: the port carries r = 1 "
                "only (ROADMAP.md Queue 1, the non-fused engine, -w 2)")
        if self.skip_stride != 1:
            raise NotImplementedError(
                "skip_stride > 1 is not ported yet (ROADMAP.md Queue 1, "
                "engine options)")
        if self.collect_stats:
            raise NotImplementedError(
                "the DenoisingStatistics counters (--stats) are not ported "
                "yet (ROADMAP.md Queue 1, engine options)")
        if self.tile < 1 or self.tile_batch < 1:
            raise ValueError(f"bad tile {self.tile} / batch {self.tile_batch}")

    @property
    def halo(self) -> int:
        return self.patch_radius + self.search_radius


def _pad_hw(img: torch.Tensor, top: int, bottom: int, left: int, right: int,
            fill: float = 0.0) -> torch.Tensor:
    return F.pad(img, (0, 0, left, right, top, bottom), value=fill)


def tile_batches(cfg: MonoscaleConfig, color_p, nb_p, histo_p, cov_p):
    """Cut halo-padded (core_h + 2h, core_w + 2h, C) inputs into tile
    slabs. Yields, per batch of up to ``cfg.tile_batch`` tiles,
    (tile indices, (ly, lx) core origins in the slab, [color, nb, histo,
    pixcov] (N, tp, tp, C) slabs); tiles are numbered row-major over the
    (ceil(core_h / t), ceil(core_w / t)) grid."""
    t, h = cfg.tile, cfg.halo
    core_h, core_w = color_p.shape[0] - 2 * h, color_p.shape[1] - 2 * h
    ny, nx = math.ceil(core_h / t), math.ceil(core_w / t)
    hp, wp = ny * t, nx * t
    pixcov_p = cov_p / nb_p  # Denoiser.cpp:357-373

    def pad_to_grid(img, fill=0.0):
        return _pad_hw(img, 0, hp - core_h, 0, wp - core_w, fill)

    grids = (pad_to_grid(color_p),
             pad_to_grid(nb_p, 1.0),  # no 0-division in the chi^2 denominators
             pad_to_grid(histo_p),
             pad_to_grid(pixcov_p))
    tp = t + 2 * h
    dev = color_p.device
    span = torch.arange(tp, device=dev)
    n_tiles = ny * nx
    for k0 in range(0, n_tiles, cfg.tile_batch):
        idx = torch.arange(k0, min(k0 + cfg.tile_batch, n_tiles), device=dev)
        ly, lx = (idx // nx) * t, (idx % nx) * t
        rows = (ly[:, None] + span)[:, :, None]
        cols = (lx[:, None] + span)[:, None, :]
        yield idx, (ly, lx), [g[rows, cols] for g in grids]


def denoise_accumulate(cfg: MonoscaleConfig, color_p, nb_p, histo_p, cov_p,
                       threshold: float, min_eigen: float,
                       origin=(0, 0), global_shape=None):
    """Run the engine over a halo-padded slab and return the unnormalized
    ``(out_sum, count)`` accumulators, apron-inclusive.

    Inputs are (core_h + 2h, core_w + 2h, C): the owned core plus a halo of
    zeros (nb: ones) at image borders or a neighbor's pixels. ``origin`` is
    the core's top-left corner in global image coordinates and
    ``global_shape`` the full image size: interior and window-truncation
    masks are evaluated globally. The accumulators (core_h + 2h,
    core_w + 2h[, 3]) hold, in the apron, contributions that belong to
    neighboring slabs."""
    t, h = cfg.tile, cfg.halo
    core_h, core_w = color_p.shape[0] - 2 * h, color_p.shape[1] - 2 * h
    g_h, g_w = global_shape if global_shape is not None else (core_h, core_w)
    ny, nx = math.ceil(core_h / t), math.ceil(core_w / t)
    tp = t + 2 * h
    contrib = torch.empty((ny * nx, 4, tp, tp), dtype=torch.float32,
                          device=color_p.device)
    for idx, (ly, lx), slabs in tile_batches(cfg, color_p, nb_p, histo_p,
                                             cov_p):
        out_sum, count = denoise_tiles_fused(
            cfg, *slabs, origin[0] + ly, origin[1] + lx, ly, lx,
            core_h, core_w, g_h, g_w, threshold, min_eigen)
        contrib[idx, 0:3] = out_sum.permute(0, 3, 1, 2)
        contrib[idx, 3] = count
    # overlap-add: tile (ty, tx) covers [ty*t, ty*t + tp) x [tx*t, ...)
    acc = F.fold(contrib.reshape(ny * nx, 4 * tp * tp).T[None],
                 output_size=(ny * t + 2 * h, nx * t + 2 * h),
                 kernel_size=tp, stride=t)[0]
    acc = acc[:, : core_h + 2 * h, : core_w + 2 * h]
    return acc[0:3].permute(1, 2, 0), acc[3]


def denoise_image(cfg: MonoscaleConfig, color, nb, histo, cov,
                  threshold: float, min_eigen: float) -> torch.Tensor:
    """Denoise one whole (H, W, C) image; returns (H, W, 3). Pixels no
    estimate covers come out as 0."""
    height, width = color.shape[:2]
    h = cfg.halo

    def pad(img, fill=0.0):
        return _pad_hw(img, h, h, h, h, fill)

    out_acc, cnt_acc = denoise_accumulate(
        cfg, pad(color), pad(nb, 1.0), pad(histo), pad(cov),
        threshold, min_eigen, origin=(0, 0), global_shape=(height, width))
    out = out_acc[h : h + height, h : h + width]
    cnt = cnt_acc[h : h + height, h : h + width]
    return torch.where(cnt[..., None] > 0,
                       out / cnt.clamp(min=1.0)[..., None], 0.0)


def auto_engine_config(params: DenoiserParameters,
                       tile: Optional[int] = None) -> MonoscaleConfig:
    """The engine configuration for ``params``: the one place engine
    selection happens."""
    return MonoscaleConfig(
        patch_radius=params.patch_radius,
        search_radius=params.search_window_radius,
        tile=tile or MonoscaleConfig.tile,
    )


def denoise_monoscale(color, nb, histo, cov, params: DenoiserParameters,
                      device, tile: Optional[int] = None) -> torch.Tensor:
    """Denoise one scale. Arrays are (H, W, C) (numpy or tensors), moved
    to ``device`` as float32; returns an (H, W, 3) tensor on ``device``."""
    cfg = auto_engine_config(params, tile=tile)
    return denoise_image(
        cfg, *to_device(color, nb, histo, cov, device),
        float(params.histogram_distance_threshold),
        float(params.min_eigen_value))
