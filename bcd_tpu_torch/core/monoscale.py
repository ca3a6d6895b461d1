"""Monoscale Bayesian collaborative denoiser: the tiled engine (port of
``bcd_tpu/core/monoscale.py``; reference Denoiser.cpp + DenoisingUnit.cpp).

The image is cut into t x t core tiles with a halo of h = b + r pixels. Each
batch of tiles goes through one of two tile engines, which return the
apron-inclusive (out_sum, count) contribution of their centers; the
contributions are overlap-added in one deterministic pass
(``torch.nn.functional.fold``, a gather) and normalized as sum / count.

- Patch radius 1: the fused K1 -> K2 -> K4 pipeline (``core/fused.py``).
- Any other radius: the candidate-stack engine below, the port of JAX's
  non-fused ``denoise_tile`` (monoscale.py:344-522). The per-pixel solve is
  the ``solve_filter`` kernel, run only on the main-path centers.

Each kernel launches once per batch of tiles, not once per tile. With
``collect_stats`` each tile engine also returns its batch's main-path and
fallback pixel counts (the reference's DenoisingStatistics,
DenoisingUnit.cpp:56-69), summed on the device into one int64 tensor a
scale and read once; a progress callback hears once per tile batch,
without a synchronization.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bcd_tpu_torch.chrono import PhaseStats, device_phase
from bcd_tpu_torch.params import DenoiserParameters
from bcd_tpu_torch.convert import to_device
from bcd_tpu_torch.ops.solve_filter import solve_filter_pm

# Jacobi sweeps of solve_filter_pm in the candidate-stack engine: JAX's
# accelerator path calls solve_filter without ``sweeps``
# (bcd_tpu/core/monoscale.py:412-415), so it runs the kernel's default 6
# (ops/solve_filter_pallas.py:442), not MonoscaleConfig.solve_sweeps (K2's)
SOLVE_FILTER_SWEEPS = 6
FUSED_TILE_BATCH = 128
# at r = 2, b = 6, t = 32 a batch of 16 tiles holds a (16384, 169, 75) fp32
# candidate stack of 831 MB, and the filtered field as much again
STACK_TILE_BATCH = 16


@dataclass(frozen=True)
class MonoscaleConfig:
    """Configuration of the engine."""

    patch_radius: int = 1
    search_radius: int = 6
    tile: int = 32  # core tile side, in pixels
    solve_sweeps: int = 4  # Jacobi sweeps of K2's eigenvalue clamp
    # tiles per kernel launch; None: FUSED_TILE_BATCH for the fused engine,
    # STACK_TILE_BATCH for the candidate-stack engine
    tile_batch: Optional[int] = None
    # solve only every skip_stride-th center on both axes (the deterministic
    # analog of the reference's skip marking, DenoisingUnit.cpp:163-173);
    # at most 2r + 1, so the patch aggregation still covers every pixel
    skip_stride: int = 1
    collect_stats: bool = False

    def __post_init__(self):
        if self.patch_radius < 1:
            raise ValueError(f"patch radius {self.patch_radius} must be >= 1")
        if not 1 <= self.skip_stride <= self.k:
            raise ValueError(f"skip_stride {self.skip_stride} must be in "
                             f"[1, 2r + 1 = {self.k}]")
        if self.tile < 1 or (self.tile_batch is not None
                             and self.tile_batch < 1):
            raise ValueError(f"bad tile {self.tile} / batch {self.tile_batch}")

    @property
    def fused(self) -> bool:  # the engine: fused K1 -> K2 -> K4 at r = 1
        return self.patch_radius == 1

    @property
    def batch(self) -> int:
        return self.tile_batch or (FUSED_TILE_BATCH if self.fused
                                   else STACK_TILE_BATCH)

    @property
    def halo(self) -> int:
        return self.patch_radius + self.search_radius

    @property
    def k(self) -> int:  # patch side
        return 2 * self.patch_radius + 1

    @property
    def npx(self) -> int:  # pixels per patch
        return self.k * self.k

    @property
    def d(self) -> int:  # color patch dimension
        return 3 * self.npx


def _offsets(cfg: MonoscaleConfig) -> np.ndarray:
    """(O, 2) window offsets (dy, dx), row-major over [-b, b]^2."""
    b = cfg.search_radius
    dy, dx = np.meshgrid(np.arange(-b, b + 1), np.arange(-b, b + 1),
                         indexing="ij")
    return np.stack([dy.ravel(), dx.ravel()], axis=1)


def _stride_center_mask(cfg: MonoscaleConfig, rows_g, cols_g, height: int,
                        width: int):
    """Solved-center mask for ``skip_stride`` > 1 (broadcasts over the given
    global row / column index tensors); None at stride 1.

    Centers on a regular stride grid anchored so that the first and last
    interior row and column are always centers (the deterministic
    replacement for the reference's skip marking, Denoiser.cpp:161-162 +
    DenoisingUnit.cpp:163-173, 690). With stride <= 2r+1 every interior
    pixel lies within the patch radius of a solved center."""
    s = cfg.skip_stride
    if s <= 1:
        return None
    r = cfg.patch_radius

    def on(v, size):
        return ((v - r) % s == 0) | (v == size - 1 - r)

    return on(rows_g, height) & on(cols_g, width)


def _patchify(img: torch.Tensor, radius: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H-2r, W-2r, (2r+1)^2 C): per-pixel patch vectors,
    patch pixel row-major, channel innermost (the reference's color patch
    layout, DenoisingUnit.cpp:483-498)."""
    h, w = img.shape[1:3]
    k = 2 * radius + 1
    return torch.cat([img[:, dy : h - 2 * radius + dy, dx : w - 2 * radius + dx]
                      for dy in range(k) for dx in range(k)], dim=-1)


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Valid-mode k x k box sum over the last two dims."""
    for axis in (-2, -1):
        n = x.shape[axis]
        acc = x.narrow(axis, 0, n - k + 1)
        for s in range(1, k):
            acc = acc + x.narrow(axis, s, n - k + 1)
        x = acc
    return x


def _distance_masks(cfg, histo, nb, gy, gx, ly, lx, core_h: int, core_w: int,
                    height: int, width: int, threshold: float):
    """Similar-patch masks for N tiles: (N, O, t, t) float32 masks and the
    (N, t, t) bool center_valid.

    Inputs are (N, tp, tp, nbins) histograms and (N, tp, tp) sample counts.
    Distances follow DenoisingUnit.cpp histogramPatchDistance, as JAX's
    plain path computes them: no guard against a zero denominator (the
    fused K1 has one). Candidates outside the global interior are
    rejected, the self offset is selected for every valid center, and
    centers are restricted to the owned core and the stride grid.

    The offsets go one window row (2b + 1 offsets) at a time: a launch per
    offset would leave the card idle behind the host."""
    t, r, b, h = cfg.tile, cfg.patch_radius, cfg.search_radius, cfg.halo
    e, lo = t + 2 * r, h - r
    hist_c = histo[:, None, lo : lo + e, lo : lo + e]
    nb_c = nb[:, None, lo : lo + e, lo : lo + e, None]
    span = torch.arange(t, device=histo.device)
    rows = gy[:, None] + span  # (N, t) global center rows
    cols = gx[:, None] + span
    dxs = torch.arange(-b, b + 1, device=histo.device)

    def inside(v, size):
        return (v >= r) & (v <= size - 1 - r)

    def window_row(img, dy):  # (N, 2b + 1, e, e, ...): offsets (dy, -b..b)
        return torch.stack([img[:, lo + dy : lo + dy + e,
                                lo + dx : lo + dx + e]
                            for dx in range(-b, b + 1)], dim=1)

    # columns of the candidates at each dx: (N, 2b + 1, 1, t)
    cols_ok = inside(cols[:, None, :] + dxs[None, :, None], width)[:, :, None]
    masks = []
    for dy in range(-b, b + 1):
        hist_n = window_row(histo, dy)
        nb_n = window_row(nb, dy)[..., None]
        hsum = hist_c + hist_n
        keep = hsum > 1.0  # "TEMPORARY" bin gate, DenoisingUnit.cpp:379
        diff = nb_n * hist_c - nb_c * hist_n
        denom = torch.where(keep, nb_c * nb_n * hsum, 1.0)
        num = _box_sum(torch.where(keep, diff * diff / denom, 0.0).sum(-1),
                       cfg.k)
        cnt = _box_sum(keep.sum(-1, dtype=torch.float32), cfg.k)
        dist = torch.where(cnt > 0, num / cnt.clamp(min=1.0), torch.inf)
        masks.append((dist <= threshold)
                     & inside(rows + dy, height)[:, None, :, None] & cols_ok)
    masks = torch.cat(masks, dim=1)

    owned = (((ly[:, None] + span) < core_h)[:, :, None]
             & ((lx[:, None] + span) < core_w)[:, None, :])
    center_valid = (inside(rows, height)[:, :, None]
                    & inside(cols, width)[:, None, :] & owned)
    stride = _stride_center_mask(cfg, rows[:, :, None], cols[:, None, :],
                                 height, width)
    if stride is not None:
        center_valid = center_valid & stride
    masks[:, masks.shape[1] // 2] = center_valid
    masks &= center_valid[:, None]
    return masks.float(), center_valid


def candidate_stacks(cfg, color, nb, histo, pixcov, gy, gx, ly, lx,
                     core_h: int, core_w: int, height: int, width: int,
                     threshold: float):
    """The solve's per-center inputs for N tiles, pixel-major over the
    P = N t t centers (tile, row, column): a dict of ``mask`` (P, O),
    ``cand`` (P, O, d) candidate patches, ``m`` (P, d) masked mean patches,
    ``noise`` (P, 6 npx) masked mean noise channels, ``n`` (P,) set sizes,
    and the ``main`` / ``fb`` (P,) bool gates (JAX monoscale.py:349-410)."""
    t, b = cfg.tile, cfg.search_radius
    masks, center_valid = _distance_masks(
        cfg, histo, nb[..., 0], gy, gx, ly, lx, core_h, core_w, height,
        width, threshold)
    offs = _offsets(cfg).tolist()
    n_tiles, n_off = masks.shape[:2]
    p_total = n_tiles * t * t

    def at(img, dy, dx):  # the candidates at offset (dy, dx) of every center
        return img[:, b + dy : b + dy + t, b + dx : b + dx + t]

    # patchifying the whole slab gives the patches of the extended core
    # [r, r + t + 2b): entry (i, j) is the patch centered at (r + i, r + j)
    cp_ext = _patchify(color, cfg.patch_radius)
    cv_ext = _patchify(pixcov, cfg.patch_radius)
    cand = torch.stack([at(cp_ext, dy, dx) for dy, dx in offs],
                       dim=3).reshape(p_total, n_off, cfg.d)
    # contiguous even for one tile, where the reshape is a strided view
    mask = masks.permute(0, 2, 3, 1).reshape(p_total, n_off).contiguous()
    n = mask.sum(1)
    n_safe = n.clamp(min=1.0)
    # the noise stack (1.66 GB a 16-tile batch at r = 2, b = 6) is
    # accumulated one window row of offsets at a time, never materialized
    k_b = 2 * b + 1
    noise = torch.zeros((n_tiles, t, t, 6 * cfg.npx), device=color.device)
    for row in range(k_b):
        cv_row = torch.stack([at(cv_ext, dy, dx)
                              for dy, dx in offs[row * k_b : (row + 1) * k_b]],
                             dim=1)
        noise += (masks[:, row * k_b : (row + 1) * k_b, :, :, None]
                  * cv_row).sum(1)
    cv = center_valid.reshape(p_total)
    main = (n >= cfg.d + 1) & cv
    return {
        "mask": mask, "cand": cand, "n": n_safe,
        "m": torch.einsum("po,pod->pd", mask, cand) / n_safe[:, None],
        "noise": noise.reshape(p_total, -1) / n_safe[:, None],
        "main": main, "fb": cv & ~main,
    }


def denoise_tiles(cfg, color, nb, histo, pixcov, gy, gx, ly, lx,
                  core_h: int, core_w: int, height: int, width: int,
                  threshold: float, min_eigen: float):
    """Denoise N tiles with the candidate-stack engine. Inputs are
    (N, tp, tp, C) halo-padded slabs and (N,) integer tile origins; returns
    (out_sum (N, tp, tp, 3), count (N, tp, tp)), the apron-inclusive
    contributions for the global overlap-add.

    Only main-path centers go through ``solve_filter_pm``, which reads them
    from the pixel-major stacks in place (its ``rows``) and leaves the other
    rows of the field 0: JAX runs the solve on every center and multiplies
    the fallback and invalid ones by a zero gate (monoscale.py:418), which
    this skips. Each center's solve is independent, so the result is the
    same, and centers off the stride grid cost nothing.

    With ``cfg.collect_stats`` a third value is returned: the batch's
    (main-path, fallback) center counts, an int64 tensor (2,)."""
    t, r, b = cfg.tile, cfg.patch_radius, cfg.search_radius
    tp = color.shape[1]
    n_tiles = color.shape[0]
    s = candidate_stacks(cfg, color, nb, histo, pixcov, gy, gx, ly, lx,
                         core_h, core_w, height, width, threshold)
    p_total, n_off, d = s["cand"].shape
    self_o = n_off // 2
    main = s["main"].float()

    field = solve_filter_pm(s["cand"], s["mask"], s["noise"], s["n"], s["m"],
                            min_eigen, npx=cfg.npx,
                            sweeps=SOLVE_FILTER_SWEEPS,
                            rows=s["main"].nonzero()[:, 0])
    field[:, self_o] += s["fb"].float()[:, None] * s["m"]
    cnt = s["mask"] * main[:, None]
    cnt[:, self_o] += s["fb"].float()

    # segment sum at the candidate centers (DenoisingUnit.cpp:672-693): a
    # fold with kernel 2b+1 puts offset o of center (y, x) at (y, x) + o in
    # the candidate frame [r, r + t + 2b) of the slab
    e, kb = t + 2 * b, 2 * b + 1
    facc = F.fold(field.reshape(n_tiles, t * t, n_off, d).permute(0, 3, 2, 1)
                  .reshape(n_tiles, d * n_off, t * t), (e, e), kb)
    cacc = F.fold(cnt.reshape(n_tiles, t * t, n_off).transpose(1, 2),
                  (e, e), kb)
    # fan out: pixel y receives component group q of the candidate at
    # y - q, a fold with kernel 2r+1 from the candidate frame to the slab
    k, npx = cfg.k, cfg.npx
    groups = facc.reshape(n_tiles, npx, 3, e * e).transpose(1, 2)
    out = F.fold(groups.reshape(n_tiles, 3 * npx, e * e), (tp, tp), k)
    count = F.fold(cacc.reshape(n_tiles, 1, e * e).expand(-1, npx, -1),
                   (tp, tp), k)
    if cfg.collect_stats:
        return (out.permute(0, 2, 3, 1), count[:, 0],
                torch.stack([s["main"].sum(), s["fb"].sum()]))
    return out.permute(0, 2, 3, 1), count[:, 0]


def _pad_hw(img: torch.Tensor, top: int, bottom: int, left: int, right: int,
            fill: float = 0.0) -> torch.Tensor:
    return F.pad(img, (0, 0, left, right, top, bottom), value=fill)


def tile_batches(cfg: MonoscaleConfig, color_p, nb_p, histo_p, cov_p):
    """Cut halo-padded (core_h + 2h, core_w + 2h, C) inputs into tile
    slabs. Yields, per batch of up to ``cfg.batch`` tiles,
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
    for k0 in range(0, n_tiles, cfg.batch):
        idx = torch.arange(k0, min(k0 + cfg.batch, n_tiles), device=dev)
        ly, lx = (idx // nx) * t, (idx % nx) * t
        rows = (ly[:, None] + span)[:, :, None]
        cols = (lx[:, None] + span)[:, None, :]
        yield idx, (ly, lx), [g[rows, cols] for g in grids]


def denoise_accumulate(cfg: MonoscaleConfig, color_p, nb_p, histo_p, cov_p,
                       threshold: float, min_eigen: float,
                       origin=(0, 0), global_shape=None,
                       progress: Optional[Callable[[float], None]] = None):
    """Run the engine over a halo-padded slab and return the unnormalized
    ``(out_sum, count)`` accumulators, apron-inclusive.

    Inputs are (core_h + 2h, core_w + 2h, C): the owned core plus a halo of
    zeros (nb: ones) at image borders or a neighbor's pixels. ``origin`` is
    the core's top-left corner in global image coordinates and
    ``global_shape`` the full image size: interior and window-truncation
    masks are evaluated globally. The accumulators (core_h + 2h,
    core_w + 2h[, 3]) hold, in the apron, contributions that belong to
    neighboring slabs. With ``cfg.collect_stats`` a third value is
    returned: the (main-path, fallback) pixel counts, an int64 tensor (2,)
    on the device. ``progress`` hears k / n once the k-th of n tile
    batches is enqueued."""
    from bcd_tpu_torch.core.fused import denoise_tiles_fused

    tiles = denoise_tiles_fused if cfg.fused else denoise_tiles
    t, h = cfg.tile, cfg.halo
    core_h, core_w = color_p.shape[0] - 2 * h, color_p.shape[1] - 2 * h
    g_h, g_w = global_shape if global_shape is not None else (core_h, core_w)
    ny, nx = math.ceil(core_h / t), math.ceil(core_w / t)
    tp = t + 2 * h
    contrib = torch.empty((ny * nx, 4, tp, tp), dtype=torch.float32,
                          device=color_p.device)
    counts = (torch.zeros(2, dtype=torch.int64, device=color_p.device)
              if cfg.collect_stats else None)
    n_batches = math.ceil(ny * nx / cfg.batch)
    for k, (idx, (ly, lx), slabs) in enumerate(
            tile_batches(cfg, color_p, nb_p, histo_p, cov_p)):
        out_sum, count, *batch_counts = tiles(
            cfg, *slabs, origin[0] + ly, origin[1] + lx, ly, lx,
            core_h, core_w, g_h, g_w, threshold, min_eigen)
        contrib[idx, 0:3] = out_sum.permute(0, 3, 1, 2)
        contrib[idx, 3] = count
        if batch_counts:
            counts += batch_counts[0]
        if progress is not None:
            progress((k + 1) / n_batches)
    # overlap-add: tile (ty, tx) covers [ty*t, ty*t + tp) x [tx*t, ...)
    acc = F.fold(contrib.reshape(ny * nx, 4 * tp * tp).T[None],
                 output_size=(ny * t + 2 * h, nx * t + 2 * h),
                 kernel_size=tp, stride=t)[0]
    acc = acc[:, : core_h + 2 * h, : core_w + 2 * h]
    if cfg.collect_stats:
        return acc[0:3].permute(1, 2, 0), acc[3], counts
    return acc[0:3].permute(1, 2, 0), acc[3]


def denoise_image(cfg: MonoscaleConfig, color, nb, histo, cov,
                  threshold: float, min_eigen: float,
                  progress: Optional[Callable[[float], None]] = None):
    """Denoise one whole (H, W, C) image; returns (H, W, 3), and with
    ``cfg.collect_stats`` also ``denoise_accumulate``'s counts. Pixels no
    estimate covers come out as 0."""
    height, width = color.shape[:2]
    h = cfg.halo

    def pad(img, fill=0.0):
        return _pad_hw(img, h, h, h, h, fill)

    out_acc, cnt_acc, *counts = denoise_accumulate(
        cfg, pad(color), pad(nb, 1.0), pad(histo), pad(cov),
        threshold, min_eigen, origin=(0, 0), global_shape=(height, width),
        progress=progress)
    out = out_acc[h : h + height, h : h + width]
    cnt = cnt_acc[h : h + height, h : h + width]
    final = torch.where(cnt[..., None] > 0,
                        out / cnt.clamp(min=1.0)[..., None], 0.0)
    return (final, counts[0]) if cfg.collect_stats else final


def auto_engine_config(params: DenoiserParameters,
                       tile: Optional[int] = None,
                       skip_stride: int = 1,
                       collect_stats: bool = False) -> MonoscaleConfig:
    """The engine configuration for ``params``: the one place engine
    selection happens. Patch radius 1 takes the fused engine, any other the
    candidate-stack engine (``MonoscaleConfig.fused``)."""
    return MonoscaleConfig(
        patch_radius=params.patch_radius,
        search_radius=params.search_window_radius,
        tile=tile or MonoscaleConfig.tile,
        skip_stride=skip_stride,
        collect_stats=collect_stats,
    )


def denoise_monoscale(color, nb, histo, cov, params: DenoiserParameters,
                      device, tile: Optional[int] = None,
                      skip_stride: int = 1,
                      progress_callback: Optional[
                          Callable[[float], None]] = None,
                      stats: Optional[PhaseStats] = None) -> torch.Tensor:
    """Denoise one scale. Arrays are (H, W, C) (numpy or tensors), moved
    to ``device`` as float32; returns an (H, W, 3) tensor on ``device``.

    ``progress_callback`` hears the fraction of tile batches enqueued.
    ``stats``: the scale is timed as ``denoise WxH`` (ending in a device
    synchronize) and the reference's DenoisingStatistics counters
    (DenoisingUnit.cpp:56-69) are added to it, read from the device once;
    the output is the same, bit for bit."""
    cfg = auto_engine_config(params, tile=tile, skip_stride=skip_stride,
                             collect_stats=stats is not None)
    args = (*to_device(color, nb, histo, cov, device),
            float(params.histogram_distance_threshold),
            float(params.min_eigen_value))
    if stats is None:
        return denoise_image(cfg, *args, progress=progress_callback)
    height, width = color.shape[:2]
    with device_phase(stats, f"denoise {width}x{height}", device):
        out, counts = denoise_image(cfg, *args, progress=progress_callback)
        n_main, n_fb = counts.tolist()
    stats.count("pixels: main-path solves", n_main)
    stats.count("pixels: fallback (mean patch)", n_fb)
    stats.count("pixels: managed", n_main + n_fb)
    return out
