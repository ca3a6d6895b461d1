"""K1 (similar-patch masks + masked moments) and K4 (filter application +
patch aggregation) of the fused denoiser, with their plain twins.

Port of ``bcd_tpu/ops/fused_pallas.py::masks_moments2`` and
``::apply_scatter2``. The kernels are ``bcd_tpu_torch/csrc/masks_moments.cu``
and ``csrc/apply_scatter.cu``; their headers give the math, the design and
what bounds each on the card.

Both work on a batch of N halo-padded tiles. A tile is a (tp, tp, C) slab,
tp = t + 2h, whose core of t x t centers starts at (h, h); any halo
h >= b + 1 (search radius b plus the patch radius 1) works. Offsets o run
over (dy, dx) in [-b, b]^2, row-major, O = (2b+1)^2 of them. Contracts:

- K1 ``masks_moments(histo, nb, color, pixcov, valid, threshold, t, h, b)``
  with slabs (N, tp, tp, C), C = nbins, 1, 3, 6 and 2 (valid =
  [center_valid, candidate interior]) -> masks (N, t*t, O) uint8, m2
  (N, t*t, 378), misc (N, t*t, 83) (channel maps in ``ops.solve_filter``).
- K4 ``apply_scatter(masks, a2t, small, color, t, h, b)`` with K1's masks,
  K2's (N, t*t, 729) / (N, t*t, 56) outputs and the color slabs -> out
  (N, tp, tp, 4) = [color sums, estimate counts], apron included.

A CPU tensor goes to the plain twin, a CUDA tensor to the kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bcd_tpu_torch.ops import _build
from bcd_tpu_torch.ops.solve_filter import D, DTRI, MISC_CH, SMALL_CH


@functools.lru_cache(maxsize=None)
def tri_geometry(d: int):
    """Upper-triangle channel packing of a symmetric (d, d) matrix: M2 is
    symmetric, so K1 accumulates only its d(d+1)/2 unique entries. Returns
    (bases, expand_idx, dtri): the channel of (k, j >= k) is
    bases[k] + (j - k), and ``expand_idx`` (d*d,) gathers the packed
    triangle back to the full row-major matrix."""
    bases = np.zeros(d, np.int32)
    acc = 0
    for k in range(d):
        bases[k] = acc
        acc += d - k
    idx = np.empty((d, d), np.int32)
    for k in range(d):
        for j in range(d):
            a, b = (k, j) if k <= j else (j, k)
            idx[k, j] = bases[a] + (b - a)
    return bases, idx.reshape(-1), acc


@functools.lru_cache(maxsize=None)
def _tri_pack(d: int) -> np.ndarray:
    """Row-major flat indices of the packed upper triangle, in channel
    order (the inverse of ``tri_geometry``'s expansion)."""
    return np.asarray([k * d + j for k in range(d) for j in range(k, d)])


def _offsets(b: int):
    return [(dy, dx) for dy in range(-b, b + 1) for dx in range(-b, b + 1)]


def _patchify(img: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H-2, W-2, 9C): 3 x 3 patch vectors, patch pixel
    row-major, channel innermost (the reference's patch vector layout,
    DenoisingUnit.cpp:483-498); entry (i, j) is the patch centered at
    (i + 1, j + 1)."""
    h, w = img.shape[1:3]
    return torch.cat([img[:, qy : h - 2 + qy, qx : w - 2 + qx]
                      for qy in range(3) for qx in range(3)], dim=-1)


def _candidate_stack(patches: torch.Tensor, t: int, h: int, b: int):
    """(N, tp-2, tp-2, C) patch map -> (N, t, t, O, C): the patch of the
    candidate center + o for every core center and offset."""
    lo = h - 1
    return torch.stack(
        [patches[:, lo + dy : lo + dy + t, lo + dx : lo + dx + t]
         for dy, dx in _offsets(b)], dim=3)


def _box3(x: torch.Tensor) -> torch.Tensor:
    """Valid 3 x 3 box sum over dims 1, 2, patch pixels row-major."""
    h, w = x.shape[1:3]
    acc = torch.zeros_like(x[:, : h - 2, : w - 2])
    for qy in range(3):
        for qx in range(3):
            acc = acc + x[:, qy : h - 2 + qy, qx : w - 2 + qx]
    return acc


def _check_geometry(t: int, h: int, b: int, tp: int) -> None:
    if tp != t + 2 * h:
        raise ValueError(f"slab side {tp} != t + 2h = {t + 2 * h}")
    if h < b + 1:
        raise ValueError(f"halo {h} must be >= b + r = {b + 1}")


def _check_cuda(**tensors) -> None:
    dev = None
    for name, t in tensors.items():
        want = torch.uint8 if name == "masks" else torch.float32
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {want}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------


def chi2_pixels_plain(histo, nb, t: int, h: int, b: int):
    """Per-pixel chi^2 terms of every offset over the (t+2)^2 patch pixels
    of the core centers: (num, cnt), each (N, O, t+2, t+2); entry
    [o, y, x] is the pair (z, z + o) with z = (h-1+y, h-1+x) in the slab
    (DenoisingUnit.cpp:336-386, with the fused kernel's zero-denominator
    guard). The term is symmetric: offset -o at z is offset o at z - o,
    which K1's kernel uses to evaluate each pixel pair once."""
    e1, lo = t + 2, h - 1
    hist_c = histo[:, lo : lo + e1, lo : lo + e1]
    nb_c = nb[:, lo : lo + e1, lo : lo + e1]
    nums, cnts = [], []
    for dy, dx in _offsets(b):
        hist_n = histo[:, lo + dy : lo + dy + e1, lo + dx : lo + dx + e1]
        nb_n = nb[:, lo + dy : lo + dy + e1, lo + dx : lo + dx + e1]
        hsum = hist_c + hist_n
        keep = hsum > 1.0  # "TEMPORARY" bin gate, DenoisingUnit.cpp:379
        diff = nb_n * hist_c - nb_c * hist_n
        denom = torch.where(keep, nb_c * nb_n * hsum, 1.0)
        denom = torch.where(denom == 0.0, 1.0, denom)
        nums.append(torch.where(keep, diff * diff / denom, 0.0).sum(-1))
        cnts.append(keep.sum(-1, dtype=torch.float32))
    return torch.stack(nums, 1), torch.stack(cnts, 1)


def distances_plain(histo, nb, t: int, h: int, b: int) -> torch.Tensor:
    """(N, t, t, O) chi^2 histogram patch distances of every core center
    to every offset: the 3 x 3 box sums of ``chi2_pixels_plain``; +inf
    where no bin is kept."""
    num, cnt = (_box3(x.movedim(1, -1).contiguous())
                for x in chi2_pixels_plain(histo, nb, t, h, b))
    return torch.where(cnt > 0.0, num / cnt.clamp(min=1.0), torch.inf)


def masks_moments_plain(histo, nb, color, pixcov, valid, threshold,
                        t: int, h: int, b: int):
    """Plain twin of K1: per-offset distance maps vectorized over the tile,
    moments through (N, t, t, O, d) candidate stacks."""
    n_tiles = histo.shape[0]
    f32 = torch.float32
    interior = torch.stack(
        [valid[:, h + dy : h + dy + t, h + dx : h + dx + t, 1] > 0
         for dy, dx in _offsets(b)], dim=-1)
    masks = (distances_plain(histo, nb, t, h, b) <= threshold) & interior
    cv = valid[:, h : h + t, h : h + t, 0] > 0
    # the self offset is always selected for valid centers
    masks[..., masks.shape[-1] // 2] = True
    masks &= cv[..., None]

    mk = masks.to(f32)[..., None]
    cand = _candidate_stack(_patchify(color), t, h, b)  # (N, t, t, O, 27)
    cand_cov = _candidate_stack(_patchify(pixcov), t, h, b)  # (..., 54)
    wc = mk * cand
    full = torch.einsum("ntwok,ntwol->ntwkl", wc, cand).reshape(
        n_tiles, t, t, D * D)
    m2 = full[..., torch.as_tensor(_tri_pack(D), device=full.device)]
    misc = torch.cat([wc.sum(3), (mk * cand_cov).sum(3), mk.sum(3),
                      cv.to(f32)[..., None]], dim=-1)
    return (masks.to(torch.uint8).reshape(n_tiles, t * t, -1),
            m2.reshape(n_tiles, t * t, DTRI).contiguous(),
            misc.reshape(n_tiles, t * t, MISC_CH).contiguous())


def masks_moments(histo, nb, color, pixcov, valid, threshold,
                  t: int, h: int, b: int):
    """K1: similar-patch masks and masked moment sums for N tiles."""
    n_tiles, tp, nbins = histo.shape[0], histo.shape[1], histo.shape[-1]
    _check_geometry(t, h, b, tp)
    for name, x, ch in (("histo", histo, nbins), ("nb", nb, 1),
                        ("color", color, 3),
                        ("pixcov", pixcov, 6), ("valid", valid, 2)):
        if x.shape != (n_tiles, tp, tp, ch):
            raise ValueError(f"{name} must be {(n_tiles, tp, tp, ch)}, "
                             f"got {tuple(x.shape)}")
    if histo.device.type == "cpu":
        return masks_moments_plain(histo, nb, color, pixcov, valid,
                                   threshold, t, h, b)
    if histo.device.type != "cuda":
        raise ValueError(f"unsupported device {histo.device}")
    _check_cuda(histo=histo, nb=nb, color=color, pixcov=pixcov, valid=valid)
    n_off = (2 * b + 1) ** 2
    dev = histo.device
    bits = torch.empty((n_tiles, t * t, -(-n_off // 32)), dtype=torch.int32,
                       device=dev)
    masks = torch.empty((n_tiles, t * t, n_off), dtype=torch.uint8, device=dev)
    m2 = torch.empty((n_tiles, t * t, DTRI), device=dev)
    misc = torch.empty((n_tiles, t * t, MISC_CH), device=dev)
    if n_tiles == 0:  # nothing to compute: no launch
        return masks, m2, misc
    p = _build.ptr
    rc = _build.library().bcd_masks_moments(
        p(histo), p(nb), p(color), p(pixcov), p(valid), float(threshold),
        n_tiles, t, h, b, nbins, p(bits), p(masks), p(m2), p(misc),
        _build.stream_of(histo))
    _build.LAUNCHES["masks_moments"] += 1
    _build.check(rc, "masks_moments")
    return masks, m2, misc


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


def apply_scatter_plain(masks, a2t, small, color, t: int, h: int, b: int):
    """Plain twin of K4: filtered candidate fields per (center, offset),
    a segment-sum scatter at the candidate centers and the patch fan-out
    (the math of bcd_tpu/core/monoscale.py:478-519)."""
    n_tiles, tp = color.shape[0], color.shape[1]
    offs = _offsets(b)
    n_off = len(offs)
    self_o = n_off // 2
    f32 = torch.float32
    w = masks.to(f32) * small[..., D : D + 1]  # mask * main-path gate
    cand = _candidate_stack(_patchify(color), t, h, b).reshape(
        n_tiles, t * t, n_off, D)
    field = torch.einsum("npok,npkj->npoj", cand,
                         a2t.reshape(n_tiles, t * t, D, D))
    field = (field + small[:, :, None, 0:D]) * w[..., None]
    field[:, :, self_o] += small[..., D + 1 : 2 * D + 1]
    cnt = w.clone()
    cnt[:, :, self_o] += small[..., 2 * D + 1]

    py, px = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    offs_np = np.asarray(offs)
    seg = ((h + py.reshape(-1, 1) + offs_np[None, :, 0]) * tp
           + (h + px.reshape(-1, 1) + offs_np[None, :, 1])).reshape(-1)
    facc = torch.zeros((n_tiles, tp * tp, D + 1), dtype=f32,
                       device=color.device)
    facc.index_add_(1, torch.as_tensor(seg, device=color.device),
                    torch.cat([field, cnt[..., None]], -1).reshape(
                        n_tiles, t * t * n_off, D + 1))
    facc = facc.reshape(n_tiles, tp, tp, D + 1)
    # pixel y receives component group q of the candidate field at y - q;
    # candidates lie in [h-b, h+t+b) and |q| <= 1 < h - b + 1, so the
    # rolls wrap only zeros
    out = torch.zeros((n_tiles, tp, tp, 4), dtype=f32, device=color.device)
    for qi, (qy, qx) in enumerate(
            (qy, qx) for qy in (-1, 0, 1) for qx in (-1, 0, 1)):
        shifted = torch.roll(facc, (qy, qx), dims=(1, 2))
        out[..., 0:3] += shifted[..., 3 * qi : 3 * qi + 3]
        out[..., 3] += shifted[..., D]
    return out


def apply_scatter(masks, a2t, small, color, t: int, h: int, b: int):
    """K4: filter application and patch aggregation for N tiles."""
    n_tiles, tp = color.shape[0], color.shape[1]
    _check_geometry(t, h, b, tp)
    n_off = (2 * b + 1) ** 2
    for name, x, shape in (("masks", masks, (n_tiles, t * t, n_off)),
                           ("a2t", a2t, (n_tiles, t * t, D * D)),
                           ("small", small, (n_tiles, t * t, SMALL_CH)),
                           ("color", color, (n_tiles, tp, tp, 3))):
        if x.shape != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if masks.dtype != torch.uint8:
        raise ValueError("masks must be uint8")
    if color.device.type == "cpu":
        return apply_scatter_plain(masks, a2t, small, color, t, h, b)
    if color.device.type != "cuda":
        raise ValueError(f"unsupported device {color.device}")
    _check_cuda(masks=masks, a2t=a2t, small=small, color=color)
    dev = color.device
    e = t + 2 * b
    f_scratch = torch.empty((n_tiles, e * e, D + 1), device=dev)
    out = torch.empty((n_tiles, tp, tp, 4), device=dev)
    if n_tiles == 0:  # nothing to compute: no launch
        return out
    p = _build.ptr
    rc = _build.library().bcd_apply_scatter(
        p(masks), p(a2t), p(small), p(color), n_tiles, t, h, b,
        p(f_scratch), p(out), _build.stream_of(color))
    _build.LAUNCHES["apply_scatter"] += 1
    _build.check(rc, "apply_scatter")
    return out
