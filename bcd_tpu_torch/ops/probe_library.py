"""The one PyTorch call that computes each TPU-compiler probe's function
(``scripts/probe_*.py``; the port's own kernels for them are
``ops/probes.py``'s), timed on one CUDA card at the probe's shapes, beside
the probe's bound (``ops/bounds.probes``):

    python -m bcd_tpu_torch.ops.probe_library

Each probe's inputs are its script's, drawn from its own
``np.random.default_rng(0)`` as the script draws them
(``transpose_inputs``, ``mosaic_inputs``, ``banded_inputs``).

- ``probe_transpose``: the expansion of 2304 pixel rows of K1's packed
  moments (2304, 378) to full 27 x 27 matrices as a product with the 0/1
  expansion matrix (729, 378), lane-major (729, 2304), and its transpose
  back to pixel rows, ``.transpose(0, 1).contiguous()``;
  ``probe_transpose_fwd`` the product alone;
- ``probe_mosaic``: the sum of 13 row windows (2208 rows, 48 rows apart)
  of a (2896, 729) slab, one ``sum`` over a strided view (the unaligned
  form's function); ``probe_mosaic_aligned`` the aligned form's 39
  weighted windows, one ``einsum`` of a (13, 9) weight matrix, zero at the
  column offsets it skips, with a (13, 9, 2208, 729) strided view;
- ``probe_banded_dot``: ``torch.bmm`` of (60, 64, 64) 13-wide 0/1 band
  matrices and (60, 64, 768) slabs;
- ``bisect_kernel`` (a staged copy of ``solve_filter``) has none: no
  PyTorch call computes the clamped two-step solve.

Each is held to a float64 reference on the host (within fp32 rounding,
``FP32_REL`` of the reference's largest magnitude), timed with CUDA events
as the mean of REPS calls after a warm-up, TF32 off. Prints the card's name
and power limit last.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from bcd_tpu_torch.ops import bounds
from bcd_tpu_torch.ops.fused import tri_geometry

REPS = 50
# probe_transpose: a tile-48 block of pixels, K1's 27 x 27 moments
P, D = 2304, 27
# probe_mosaic: the slab, the window and its first row, 13 shifts 48 apart
ROWS, NPIX, C, R0, SHIFTS = 2896, 2208, 729, 344, 13
# probe_banded_dot: image rows, padded tile side, channels, band half-width
Y, TP, CH, BAND = 60, 64, 768, 6
# the aligned mosaic's column offsets within a window and their weights, as
# the script forms them: (1 + 0.1 dx) rounded to float32
DX = (-3, 0, 5)
WEIGHTS = tuple(float(np.float32(1.0 + dx * 0.1)) for dx in DX)
# the largest gap from a reference that fp32 rounding explains, over the
# reference's largest magnitude: sums of up to 39 terms in other orders,
# and three-part TF32 products (each exact) summed on the tensor cores
FP32_REL = 4e-6


def cuda_ms(fn) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def transpose_inputs(dev):
    """probe_transpose.py's m2 (P, 378) (``default_rng(0)``), its 0/1
    expansion matrix (729, 378) and the expansion's gather index (729,)
    int32, on ``dev``."""
    _, expand_idx, dtri = tri_geometry(D)
    m2 = torch.tensor(np.random.default_rng(0).standard_normal((P, dtri)),
                      dtype=torch.float32)
    index = torch.as_tensor(expand_idx).long()
    expand = torch.zeros(D * D, dtri)
    expand[torch.arange(D * D), index] = 1.0
    return m2.to(dev), expand.to(dev), index.int().to(dev)


def mosaic_inputs(dev):
    """probe_mosaic.py's slab g (ROWS, C) (``default_rng(0)``) on ``dev``."""
    return torch.tensor(np.random.default_rng(0).random((ROWS, C)),
                        dtype=torch.float32, device=dev)


def banded_inputs(dev):
    """probe_banded_dot.py's 0/1 band matrices (Y, TP, TP) and slabs (Y, TP,
    CH), drawn from ``default_rng(0)`` in the script's order, on ``dev``."""
    rng = np.random.default_rng(0)
    ri, ci = np.meshgrid(np.arange(TP), np.arange(TP), indexing="ij")
    band = (rng.random((Y, TP, TP)) < 0.5) & (np.abs(ri - ci) <= BAND)
    b = torch.tensor(band, dtype=torch.float32, device=dev)
    s = torch.tensor(rng.random((Y, TP, CH)), dtype=torch.float32,
                     device=dev)
    return b, s


def aligned_windows(g, npix: int = NPIX):
    """The aligned mosaic's windows of the slab g (rows, C) as one strided
    view (SHIFTS, 9, npix, C), for each row shift dy the rows R0 + 48 dy +
    dx at dx = DX[0] .. DX[-1], and their weights (SHIFTS, 9) in g's dtype,
    the script's at the dx in DX and zero at the others."""
    lo, span = R0 - 48 * (SHIFTS // 2) + DX[0], DX[-1] - DX[0] + 1
    w = torch.zeros(SHIFTS, span, dtype=torch.float32)
    w[:, [dx - DX[0] for dx in DX]] = torch.tensor(WEIGHTS)
    view = g.as_strided((SHIFTS, span, npix, C), (48 * C, C, C, 1),
                        g.storage_offset() + lo * C)
    return w.to(g.device, g.dtype), view


def cases(dev):
    """(name, the call, its float64 reference on the host) at each probe's
    shapes, on its script's inputs."""
    m2_d, expand_d, index = transpose_inputs(dev)

    def transpose():
        lanes = expand_d @ m2_d.T
        return lanes, lanes.transpose(0, 1).contiguous()

    first = R0 - 48 * (SHIFTS // 2) + 3
    g_d = mosaic_inputs(dev)

    def mosaic():
        return g_d.as_strided((SHIFTS, NPIX, C), (48 * C, C, 1),
                              first * C).sum(0)

    w_d, view = aligned_windows(g_d)
    b_d, s_d = banded_inputs(dev)
    lanes64 = m2_d.double().cpu()[:, index.long().cpu()].T
    g64 = g_d.double().cpu()
    rows64 = sum(g64[first + 48 * k:first + 48 * k + NPIX]
                 for k in range(SHIFTS))
    w64, view64 = aligned_windows(g64)
    aligned64 = sum(view64[k, j] * w64[k, j] for k in range(SHIFTS)
                    for j in range(w64.shape[1]) if w64[k, j])
    return [
        ("probe_transpose", transpose, (lanes64, lanes64.T)),
        ("probe_transpose_fwd", lambda: (expand_d @ m2_d.T,), (lanes64,)),
        ("probe_mosaic", mosaic, (rows64,)),
        ("probe_mosaic_aligned",
         lambda: (torch.einsum("kj,kjnc->nc", w_d, view),), (aligned64,)),
        ("probe_banded_dot", lambda: (torch.bmm(b_d, s_d),),
         (torch.bmm(b_d.double().cpu(), s_d.double().cpu()),)),
    ]


def measure(dev) -> dict[str, tuple[float, float, float]]:
    """{name: (ms, the largest gap from float64, the gap fp32 rounding
    explains)} for each case on ``dev``, TF32 off. Raises if a call leaves
    its reference by more than fp32 rounding explains."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for name, fn, refs in cases(dev):
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            err = max(float((o.double().cpu() - r).abs().max())
                      for o, r in zip(got, refs))
            limit = FP32_REL * max(float(r.abs().max()) for r in refs)
            if err > limit:
                raise RuntimeError(f"the library call {name} leaves float64 "
                                   f"by {err:.3e} (limit {limit:.3e})")
            out[name] = (cuda_ms(fn), err, limit)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    # the product alone is transpose variant D's function; the aligned
    # mosaic is a variant's function, not the script's whole
    variants = bounds.probe_variants()
    bound = {**bounds.probes(),
             "probe_transpose_fwd": variants["probe_transpose_d"],
             "probe_mosaic_aligned": variants["probe_mosaic_aligned"]}
    for name, (ms, err, limit) in measure(dev).items():
        print(f"{name}: library call {ms:.4f} ms, max abs err {err:.3e} "
              f"vs float64 (limit {limit:.3e}); bound {bound[name][0]:.4f} "
              f"ms ({bound[name][1]}), {ms / bound[name][0]:.1f}x",
              flush=True)
    print(f"bisect_kernel: library call none (no PyTorch call computes the "
          f"clamped two-step solve); bound {bound['bisect_kernel'][0]:.4f} ms",
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
