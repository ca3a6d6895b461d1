"""The one PyTorch call that computes each TPU-compiler probe's function
(``scripts/probe_*.py``, not ported: ROADMAP Queue 2), timed on one CUDA
card at the probe's shapes, beside the probe's bound (``ops/bounds.probes``):

    python -m bcd_tpu_torch.ops.probe_library

- ``probe_transpose``: the expansion of 2304 pixel rows of K1's packed
  moments (2304, 378) to full 27 x 27 matrices as a product with the 0/1
  expansion matrix (729, 378), lane-major (729, 2304), and its transpose
  back to pixel rows, ``.transpose(0, 1).contiguous()``;
- ``probe_mosaic``: the sum of 13 row windows (2208 rows, 48 rows apart)
  of a (2896, 729) slab, one ``sum`` over a strided view;
- ``probe_banded_dot``: ``torch.bmm`` of (60, 64, 64) 13-wide 0/1 band
  matrices and (60, 64, 768) slabs;
- ``bisect_kernel`` (a staged copy of ``solve_filter``) has none: no
  PyTorch call computes the clamped two-step solve.

Each is held to a float64 reference on the host, timed with CUDA events
as the mean of REPS calls after a warm-up, TF32 off. Prints the card's
name and power limit last.
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


def cuda_ms(fn) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def cases(dev):
    """(name, the call, its float64 reference on the host) at each probe's
    shapes, from fixed seeds."""
    rng = np.random.default_rng(0)
    _, expand_idx, dtri = tri_geometry(D)
    m2 = torch.tensor(rng.standard_normal((P, dtri)), dtype=torch.float32)
    expand = torch.zeros(D * D, dtri)
    expand[torch.arange(D * D), torch.as_tensor(expand_idx).long()] = 1.0
    m2_d, expand_d = m2.to(dev), expand.to(dev)

    def transpose():
        lanes = expand_d @ m2_d.T
        return lanes, lanes.transpose(0, 1).contiguous()

    g = torch.tensor(rng.random((ROWS, C)), dtype=torch.float32)
    first = R0 - 48 * (SHIFTS // 2) + 3
    g_d = g.to(dev)

    def mosaic():
        return g_d.as_strided((SHIFTS, NPIX, C), (48 * C, C, 1),
                              first * C).sum(0)

    ri, ci = np.meshgrid(np.arange(TP), np.arange(TP), indexing="ij")
    band = (rng.random((Y, TP, TP)) < 0.5) & (np.abs(ri - ci) <= BAND)
    b = torch.tensor(band, dtype=torch.float32)
    s = torch.tensor(rng.random((Y, TP, CH)), dtype=torch.float32)
    b_d, s_d = b.to(dev), s.to(dev)
    lanes64 = m2.double()[:, torch.as_tensor(expand_idx).long()].T
    rows64 = sum(g.double()[first + 48 * k:first + 48 * k + NPIX]
                 for k in range(SHIFTS))
    return [
        ("probe_transpose", transpose, (lanes64, lanes64.T)),
        ("probe_mosaic", mosaic, (rows64,)),
        ("probe_banded_dot", lambda: (torch.bmm(b_d, s_d),),
         (torch.bmm(b.double(), s.double()),)),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    bound = bounds.probes()
    for name, fn, refs in cases(dev):
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        err = max(float((o.double().cpu() - r).abs().max())
                  for o, r in zip(out, refs))
        ms = cuda_ms(fn)
        print(f"{name}: library call {ms:.4f} ms, max abs err {err:.3e} "
              f"vs float64; bound {bound[name][0]:.4f} ms "
              f"({bound[name][1]}), {ms / bound[name][0]:.1f}x", flush=True)
    print(f"bisect_kernel: library call none (no PyTorch call computes the "
          f"clamped two-step solve); bound {bound['bisect_kernel'][0]:.4f} ms",
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
