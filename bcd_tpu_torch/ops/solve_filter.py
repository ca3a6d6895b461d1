"""K2, the per-pixel two-step Bayesian solve, and its plain twin.

Port of ``bcd_tpu/ops/solve_filter_pallas.py::solve_matrices_pm``. The
kernel is ``bcd_tpu_torch/csrc/solve_matrices.cu``; see its header for the
math, the design and what bounds it.

Channel maps, pixel-major rows (P pixels):

- ``m2``    (P, 378): raw masked second moments, upper triangle packed row
  by row (``ops.fused.tri_geometry``);
- ``misc``  (P, 83):  [0:27] masked color-patch sums, [27:81] masked patch
  pixel-covariance sums, [81] similar-set size n, [82] center_valid;
- ``a2t``   (P, 729): A2 transposed, k-major: ``a2t[p, k*27 + j] = A2[p][j, k]``;
- ``small`` (P, 56):  [0:27] b2, [27] main-path gate, [28:55] fb * mean
  patch, [55] fb (the fallback flag).

A CPU tensor goes to the plain twin, a CUDA tensor to the kernel.
"""

from __future__ import annotations

import torch

from bcd_tpu_torch.ops import _build
from bcd_tpu_torch.ops.cov3x3 import blockdiag_expand, cov6_to_mat3

D = 27
NPX = 9
DTRI = D * (D + 1) // 2
MISC_CH = D + 6 * NPX + 2
SMALL_CH = 2 * D + 2
EIGH_CHUNK = 16384  # cuSOLVER's batched eigh refuses very large batches


def _sym_apply(mats: torch.Tensor, fn) -> torch.Tensor:
    """V diag(fn(lambda)) V^T for a batch of symmetric matrices, in chunks
    of ``EIGH_CHUNK``."""
    out = []
    for part in mats.split(EIGH_CHUNK):
        lam, vec = torch.linalg.eigh(part)
        out.append((vec * fn(lam)[..., None, :]) @ vec.mT)
    return torch.cat(out)


def solve_matrices_plain(m2: torch.Tensor, misc: torch.Tensor,
                         min_eigen: float):
    """Plain twin of K2: an eigh clamp and an exact eigenvalue floor, in
    float64 (a float32 eigh carries about 5e-4 error, enough to hide a real
    fault in the kernel); returns float32 (a2t, small)."""
    from bcd_tpu_torch.ops.fused import tri_geometry

    f64 = torch.float64
    p_total = m2.shape[0]
    _, expand, _ = tri_geometry(D)
    idx = torch.as_tensor(expand, device=m2.device, dtype=torch.long)
    m2f = m2.to(f64)[:, idx].reshape(p_total, D, D)
    misc = misc.to(f64)
    msum = misc[:, 0:D]
    nov = misc[:, D : D + 6 * NPX]
    n = misc[:, D + 6 * NPX]
    cv = misc[:, D + 6 * NPX + 1]
    nsafe = n.clamp(min=1.0)
    m = msum / nsafe[:, None]
    bd = blockdiag_expand(cov6_to_mat3(
        nov.reshape(p_total, NPX, 6) / nsafe[:, None, None]))
    nm1 = (n - 1.0).clamp(min=1.0)[:, None, None]
    cemp = (m2f - n[:, None, None] * m[:, :, None] * m[:, None, :]) / nm1

    clamped = _sym_apply(cemp - bd, lambda lam: lam.clamp(min=0.0))
    def inv(mat):
        return _sym_apply(mat, lambda lam: 1.0 / lam.clamp(min=min_eigen))
    eye = torch.eye(D, dtype=f64, device=m2.device)
    inv1 = inv(clamped + bd)
    a1 = eye - bd @ inv1
    cov2 = a1 @ cemp @ a1.mT
    t2 = bd @ inv(cov2 + bd)
    a2 = eye - t2
    b2 = (t2 @ m[..., None])[..., 0]

    gate = ((n >= D + 1) & (cv > 0.0)).to(f64)
    fb = cv * (1.0 - gate)
    a2t = a2.mT.reshape(p_total, D * D)
    small = torch.cat([b2, gate[:, None], fb[:, None] * m, fb[:, None]], 1)
    return a2t.float().contiguous(), small.float().contiguous()


def solve_matrices(m2: torch.Tensor, misc: torch.Tensor, min_eigen: float,
                   sweeps: int):
    """K2: per-pixel filter (A2^T, b2) and gates from K1's moments.

    ``sweeps`` is the number of Jacobi sweeps of the kernel's eigenvalue
    clamp; the engine passes ``MonoscaleConfig.solve_sweeps``. The twin's
    exact eigh has no sweep count.
    """
    if m2.dim() != 2 or m2.shape[1] != DTRI:
        raise ValueError(f"m2 must be (P, {DTRI}), got {tuple(m2.shape)}")
    if misc.shape != (m2.shape[0], MISC_CH):
        raise ValueError(f"misc must be (P, {MISC_CH}), got {tuple(misc.shape)}")
    if m2.device != misc.device:
        raise ValueError("m2 and misc must be on one device")
    if m2.device.type == "cpu":
        return solve_matrices_plain(m2, misc, min_eigen)
    if m2.device.type != "cuda":
        raise ValueError(f"unsupported device {m2.device}")
    for name, t in (("m2", m2), ("misc", misc)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    p_total = m2.shape[0]
    a2t = torch.empty((p_total, D * D), device=m2.device)
    small = torch.empty((p_total, SMALL_CH), device=m2.device)
    rc = _build.library().bcd_solve_matrices(
        _build.ptr(m2), _build.ptr(misc), float(min_eigen), p_total,
        int(sweeps), _build.ptr(a2t), _build.ptr(small), _build.stream_of(m2))
    _build.LAUNCHES["solve_matrices"] += 1
    _build.check(rc, "solve_matrices")
    return a2t, small
