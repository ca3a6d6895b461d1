"""The per-pixel two-step Bayesian solve in its three forms, each a kernel
wrapper with a plain twin.

Ports of ``bcd_tpu/ops/solve_filter_pallas.py``:

- ``solve_matrices_pm`` (K2 of the fused r = 1 engine): pixel-major moments
  in, filter (A2^T, b2) and gates out. Kernel
  ``bcd_tpu_torch/csrc/solve_matrices_pm.cu``.
- ``solve_filter``: the candidate-stack form that the engine runs for patch
  radius r != 1. It takes the gathered candidate patches and masks, forms
  the masked moments itself and returns the filtered candidates.
- ``solve_matrices``: the lane-form moment solve, (A2^T, b2) without gates.

``solve_filter`` and ``solve_matrices`` share ``csrc/solve_filter.cu``,
built for d = 27 (r = 1) and d = 75 (r = 2); the kernels' headers give the
math, the design and what bounds them. Both keep JAX's lane-major layout
(pixels last) at the function boundary and transpose to pixel rows for the
kernel.

K2's channel maps, pixel-major rows (P pixels):

- ``m2``    (P, 378): raw masked second moments, upper triangle packed row
  by row (``ops.fused.tri_geometry``);
- ``misc``  (P, 83):  [0:27] masked color-patch sums, [27:81] masked patch
  pixel-covariance sums, [81] similar-set size n, [82] center_valid;
- ``a2t``   (P, 729): A2 transposed, k-major: ``a2t[p, k*27 + j] = A2[p][j, k]``;
- ``small`` (P, 56):  [0:27] b2, [27] main-path gate, [28:55] fb * mean
  patch, [55] fb (the fallback flag).

A CPU tensor goes to the plain twin, a CUDA tensor to the kernel. The twins
compute in float64 with an eigh clamp and the exact eigenvalue floor (a
float32 eigh carries about 5e-4 error, enough to hide a real fault in a
kernel) and return float32.
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
# patch dimensions csrc/solve_filter.cu is built for (r = 1, 2); at r >= 3
# three (d + 1) x (d + 2) fp32 matrices outgrow a block's shared memory
KERNEL_DIMS = (27, 75)
ROADMAP_LARGE_D = ("ROADMAP.md Queue 2, solve_filter for patch radius >= 3")


def _sym_apply(mats: torch.Tensor, fn) -> torch.Tensor:
    """V diag(fn(lambda)) V^T for a batch of symmetric matrices, in chunks
    of ``EIGH_CHUNK``."""
    out = []
    for part in mats.split(EIGH_CHUNK):
        lam, vec = torch.linalg.eigh(part)
        out.append((vec * fn(lam)[..., None, :]) @ vec.mT)
    return torch.cat(out)


def _solve_core_plain(cemp, bd, m, min_eigen: float):
    """(A2, b2) from float64 Cemp (P, d, d), BD (P, d, d) and m (P, d):
    the two steps of ``solve_filter_pallas._solve_core_reference``."""
    eye = torch.eye(cemp.shape[-1], dtype=cemp.dtype, device=cemp.device)

    def inv(mat):
        return _sym_apply(mat, lambda lam: 1.0 / lam.clamp(min=min_eigen))

    clamped = _sym_apply(cemp - bd, lambda lam: lam.clamp(min=0.0))
    a1 = eye - bd @ inv(clamped + bd)
    cov2 = a1 @ cemp @ a1.mT
    t2 = bd @ inv(cov2 + bd)
    return eye - t2, (t2 @ m[..., None])[..., 0]


def _cemp(m2, m, n):
    """(M2 - n m m^T) / max(n - 1, 1) for (P, d, d) M2, (P, d) m, (P,) n."""
    nm1 = (n - 1.0).clamp(min=1.0)[:, None, None]
    return (m2 - n[:, None, None] * m[:, :, None] * m[:, None, :]) / nm1


def _noise_bd(noise, npx: int):
    """Dense (P, d, d) block-diagonal noise from (P, 6 npx) channels."""
    return blockdiag_expand(cov6_to_mat3(noise.reshape(-1, npx, 6)))


def _check_kernel_inputs(names, tensors) -> None:
    dev = tensors[0].device
    for name, t in zip(names, tensors):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in zip(names, tensors):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")


def check_kernel_dim(d: int) -> None:
    """Raise NotImplementedError for a patch dimension the CUDA kernel has
    no instantiation for."""
    if d not in KERNEL_DIMS:
        raise NotImplementedError(
            f"patch dimension d = {d}: the CUDA kernel is built for d in "
            f"{KERNEL_DIMS} (patch radius 1, 2); see {ROADMAP_LARGE_D}")


# ---------------------------------------------------------------------------
# K2, pixel-major moments (the fused r = 1 engine)
# ---------------------------------------------------------------------------


def solve_matrices_pm_plain(m2: torch.Tensor, misc: torch.Tensor,
                            min_eigen: float):
    """Plain twin of K2 (``solve_matrices_pm_reference``); returns float32
    (a2t, small)."""
    from bcd_tpu_torch.ops.fused import tri_geometry

    f64 = torch.float64
    p_total = m2.shape[0]
    _, expand, _ = tri_geometry(D)
    idx = torch.as_tensor(expand, device=m2.device, dtype=torch.long)
    m2f = m2.to(f64)[:, idx].reshape(p_total, D, D)
    misc = misc.to(f64)
    n = misc[:, D + 6 * NPX]
    cv = misc[:, D + 6 * NPX + 1]
    nsafe = n.clamp(min=1.0)
    m = misc[:, 0:D] / nsafe[:, None]
    bd = _noise_bd(misc[:, D : D + 6 * NPX] / nsafe[:, None], NPX)
    a2, b2 = _solve_core_plain(_cemp(m2f, m, n), bd, m, min_eigen)

    gate = ((n >= D + 1) & (cv > 0.0)).to(f64)
    fb = cv * (1.0 - gate)
    a2t = a2.mT.reshape(p_total, D * D)
    small = torch.cat([b2, gate[:, None], fb[:, None] * m, fb[:, None]], 1)
    return a2t.float().contiguous(), small.float().contiguous()


def solve_matrices_pm(m2: torch.Tensor, misc: torch.Tensor, min_eigen: float,
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
    _check_kernel_inputs(("m2", "misc"), (m2, misc))
    if m2.device.type == "cpu":
        return solve_matrices_pm_plain(m2, misc, min_eigen)
    p_total = m2.shape[0]
    a2t = torch.empty((p_total, D * D), device=m2.device)
    small = torch.empty((p_total, SMALL_CH), device=m2.device)
    rc = _build.library().bcd_solve_matrices_pm(
        _build.ptr(m2), _build.ptr(misc), float(min_eigen), p_total,
        int(sweeps), _build.ptr(a2t), _build.ptr(small), _build.stream_of(m2))
    _build.LAUNCHES["solve_matrices_pm"] += 1
    _build.check(rc, "solve_matrices_pm")
    return a2t, small


# ---------------------------------------------------------------------------
# solve_filter, candidate-stack form (the r != 1 engine)
# ---------------------------------------------------------------------------


def solve_filter_plain(C_t, mask_t, noise_t, n_t, m_t, min_eigen: float,
                       npx: int):
    """Plain twin of ``solve_filter`` (``solve_filter_reference`` with its
    exact floor), in float64; returns float32 field_t (O, d, P)."""
    f64 = torch.float64
    C = C_t.to(f64).permute(2, 0, 1)  # (P, O, d)
    mk = mask_t.to(f64).T[..., None]  # (P, O, 1)
    n = n_t.to(f64)[0]
    m = m_t.to(f64).T
    m2 = torch.einsum("pok,pol->pkl", mk * C, C)
    a2, b2 = _solve_core_plain(_cemp(m2, m, n),
                               _noise_bd(noise_t.to(f64).T, npx), m,
                               min_eigen)
    field = mk * (torch.einsum("pkl,pol->pok", a2, C) + b2[:, None, :])
    return field.permute(1, 2, 0).float().contiguous()


def solve_filter(C_t, mask_t, noise_t, n_t, m_t, min_eigen: float, npx: int,
                 sweeps: int):
    """Per-pixel solve and filter of every candidate (JAX's signature and
    layout, ``solve_filter_pallas.py:441-451``).

    C_t (O, d, P) candidate patches, mask_t (O, P) similar-set masks,
    noise_t (6 npx, P) mean noise channels (xx, yy, zz, yz, xz, xy per patch
    pixel), n_t (1, P) set sizes, m_t (d, P) masked mean patches. Returns
    field_t (O, d, P) = mask * (A2 c + b2). ``sweeps`` is the kernel's
    number of Jacobi sweeps; the twin's exact eigh has none.
    """
    if C_t.dim() != 3:
        raise ValueError(f"C_t must be (O, d, P), got {tuple(C_t.shape)}")
    n_off, d, p_total = C_t.shape
    if d != 3 * npx:
        raise ValueError(f"d = {d} is not 3 * npx = {3 * npx}")
    names = ("C_t", "mask_t", "noise_t", "n_t", "m_t")
    tensors = (C_t, mask_t, noise_t, n_t, m_t)
    for name, t, shape in zip(names, tensors, (
            (n_off, d, p_total), (n_off, p_total), (6 * npx, p_total),
            (1, p_total), (d, p_total))):
        if t.shape != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    _check_kernel_inputs(names, tensors)
    if C_t.device.type == "cpu":
        return solve_filter_plain(C_t, mask_t, noise_t, n_t, m_t, min_eigen,
                                  npx)
    check_kernel_dim(d)
    # pixel rows for the kernel: one block reads one pixel's candidates
    cand = C_t.permute(2, 0, 1).contiguous()
    rows = [mask_t.T.contiguous(), noise_t.T.contiguous(), n_t,
            m_t.T.contiguous()]
    field = torch.empty((p_total, n_off, d), device=C_t.device)
    p = _build.ptr
    rc = _build.library().bcd_solve_filter(
        p(cand), *map(p, rows), float(min_eigen), p_total, n_off, d,
        int(sweeps), p(field), _build.stream_of(C_t))
    _build.LAUNCHES["solve_filter"] += 1
    _build.check(rc, "solve_filter")
    return field.permute(1, 2, 0).contiguous()


# ---------------------------------------------------------------------------
# solve_matrices, lane-form moments
# ---------------------------------------------------------------------------


def solve_matrices_plain(m2_t, msum_t, nov_t, n_t, min_eigen: float,
                         npx: int):
    """Plain twin of the lane ``solve_matrices``
    (``solve_matrices_reference``), in float64; returns float32
    (a2t (d, d, P), b2 (1, d, P))."""
    f64 = torch.float64
    n = n_t.to(f64)[0]
    nsafe = n.clamp(min=1.0)[:, None]
    m = msum_t.to(f64).T / nsafe
    a2, b2 = _solve_core_plain(
        _cemp(m2_t.to(f64).permute(2, 0, 1), m, n),
        _noise_bd(nov_t.to(f64).T / nsafe, npx), m, min_eigen)
    a2t = a2.permute(2, 1, 0)  # a2t[k, j, p] = A2[p][j, k]
    return a2t.float().contiguous(), b2.T[None].float().contiguous()


def solve_matrices(m2_t, msum_t, nov_t, n_t, min_eigen: float, npx: int,
                   sweeps: int):
    """Lane-form moment solve (``solve_filter_pallas.py:594-607``): m2_t
    (d, d, P) raw masked second moments, msum_t (d, P) masked patch sums,
    nov_t (6 npx, P) masked noise sums, n_t (1, P) set sizes. Returns
    (a2t (d, d, P) with a2t[k, j, p] = A2[p][j, k], b2 (1, d, P))."""
    if m2_t.dim() != 3:
        raise ValueError(f"m2_t must be (d, d, P), got {tuple(m2_t.shape)}")
    d, _, p_total = m2_t.shape
    if d != 3 * npx:
        raise ValueError(f"d = {d} is not 3 * npx = {3 * npx}")
    names = ("m2_t", "msum_t", "nov_t", "n_t")
    tensors = (m2_t, msum_t, nov_t, n_t)
    for name, t, shape in zip(names, tensors, (
            (d, d, p_total), (d, p_total), (6 * npx, p_total),
            (1, p_total))):
        if t.shape != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    _check_kernel_inputs(names, tensors)
    if m2_t.device.type == "cpu":
        return solve_matrices_plain(m2_t, msum_t, nov_t, n_t, min_eigen, npx)
    check_kernel_dim(d)
    dev = m2_t.device
    # pixel rows for the kernel, held here until the launch is queued
    rows = [m2_t.permute(2, 0, 1).contiguous(), msum_t.T.contiguous(),
            nov_t.T.contiguous(), n_t]
    a2t = torch.empty((p_total, d, d), device=dev)
    b2 = torch.empty((p_total, d), device=dev)
    p = _build.ptr
    rc = _build.library().bcd_solve_matrices(
        *map(p, rows), float(min_eigen), p_total, d, int(sweeps), p(a2t),
        p(b2), _build.stream_of(m2_t))
    _build.LAUNCHES["solve_matrices"] += 1
    _build.check(rc, "solve_matrices")
    return a2t.permute(1, 2, 0).contiguous(), b2.T[None].contiguous()
