"""The per-pixel two-step Bayesian solve in its three forms, each a kernel
wrapper with a plain twin.

Ports of ``bcd_tpu/ops/solve_filter_pallas.py``:

- ``solve_matrices_pm`` (K2 of the fused r = 1 engine): pixel-major moments
  in, filter (A2^T, b2) and gates out. Kernel
  ``bcd_tpu_torch/csrc/solve_matrices_pm.cu``.
- ``solve_filter_pm``: the candidate-stack form that the engine runs for
  patch radius r != 1. It takes the candidate patches and masks
  pixel-major, as the engine builds them (and reads the main-path rows in
  place), forms the masked moments itself and returns the filtered
  candidates. ``solve_filter`` is the same function in JAX's lane-major
  layout (pixels last), for the parity tests.
- ``solve_matrices``: the lane-form moment solve, (A2^T, b2) without gates;
  it transposes to pixel rows for the kernel.

``solve_filter_pm`` and ``solve_matrices`` share ``csrc/solve_filter.cu``,
built for d = 27 (r = 1) and d = 75 (r = 2); the kernels' headers give the
math, the design and what bounds them. ``solve_schedule_core`` is the plain
float32 model of every solve kernel's schedule (K2's too), the reference
they are held to on the card beside the float64 twins.

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
# a thread's column of W or Q (d + 1 floats) outgrows its registers
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


def reseat_order(dp: int) -> list[int]:
    """The Brent-Luk re-seating after a round of the Jacobi on dp (even)
    rows (solve_filter_pallas.py:173-187), as the old row each new row
    takes: [U0, D0, U1..U(h-2), D1..D(h-1), U(h-1)], where h = dp / 2, U_i
    is rotated row i and D_i row i + h."""
    half = dp // 2
    return ([0, half] + list(range(1, half - 1))
            + list(range(half + 1, dp)) + [half - 1])


def _chol_solve_fp32(s: torch.Tensor, rhs: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """X = (S + eps I)^-1 rhs in float32 as the kernels compute it: a
    Cholesky whose pivots take eps as they are reached and are floored at
    1e-30, each column scaled by r_j = 1 / L[j][j], the forward substitution
    taken with it, and the back substitution multiplying by r_i."""
    s, y = s.clone(), rhs.clone()
    d = s.shape[-1]
    low = torch.zeros_like(s)
    r = torch.empty(s.shape[:-1], dtype=s.dtype, device=s.device)
    for j in range(d):
        rj = 1.0 / torch.sqrt((s[:, j, j] + eps).clamp(min=1e-30))
        r[:, j] = rj
        col = s[:, j + 1 :, j] * rj[:, None]  # L[i][j] below the diagonal
        low[:, j + 1 :, j] = col
        y[:, j] = y[:, j] * rj[:, None]
        s[:, j + 1 :, j + 1 :] -= col[:, :, None] * col[:, None, :]
        y[:, j + 1 :] -= col[:, :, None] * y[:, j : j + 1]
    for i in reversed(range(d)):
        acc = y[:, i] - (low[:, i + 1 :, i, None] * y[:, i + 1 :]).sum(1)
        y[:, i] = acc * r[:, i, None]
    return y


def _jacobi_fp32(a: torch.Tensor, sweeps: int):
    """The kernels' Jacobi of the symmetric float32 (P, d, d) ``a``, the
    TPU kernel's own (``_jacobi_clamp_psd``): ``a`` zero-padded to an even
    dp, one-sided accumulation of Q (rows are eigenvector estimates) and
    W = Q A with row-only fast-Givens rotations of the pairs (i, i + dp/2),
    the Brent-Luk re-seating after each round, rows renormalized at each
    sweep's end. Returns the exact final eigenvalues <W[k], Q[k]> (P, dp)
    and Q (P, dp, dp)."""
    f32 = torch.float32
    p_total, d = a.shape[0], a.shape[-1]
    dp = d + d % 2
    half = dp // 2
    w = torch.nn.functional.pad(a, (0, dp - d, 0, dp - d))
    q = torch.eye(dp, dtype=f32, device=a.device).repeat(p_total, 1, 1)
    dall = torch.diagonal(w, dim1=1, dim2=2).clone()
    order = torch.as_tensor(reseat_order(dp), device=a.device)
    for _ in range(sweeps):
        f = torch.ones((p_total, dp), dtype=f32, device=a.device)
        for _ in range(dp - 1):
            fp, fq = f[:, :half], f[:, half:]
            apq = (w[:, :half] * q[:, half:]).sum(-1) * (fp * fq)
            app, aqq = dall[:, :half], dall[:, half:]
            small = apq.abs() < 1e-30
            tau = (aqq - app) / torch.where(small, 1.0, 2.0 * apq)
            t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(small, 0.0, torch.where(tau == 0.0, 1.0, t))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            inv_cf = 1.0 / (c * fp * fq)
            an = torch.where(small, 0.0, -s * fq * fq * inv_cf)[..., None]
            bn = torch.where(small, 0.0, s * fp * fp * inv_cf)[..., None]
            w = torch.cat([w[:, :half] + an * w[:, half:],
                           bn * w[:, :half] + w[:, half:]], 1)[:, order]
            q = torch.cat([q[:, :half] + an * q[:, half:],
                           bn * q[:, :half] + q[:, half:]], 1)[:, order]
            dall = torch.cat([app - t * apq, aqq + t * apq], 1)[:, order]
            f = torch.cat([c * fp, c * fq], 1)[:, order]
        w = w * f[..., None]
        q = q * f[..., None]
    return (w * q).sum(-1), q


def solve_schedule_core(cemp, bd, m, min_eigen: float, sweeps: int,
                        jax_clamp: bool = False):
    """The kernels' two-step solve in plain float32, batched over pixels:
    the model that every solve kernel (K2, solve_filter, the lane
    solve_matrices) is held to on the card. (P, d, d) Cemp and BD, (P, d) m
    -> (X2 = T2^T (P, d, d), b2 = X2^T m (P, d)); A2^T = I - X2.

    ``_jacobi_fp32``, then the kernels' clamp (Cemp plus the negative
    eigen-directions) and their two Cholesky solves. ``jax_clamp`` takes
    the TPU kernel's clamp instead, Q^T max(lam, 0) Q + BD, which keeps the
    unconverged off-diagonal residue: the tests hold the model to JAX's
    kernel with it."""
    d = cemp.shape[-1]
    eye = torch.eye(d, dtype=torch.float32, device=cemp.device)
    lam, q = _jacobi_fp32(cemp - bd, sweeps)
    qd = q[:, :, :d]
    if jax_clamp:
        s1 = torch.einsum("pk,pki,pkj->pij", lam.clamp(min=0.0), qd, qd) + bd
    else:
        s1 = cemp + torch.einsum("pk,pki,pkj->pij", (-lam).clamp(min=0.0),
                                 qd, qd)
    a1t = eye - _chol_solve_fp32(s1, bd, min_eigen)
    cov2 = a1t.mT @ (cemp @ a1t)
    x2 = _chol_solve_fp32(cov2 + bd, bd, min_eigen)
    return x2, torch.einsum("pkj,pk->pj", x2, m)


def solve_matrices_pm_schedule(m2: torch.Tensor, misc: torch.Tensor,
                               min_eigen: float, sweeps: int,
                               jax_clamp: bool = False):
    """K2's schedule (``solve_schedule_core``) from K1's moments; returns
    float32 (a2t, small) in K2's layouts."""
    from bcd_tpu_torch.ops.fused import tri_geometry

    f32 = torch.float32
    p_total = m2.shape[0]
    _, expand, _ = tri_geometry(D)
    idx = torch.as_tensor(expand, device=m2.device, dtype=torch.long)
    m2f = m2.to(f32)[:, idx].reshape(p_total, D, D)
    misc = misc.to(f32)
    n = misc[:, D + 6 * NPX]
    cv = misc[:, D + 6 * NPX + 1]
    nsafe = n.clamp(min=1.0)
    m = misc[:, 0:D] / nsafe[:, None]
    bd = _noise_bd(misc[:, D : D + 6 * NPX] / nsafe[:, None], NPX)
    x2, b2 = solve_schedule_core(_cemp(m2f, m, n), bd, m, min_eigen, sweeps,
                                 jax_clamp)
    eye = torch.eye(D, dtype=f32, device=m2.device)
    gate = ((n >= D + 1) & (cv > 0.0)).to(f32)
    fb = cv * (1.0 - gate)
    a2t = (eye - x2).reshape(p_total, D * D)
    small = torch.cat([b2, gate[:, None], fb[:, None] * m, fb[:, None]], 1)
    return a2t.contiguous(), small.contiguous()


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
    if p_total == 0:  # nothing to solve: no launch
        return a2t, small
    rc = _build.library().bcd_solve_matrices_pm(
        _build.ptr(m2), _build.ptr(misc), float(min_eigen), p_total,
        int(sweeps), _build.ptr(a2t), _build.ptr(small), _build.stream_of(m2))
    _build.LAUNCHES["solve_matrices_pm"] += 1
    _build.check(rc, "solve_matrices_pm")
    return a2t, small


# ---------------------------------------------------------------------------
# solve_filter, candidate-stack form (the r != 1 engine)
# ---------------------------------------------------------------------------


def solve_filter_pm_plain(cand, mask, noise, n, m, min_eigen: float,
                          npx: int, rows=None):
    """Plain twin of ``solve_filter_pm`` (``solve_filter_reference`` with its
    exact floor), in float64; returns float32 field (P, O, d)."""
    f64 = torch.float64
    if rows is not None:
        field = torch.zeros(cand.shape, dtype=torch.float32,
                            device=cand.device)
        if rows.numel() == 0:
            return field
        field[rows] = solve_filter_pm_plain(cand[rows], mask[rows],
                                            noise[rows], n[rows], m[rows],
                                            min_eigen, npx)
        return field
    C = cand.to(f64)
    mk = mask.to(f64)[..., None]  # (P, O, 1)
    n, m = n.to(f64), m.to(f64)
    m2 = torch.einsum("pok,pol->pkl", mk * C, C)
    a2, b2 = _solve_core_plain(_cemp(m2, m, n), _noise_bd(noise.to(f64), npx),
                               m, min_eigen)
    field = mk * (torch.einsum("pkl,pol->pok", a2, C) + b2[:, None, :])
    return field.float().contiguous()


def solve_filter_plain(C_t, mask_t, noise_t, n_t, m_t, min_eigen: float,
                       npx: int):
    """Plain twin of ``solve_filter`` in JAX's lane layout; returns float32
    field_t (O, d, P)."""
    return solve_filter_pm_plain(
        C_t.permute(2, 0, 1), mask_t.T, noise_t.T, n_t[0], m_t.T, min_eigen,
        npx).permute(1, 2, 0).contiguous()


def solve_filter_pm(cand, mask, noise, n, m, min_eigen: float, npx: int,
                    sweeps: int, rows=None):
    """Per-pixel solve and filter of every candidate, pixel-major: the
    engine's entry (the candidate stacks as ``core.monoscale.
    candidate_stacks`` builds them, read in place).

    cand (P, O, d) candidate patches, mask (P, O) similar-set masks, noise
    (P, 6 npx) mean noise channels (xx, yy, zz, yz, xz, xy per patch pixel),
    n (P,) set sizes, m (P, d) masked mean patches. Returns field (P, O, d)
    = mask * (A2 c + b2). With ``rows`` (int64 pixel indices), only those
    pixels are solved and the other rows of field are 0. ``sweeps`` is the
    kernel's number of Jacobi sweeps; the twin's exact eigh has none.
    """
    if cand.dim() != 3:
        raise ValueError(f"cand must be (P, O, d), got {tuple(cand.shape)}")
    p_total, n_off, d = cand.shape
    if d != 3 * npx:
        raise ValueError(f"d = {d} is not 3 * npx = {3 * npx}")
    names = ("cand", "mask", "noise", "n", "m")
    tensors = (cand, mask, noise, n, m)
    for name, t, shape in zip(names, tensors, (
            (p_total, n_off, d), (p_total, n_off), (p_total, 6 * npx),
            (p_total,), (p_total, d))):
        if t.shape != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    _check_kernel_inputs(names, tensors)
    if cand.device.type == "cpu":
        return solve_filter_pm_plain(cand, mask, noise, n, m, min_eigen, npx,
                                     rows)
    check_kernel_dim(d)
    if rows is None:
        field = torch.empty((p_total, n_off, d), device=cand.device)
        n_rows, rows_i32 = p_total, None
    else:
        field = torch.zeros((p_total, n_off, d), device=cand.device)
        rows_i32 = rows.to(device=cand.device, dtype=torch.int32).contiguous()
        n_rows = rows_i32.numel()
    if n_rows == 0:  # nothing to solve: no launch
        return field
    p = _build.ptr
    rc = _build.library().bcd_solve_filter(
        *map(p, tensors), None if rows_i32 is None else p(rows_i32),
        float(min_eigen), n_rows, n_off, d, int(sweeps), p(field),
        _build.stream_of(cand))
    _build.LAUNCHES["solve_filter"] += 1
    _build.check(rc, "solve_filter")
    return field


def solve_filter_pm_schedule(cand, mask, noise, n, m, min_eigen: float,
                             npx: int, sweeps: int):
    """``solve_filter_pm``'s kernel schedule in plain float32: the masked
    moments, ``solve_schedule_core`` and the filter
    field_o = mask_o (c_o - X2^T c_o + b2). The model the kernel is held to
    on the card; returns float32 field (P, O, d)."""
    f32 = torch.float32
    C, mk = cand.to(f32), mask.to(f32)[..., None]
    n, m = n.to(f32), m.to(f32)
    m2 = torch.einsum("poi,poj->pij", mk * C, C)
    x2, b2 = solve_schedule_core(_cemp(m2, m, n), _noise_bd(noise.to(f32), npx),
                                 m, min_eigen, sweeps)
    return (mk * (C - C @ x2 + b2[:, None, :])).contiguous()


def solve_filter(C_t, mask_t, noise_t, n_t, m_t, min_eigen: float, npx: int,
                 sweeps: int):
    """``solve_filter_pm`` in JAX's signature and lane layout
    (``solve_filter_pallas.py:441-451``), for the parity tests: C_t (O, d,
    P), mask_t (O, P), noise_t (6 npx, P), n_t (1, P), m_t (d, P) -> field_t
    (O, d, P)."""
    if C_t.dim() != 3:
        raise ValueError(f"C_t must be (O, d, P), got {tuple(C_t.shape)}")
    n_off, d, p_total = C_t.shape
    if d != 3 * npx:
        raise ValueError(f"d = {d} is not 3 * npx = {3 * npx}")
    for name, t, shape in zip(("mask_t", "noise_t", "n_t", "m_t"),
                              (mask_t, noise_t, n_t, m_t),
                              ((n_off, p_total), (6 * npx, p_total),
                               (1, p_total), (d, p_total))):
        if t.shape != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    field = solve_filter_pm(
        C_t.permute(2, 0, 1).contiguous(), mask_t.T.contiguous(),
        noise_t.T.contiguous(), n_t[0].contiguous(), m_t.T.contiguous(),
        min_eigen, npx, sweeps)
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
    if p_total > 0:  # else nothing to solve: no launch
        p = _build.ptr
        rc = _build.library().bcd_solve_matrices(
            *map(p, rows), float(min_eigen), p_total, d, int(sweeps), p(a2t),
            p(b2), _build.stream_of(m2_t))
        _build.LAUNCHES["solve_matrices"] += 1
        _build.check(rc, "solve_matrices")
    return a2t.permute(1, 2, 0).contiguous(), b2.T[None].contiguous()


def solve_matrices_schedule(m2_t, msum_t, nov_t, n_t, min_eigen: float,
                            npx: int, sweeps: int):
    """The lane ``solve_matrices``' kernel schedule in plain float32
    (``solve_schedule_core``); returns (a2t (d, d, P), b2 (1, d, P))."""
    f32 = torch.float32
    d = m2_t.shape[0]
    n = n_t.to(f32)[0]
    nsafe = n.clamp(min=1.0)[:, None]
    m = msum_t.to(f32).T / nsafe
    x2, b2 = solve_schedule_core(
        _cemp(m2_t.to(f32).permute(2, 0, 1), m, n),
        _noise_bd(nov_t.to(f32).T / nsafe, npx), m, min_eigen, sweeps)
    a2t = torch.eye(d, dtype=f32, device=m2_t.device) - x2  # a2t[p, k, j]
    return a2t.permute(1, 2, 0).contiguous(), b2.T[None].contiguous()
