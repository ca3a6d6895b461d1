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
built for d = 27 (r = 1) and d = 75 (r = 2), which keeps a column of the
Jacobi's matrices in a thread's registers. At d = 147 (r = 3) a column
outgrows the registers: ``solve_filter_pm`` runs ``csrc/solve_filter_smem.cu``
there, the same function with the two matrices in shared memory, and at
d = 243 (r = 4), 363 (r = 5), 507 (r = 6), 675 (r = 7), 867 (r = 8),
1083 (r = 9), 1323 (r = 10), 1587 (r = 11) and 1875 (r = 12) the same
kernel with the rows that do not fit there in a global slot of the block
(at d = 363 most of them: 580 of 728; at d = 507, 913 of 1,016, the slot
3.92 MB a block with Cemp and H; at d = 675, 1,280 of 1,352, 7.12 MB; at
d = 867, 1,683 of 1,736, 11.9 MB; at d = 1083, 2,128 of 2,168, 18.6 MB; at
d = 1323, 2,618 of 2,648, 27.9 MB; at d = 1587, 3,153 of 3,176, 40.2 MB; at
d = 1875, 3,735 of 3,752, 56.2 MB), one compiled instance a d. From
d = 2187 (r = 13) on, every patch dimension runs ``csrc/solve_filter_big.cu``,
the same algorithm with d a runtime argument (at d = 2187, 4,363 of 4,376
rows in the global slot, 76.5 MB a block); a d is refused only where one
block's slot and one band of the stack pass the card's memory
(``check_solve_path``). The lane ``solve_matrices`` runs
``csrc/solve_filter.cu`` at d = 27 and 75 and the runtime-d kernel, fed by
the moments, at every other patch dimension. The kernels' headers give the math, the design and what bounds them.
``solve_schedule_core`` is the plain float32 model of every solve
kernel's schedule (K2's too), the reference they are held to on the card
beside the float64 twins.

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
# patch dimensions solve_filter_pm has a compiled kernel for:
# csrc/solve_filter.cu (r = 1, 2; a thread's column of W or Q, d + 1
# floats, in registers) and csrc/solve_filter_smem.cu (r = 3; W and Q,
# 2 (d + 1)^2 floats, in shared memory, 175 KB of a block's 227 KB; r = 4:
# 476 KB, 227 of the 488 rows in shared memory, the others in a global slot
# of the block; r = 5: 1.06 MB, 148 of the 728 rows in shared memory; r = 6:
# 2.06 MB, 103 of 1,016; r = 7: 3.66 MB, 72 of 1,352; r = 8: 6.03 MB, 53 of
# 1,736; r = 9: 9.40 MB, 40 of 2,168, nine pivot passes a round; r = 10:
# 14.0 MB, 30 of 2,648, eleven pivot passes; r = 11: 20.2 MB, 23 of 3,176,
# thirteen pivot passes; r = 12: 28.2 MB, 17 of 3,752, fifteen pivot
# passes, the most a round of that kernel may have)
KERNEL_DIMS = (27, 75, 147, 243, 363, 507, 675, 867, 1083, 1323, 1587,
               1875)
# the d that csrc/solve_filter_smem.cu runs, with each one's launch counter
SMEM_DIMS = {147: "solve_filter_smem", 243: "solve_filter_243",
             363: "solve_filter_363", 507: "solve_filter_507",
             675: "solve_filter_675", 867: "solve_filter_867",
             1083: "solve_filter_1083", 1323: "solve_filter_1323",
             1587: "solve_filter_1587", 1875: "solve_filter_1875"}
# from this d (patch radius 13) solve_filter_pm runs csrc/solve_filter_big.cu,
# d a runtime argument, at every patch dimension
BIG_FROM_D = 2187
# the d csrc/solve_filter.cu is built for (a thread's column of W or Q in
# registers); the lane solve_matrices runs csrc/solve_filter_big.cu at every
# other d
REGISTER_DIMS = (27, 75)
SMEM_BYTES = 232448  # shared memory an H100 block may have
# the card's memory where no card is present (the CPU tests): an H100's
CARD_BYTES = 80 * 10 ** 9


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


def big_layout(d: int):
    """``csrc/solve_filter_big.cu``'s layout at patch dimension d (its
    ``make_layout``), or None for a d it cannot lay out (not a multiple of
    3, or d + d % 2 not of 4: no patch dimension 3 (2r + 1)^2): shared
    bytes a block, rows of W and Q in shared memory and in the global slot,
    vectors in shared memory (of 9: m, noise, diag, f, neg, 1 / L, the seat
    maps, the pair records, the staged pivot rows, in that order; the rest
    in the slot) and their floats in the slot, and the slot's floats a
    block (Cemp, H, the global rows and vectors). The kernel itself lays
    out d up to 131,067 (its unsigned unit counts), where one block's slot
    takes 275 GB, more than a card holds."""
    dp = d + d % 2
    if d < 3 or d % 3 or dp % 4:
        return None
    floats = SMEM_BYTES // 4
    sizes = [dp, (6 * (d // 3) + 3) // 4 * 4, dp, dp, dp, dp, 2 * dp,
             2 * dp, 2 * dp]
    shared = k = 0
    while k < len(sizes) and shared + sizes[k] <= floats:
        shared += sizes[k]
        k += 1
    rs = min((floats - shared) // dp, 2 * dp)
    gvec = sum(sizes[k:])
    return {"smem_bytes": 4 * (rs * dp + shared), "shared_rows": rs,
            "global_rows": 2 * dp - rs, "shared_vectors": k,
            "global_vector_floats": gvec,
            "slot_floats": 2 * dp * dp + (2 * dp - rs) * dp + gvec}


def card_bytes() -> int:
    """The card's memory, or an H100's (``CARD_BYTES``) on a host with
    none."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return CARD_BYTES


def check_kernel_dim(d: int, n_off: int = 0, centers: int = 0) -> None:
    """Raise NotImplementedError for a patch dimension ``solve_filter_pm``
    cannot run on the card. Below ``BIG_FROM_D`` the compiled kernels take
    the d in ``KERNEL_DIMS`` (patch radius 1 to 12); from it the runtime-d
    kernel takes every patch dimension, unless one block's global slot
    and the candidate stack of ``centers`` centers of ``n_off`` offsets
    (the engine's least band: one row of a tile's centers) pass the card's
    memory (``card_bytes()``): then the message names the bytes."""
    if d in KERNEL_DIMS:
        return
    lay = big_layout(d) if d >= BIG_FROM_D else None
    if lay is None:
        raise NotImplementedError(
            f"d = {d} is not a patch dimension 3 (2r + 1)^2: the CUDA solve "
            f"kernels run d in {KERNEL_DIMS} and every patch dimension from "
            f"{BIG_FROM_D} (patch radius 13) on")
    slot, band = 4 * lay["slot_floats"], 4 * centers * n_off * d
    total = card_bytes()
    if slot + band > total:
        raise NotImplementedError(
            f"patch dimension d = {d}: one block of the solve kernel takes "
            f"{slot} bytes of global memory and one band of the candidate "
            f"stack ({centers} centers of {n_off} offsets) {band} bytes, "
            f"{slot + band} bytes in all, more than the card's {total} bytes "
            "of memory")


def check_solve_path(d: int, n_off: int, centers: int = 32) -> None:
    """The CUDA engine's gate, decided from the patch dimension ``d``, the
    window's ``n_off`` = (2b + 1)^2 offsets and the centers of the
    engine's least band (a row of a tile: ``centers``, the tile's side): a
    center takes the main path, and so the solve kernel, only with
    n >= d + 1 similar candidates, so with n_off <= d no kernel launches
    whatever d is (every center takes the mean-patch fallback, as JAX's
    plain path runs it). Raises ``check_kernel_dim``'s NotImplementedError
    only where a center could reach a solve the card cannot hold."""
    if n_off >= d + 1:
        check_kernel_dim(d, n_off, centers)


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


def _jacobi_fp32(a: torch.Tensor, sweeps: int, graphs: bool = True):
    """The kernels' Jacobi of the symmetric float32 (P, d, d) ``a``, the
    TPU kernel's own (``_jacobi_clamp_psd``): ``a`` zero-padded to an even
    dp, one-sided accumulation of Q (rows are eigenvector estimates) and
    W = Q A with row-only fast-Givens rotations of the pairs (i, i + dp/2),
    the Brent-Luk re-seating after each round, rows renormalized at each
    sweep's end. Returns the exact final eigenvalues <W[k], Q[k]> (P, dp)
    and Q (P, dp, dp).

    A round is about 65 small operations, so on a CUDA device its launches
    bound it (about 1.2 ms a round on an H100, whatever d); there, with
    ``graphs``, one round is captured in a CUDA graph and replayed: the
    same kernels on the same buffers, so the same bits."""
    f32 = torch.float32
    p_total, d = a.shape[0], a.shape[-1]
    dp = d + d % 2
    half = dp // 2
    w = torch.nn.functional.pad(a, (0, dp - d, 0, dp - d))
    q = torch.eye(dp, dtype=f32, device=a.device).repeat(p_total, 1, 1)
    dall = torch.diagonal(w, dim1=1, dim2=2).clone()
    order = torch.as_tensor(reseat_order(dp), device=a.device)

    def rotate(w, q, dall, f):
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
        return w, q, dall, f

    f = torch.ones((p_total, dp), dtype=f32, device=a.device)
    if a.is_cuda and graphs and sweeps > 0:
        # a warm-up round on a side stream (its results dropped), then one
        # captured round that writes the next state over this one
        cur = torch.cuda.current_stream(a.device)
        side = torch.cuda.Stream(a.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            rotate(w, q, dall, f)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for old, new in zip((w, q, dall, f), rotate(w, q, dall, f)):
                old.copy_(new)
        for _ in range(sweeps):
            f.fill_(1.0)
            for _ in range(dp - 1):
                graph.replay()
            w.mul_(f[..., None])
            q.mul_(f[..., None])
        del graph
        return (w * q).sum(-1), q
    for _ in range(sweeps):
        f = torch.ones((p_total, dp), dtype=f32, device=a.device)
        for _ in range(dp - 1):
            w, q, dall, f = rotate(w, q, dall, f)
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


def _pm_check(cand, mask, noise, n, m, npx: int):
    """solve_filter_pm's argument checks; returns (P, O, d)."""
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
    return p_total, n_off, d


def _pm_field(cand, rows):
    """The field solve_filter_pm returns on the card, the rows to solve
    (int32 or None) and their count."""
    p_total, n_off, d = cand.shape
    if rows is None:
        return torch.empty((p_total, n_off, d), device=cand.device), None, \
            p_total
    rows_i32 = rows.to(device=cand.device, dtype=torch.int32).contiguous()
    return (torch.zeros((p_total, n_off, d), device=cand.device), rows_i32,
            rows_i32.numel())


def _big_blocks(d: int, n_rows: int, dev) -> int:
    """Blocks of csrc/solve_filter_big.cu's persistent grid for ``n_rows``
    pixels at patch dimension d: as many as the SMs, the rows and the card's
    free memory allow, each with its global slot. Raises NotImplementedError
    for a d that is no patch dimension, or, where there is a pixel to solve,
    whose one slot passes the memory the card has free (naming the
    bytes)."""
    lay = big_layout(d)
    if lay is None:
        check_kernel_dim(d)  # raises: d is no patch dimension
    slot = 4 * lay["slot_floats"]
    free, _ = torch.cuda.mem_get_info(dev)
    avail = (free + torch.cuda.memory_reserved(dev)
             - torch.cuda.memory_allocated(dev))
    if n_rows > 0 and avail < slot:
        raise NotImplementedError(
            f"patch dimension d = {d}: one block of the solve kernel takes "
            f"{slot} bytes of global memory, more than the card's {avail} "
            "bytes free")
    return min(n_rows, avail // slot, torch.cuda.get_device_properties(
        dev).multi_processor_count)


def _launch_big(tensors, rows_i32, n_rows: int, min_eigen: float,
                sweeps: int, field) -> None:
    """csrc/solve_filter_big.cu on ``n_rows`` pixels (``_big_blocks``)."""
    _, n_off, d = field.shape
    dev = field.device
    n_blocks = _big_blocks(d, n_rows, dev)
    p, lib = _build.ptr, _build.library()
    scratch = torch.empty(lib.bcd_solve_filter_big_scratch_floats(d, n_blocks),
                          device=dev)
    rc = lib.bcd_solve_filter_big(
        *map(p, tensors), None if rows_i32 is None else p(rows_i32),
        float(min_eigen), n_rows, n_off, d, int(sweeps), p(scratch), n_blocks,
        p(field), _build.stream_of(field))
    _build.LAUNCHES["solve_filter_big"] += 1
    _build.check(rc, "solve_filter_big")


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
    kernel's number of Jacobi sweeps; the twin's exact eigh has none. On
    CUDA, d = 27 and 75 run ``csrc/solve_filter.cu``, d = 147, 243, 363,
    507, 675, 867, 1083, 1323, 1587 and 1875 ``csrc/solve_filter_smem.cu``,
    and every patch dimension from 2187 on ``csrc/solve_filter_big.cu``,
    unless no pixel is to be solved (an empty ``rows``: no launch); a d
    that is no patch dimension, or whose kernel's slot passes the card's
    memory, is refused (``check_kernel_dim``). A failed launch raises.
    """
    p_total, n_off, d = _pm_check(cand, mask, noise, n, m, npx)
    tensors = (cand, mask, noise, n, m)
    if cand.device.type == "cpu":
        return solve_filter_pm_plain(cand, mask, noise, n, m, min_eigen, npx,
                                     rows)
    field, rows_i32, n_rows = _pm_field(cand, rows)
    if n_rows == 0:  # nothing to solve: no launch, whatever d is
        return field
    if d >= BIG_FROM_D:
        _launch_big(tensors, rows_i32, n_rows, min_eigen, sweeps, field)
        return field
    check_kernel_dim(d)
    p, lib = _build.ptr, _build.library()
    rows_p = None if rows_i32 is None else p(rows_i32)
    if d in SMEM_DIMS:
        # a persistent grid, one block an SM, each with its scratch slot
        n_blocks = min(n_rows, torch.cuda.get_device_properties(
            cand.device).multi_processor_count)
        scratch = torch.empty(
            lib.bcd_solve_filter_smem_scratch_floats(d, n_blocks),
            device=cand.device)
        rc = lib.bcd_solve_filter_smem(
            *map(p, tensors), rows_p, float(min_eigen), n_rows, n_off, d,
            int(sweeps), p(scratch), n_blocks, p(field),
            _build.stream_of(cand))
        _build.LAUNCHES[SMEM_DIMS[d]] += 1
        _build.check(rc, SMEM_DIMS[d])
        return field
    rc = lib.bcd_solve_filter(
        *map(p, tensors), rows_p, float(min_eigen), n_rows, n_off, d,
        int(sweeps), p(field), _build.stream_of(cand))
    _build.LAUNCHES["solve_filter"] += 1
    _build.check(rc, "solve_filter")
    return field


def solve_filter_pm_big(cand, mask, noise, n, m, min_eigen: float, npx: int,
                        sweeps: int, rows=None):
    """``csrc/solve_filter_big.cu`` at any patch dimension, with
    ``solve_filter_pm``'s arguments and result: the kernel that
    ``solve_filter_pm`` runs from d = 2187, called directly at a smaller d
    only by the checks that hold it to the compiled instances there
    (``chip_smoke.py`` phase 17 (a), ``tests/test_torch_kernels_gpu.py``).
    On the CPU the plain twin."""
    _pm_check(cand, mask, noise, n, m, npx)
    if cand.device.type == "cpu":
        return solve_filter_pm_plain(cand, mask, noise, n, m, min_eigen, npx,
                                     rows)
    field, rows_i32, n_rows = _pm_field(cand, rows)
    if n_rows:
        _launch_big((cand, mask, noise, n, m), rows_i32, n_rows, min_eigen,
                    sweeps, field)
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
    (a2t (d, d, P) with a2t[k, j, p] = A2[p][j, k], b2 (1, d, P)).

    On CUDA, d = 27 and 75 run ``csrc/solve_filter.cu`` and every other
    patch dimension the runtime-d kernel ``csrc/solve_filter_big.cu`` fed by
    the moments (``bcd_solve_matrices_big``), unless P = 0 (no launch). A d
    that is no patch dimension, or whose one block of the runtime-d kernel
    passes the card's free memory, is refused before any launch (the
    message names the bytes). ``sweeps`` is the kernel's number of Jacobi
    sweeps; the twin's exact eigh has none."""
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
    dev = m2_t.device
    # a d the card cannot hold is refused first, whatever the inputs' layout
    n_blocks = (_big_blocks(d, p_total, dev) if dev.type == "cuda"
                and d not in REGISTER_DIMS else 0)
    _check_kernel_inputs(names, tensors)
    if dev.type == "cpu":
        return solve_matrices_plain(m2_t, msum_t, nov_t, n_t, min_eigen, npx)
    # pixel rows for the kernel, held here until the launch is queued
    rows = [m2_t.permute(2, 0, 1).contiguous(), msum_t.T.contiguous(),
            nov_t.T.contiguous(), n_t]
    a2t = torch.empty((p_total, d, d), device=dev)
    b2 = torch.empty((p_total, d), device=dev)
    if p_total > 0:  # else nothing to solve: no launch
        p, lib = _build.ptr, _build.library()
        if d in REGISTER_DIMS:
            rc = lib.bcd_solve_matrices(
                *map(p, rows), float(min_eigen), p_total, d, int(sweeps),
                p(a2t), p(b2), _build.stream_of(m2_t))
            name = "solve_matrices"
        else:
            scratch = torch.empty(
                lib.bcd_solve_filter_big_scratch_floats(d, n_blocks),
                device=dev)
            rc = lib.bcd_solve_matrices_big(
                *map(p, rows), float(min_eigen), p_total, d, int(sweeps),
                p(scratch), n_blocks, p(a2t), p(b2), _build.stream_of(m2_t))
            name = "solve_matrices_big"
        _build.LAUNCHES[name] += 1
        _build.check(rc, name)
    return a2t.permute(1, 2, 0).contiguous(), b2.T[None].contiguous()


def solve_matrices_schedule(m2_t, msum_t, nov_t, n_t, min_eigen: float,
                            npx: int, sweeps: int):
    """The lane ``solve_matrices``' kernel schedule in plain float32
    (``solve_schedule_core``); returns (a2t (d, d, P), b2 (1, d, P))."""
    f32 = torch.float32
    d = m2_t.shape[0]
    n = n_t.to(f32)[0]
    # the mean patch and noise as the kernels form them: times 1 / max(n, 1)
    inv_n = 1.0 / n.clamp(min=1.0)[:, None]
    m = msum_t.to(f32).T * inv_n
    x2, b2 = solve_schedule_core(
        _cemp(m2_t.to(f32).permute(2, 0, 1), m, n),
        _noise_bd(nov_t.to(f32).T * inv_n, npx), m, min_eigen, sweeps)
    a2t = torch.eye(d, dtype=f32, device=m2_t.device) - x2  # a2t[p, k, j]
    return a2t.permute(1, 2, 0).contiguous(), b2.T[None].contiguous()
