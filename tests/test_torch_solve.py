"""The port's solve twins (bcd_tpu_torch/ops/solve_filter.py) against the JAX
solves: K2 (solve_matrices_pm), the candidate-stack solve_filter and the
lane-form solve_matrices, each against its XLA reference and its Pallas
kernel in interpret mode."""

import numpy as np
import pytest
import torch

from bcd_tpu_torch.core.monoscale import solve_filter_sweeps
from bcd_tpu_torch.ops import solve_filter as ts
from tests.test_solve_filter_pallas import _moment_inputs, _pm_inputs, make_inputs
from tests.torch_workers import share_cores

share_cores()

D = 27


def _rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _torch_solve(m2_pm, misc):
    a2t, small = ts.solve_matrices_pm(
        torch.from_numpy(m2_pm), torch.from_numpy(misc[:, :ts.MISC_CH].copy()),
        1e-8, sweeps=4)
    return a2t.numpy(), small.numpy()


@pytest.mark.parametrize("P", [128, 256])
def test_twin_matches_jax_reference(P):
    import jax.numpy as jnp
    from bcd_tpu.ops.solve_filter_pallas import solve_matrices_pm_reference

    m2_pm, misc = _pm_inputs(np.random.default_rng(1234 + P), P=P)
    a2t, small = _torch_solve(m2_pm, misc)
    a2t_r, small_r = (np.asarray(x) for x in solve_matrices_pm_reference(
        jnp.asarray(m2_pm), jnp.asarray(misc), 1e-8))
    assert _rms(a2t, a2t_r) < 2e-4
    small_r = small_r[:, :ts.SMALL_CH]
    np.testing.assert_array_equal(small[:, D], small_r[:, D])
    np.testing.assert_array_equal(small[:, 2 * D + 1], small_r[:, 2 * D + 1])
    assert _rms(small, small_r) < 2e-4


def test_twin_matches_jax_kernel_interpret():
    import jax.numpy as jnp
    from bcd_tpu.ops.solve_filter_pallas import solve_matrices_pm

    m2_pm, misc = _pm_inputs(np.random.default_rng(4321), P=128)
    a2t, small = _torch_solve(m2_pm, misc)
    a2t_k, small_k = (np.asarray(x) for x in solve_matrices_pm(
        jnp.asarray(m2_pm), jnp.asarray(misc), 1e-8, interpret=True,
        sweeps=10))
    assert _rms(a2t, a2t_k) < 2e-4
    assert _rms(small, small_k[:, :ts.SMALL_CH]) < 2e-4
    np.testing.assert_array_equal(small[:, D], small_k[:, D])


def test_twin_degenerate_pixels_finite():
    """Zero moments with the pad convention n=1 and empty sets n=0 must
    give finite A2 and b2: K4 multiplies them by the gate."""
    m2_pm, misc = _pm_inputs(np.random.default_rng(7), P=128)
    m2_pm[:32] = 0.0
    misc[:32, : D + 54] = 0.0
    misc[:16, D + 54] = 1.0
    misc[16:32, D + 54] = 0.0
    a2t, small = _torch_solve(m2_pm, misc)
    assert np.isfinite(a2t).all() and np.isfinite(small).all()
    assert (small[:32, D] == 0).all()  # never on the main path


# ---------------------------------------------------------------------------
# solve_filter (candidate stacks) and the lane-form solve_matrices
# ---------------------------------------------------------------------------


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("O,d", [(49, 27), (121, 75), (49, 147)])
def test_solve_filter_twin_matches_jax_reference(O, d):
    """d = 27 (r = 1), d = 75 (r = 2, npx = 25) and d = 147 (r = 3, npx =
    49), P = 128, within JAX's own kernel-vs-reference bound
    (test_solve_filter_pallas.py:34). At d = 147 JAX's Pallas kernel cannot
    run on a TPU (its scratch outgrows VMEM), so the reference is
    ``solve_filter_reference``, the function JAX's plain path computes; P =
    8 there, as JAX's Jacobi eigh at d = 147 takes about 0.5 s a pixel on a
    CPU core."""
    import jax.numpy as jnp
    from bcd_tpu.ops.solve_filter_pallas import solve_filter_reference

    npx = d // 3
    P = 8 if d == 147 else 128
    args = make_inputs(np.random.default_rng(O), O=O, d=d, npx=npx, P=P)
    got = ts.solve_filter(*_t(*args), 1e-8, npx=npx, sweeps=6).numpy()
    ref = np.asarray(solve_filter_reference(
        *(jnp.asarray(a) for a in args), 1e-8, npx=npx))
    assert got.shape == (O, d, P)
    assert _rms(got, ref) < 2e-4


def test_solve_filter_twin_matches_jax_kernel_interpret():
    import jax.numpy as jnp
    from bcd_tpu.ops.solve_filter_pallas import solve_filter

    args = make_inputs(np.random.default_rng(11))
    got = ts.solve_filter(*_t(*args), 1e-8, npx=9, sweeps=10).numpy()
    ref = np.asarray(solve_filter(*(jnp.asarray(a) for a in args), 1e-8,
                                  interpret=True, sweeps=10))
    assert _rms(got, ref) < 2e-4


def test_solve_matrices_twin_matches_jax():
    """The lane form against solve_matrices_reference and against the
    Pallas kernel in interpret mode."""
    import jax.numpy as jnp
    from bcd_tpu.ops.solve_filter_pallas import (
        solve_matrices, solve_matrices_reference)

    m2, msum, nov, n, *_ = _moment_inputs(np.random.default_rng(12))
    got = [x.numpy() for x in ts.solve_matrices(*_t(m2, msum, nov, n), 1e-8,
                                                npx=9, sweeps=10)]
    jargs = [jnp.asarray(a) for a in (m2, msum, nov, n)]
    for ref in (solve_matrices_reference(*jargs, 1e-8),
                solve_matrices(*jargs, 1e-8, interpret=True, sweeps=10)):
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            assert _rms(g, r) < 2e-4


@pytest.mark.parametrize("O,d", [(49, 27), (121, 75)])
def test_solve_matrices_consistent_with_solve_filter(O, d):
    """The moment form and the candidate-stack form give the same filter:
    field_o = mask_o (A2 c_o + b2) (test_solve_filter_pallas.py:88-109)."""
    npx = d // 3
    m2, msum, nov, n, C, mask, noise, m = _moment_inputs(
        np.random.default_rng(13), O=O, d=d, npx=npx)
    a2t, b2 = ts.solve_matrices(*_t(m2, msum, nov, n), 1e-8, npx=npx,
                                sweeps=6)
    field = ts.solve_filter(*_t(C, mask, noise, n, m), 1e-8, npx=npx,
                            sweeps=6).numpy()
    a2 = a2t.numpy().transpose(2, 1, 0)  # (P, j, k)
    want = mask[:, None, :] * (np.einsum("pjk,okp->ojp", a2, C)
                               + b2.numpy()[0][None])
    assert _rms(field, want) < 2e-4


def test_solve_matrices_twin_matches_jax_reference_at_d147():
    """The lane form at d = 147, where the card runs the runtime-d kernel
    fed by the moments (csrc/solve_filter_big.cu): the twin (what the
    wrapper returns on the CPU) against JAX's ``solve_matrices_reference``
    on 6 pixels of 289 candidates, within 2e-4 rms. The JAX reference and
    not its Pallas kernel in interpret mode, which would be slow at this
    d."""
    import jax.numpy as jnp
    from bcd_tpu.ops.solve_filter_pallas import solve_matrices_reference

    m2, msum, nov, n, *_ = _moment_inputs(np.random.default_rng(147), O=289,
                                          d=147, npx=49, P=6)
    got = ts.solve_matrices(*_t(m2, msum, nov, n), 1e-8, npx=49, sweeps=8)
    ref = solve_matrices_reference(
        *(jnp.asarray(a) for a in (m2, msum, nov, n)), 1e-8, npx=49)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _rms(g.numpy(), np.asarray(r)) < 2e-4


@pytest.mark.parametrize("d", [147, 363])
def test_solve_matrices_takes_every_patch_dimension(d):
    """The lane form is refused by no d: on the CPU it takes any d = 3 npx
    (on the card every d but 27 and 75 runs the runtime-d kernel, refused
    only for the card's memory), with its shapes checked; the refusal by d
    and its names are gone."""
    npx = d // 3
    m2, msum, nov, n, *_ = _moment_inputs(np.random.default_rng(d), O=25,
                                          d=d, npx=npx, P=2)
    a2t, b2 = ts.solve_matrices(*_t(m2, msum, nov, n), 1e-8, npx=npx,
                                sweeps=solve_filter_sweeps(d))
    assert a2t.shape == (d, d, 2) and b2.shape == (1, d, 2)
    assert bool(torch.isfinite(a2t).all() and torch.isfinite(b2).all())
    with pytest.raises(ValueError, match="3 \\* npx"):
        ts.solve_matrices(*_t(m2, msum, nov, n), 1e-8, npx=npx + 1, sweeps=8)
    with pytest.raises(ValueError, match="nov_t"):
        ts.solve_matrices(*_t(m2, msum, nov[:-6], n), 1e-8, npx=npx,
                          sweeps=8)
    assert not hasattr(ts, "LANE_KERNEL_DIMS")
    assert not hasattr(ts, "ROADMAP_LANE_D")
    assert ts.REGISTER_DIMS == (27, 75)


@pytest.mark.parametrize("O,d", [(49, 27), (121, 75)])
def test_solve_twins_degenerate_pixels_finite(O, d):
    """Every pixel the kernels see must come out finite: the engine
    multiplies by the gate, and 0 * NaN is NaN. Pixels 0-15: n = 1 with
    zero moments (pad lanes); 16-31: n = 0, an empty set; 32-47: every
    candidate masked out."""
    npx = d // 3
    m2, msum, nov, n, C, mask, noise, m = _moment_inputs(
        np.random.default_rng(14), O=O, d=d, npx=npx)
    for a in (m2, msum, nov, C, noise, m):
        a[..., :32] = 0.0
    n[:, :16] = 1.0
    n[:, 16:32] = 0.0
    mask[:, 16:48] = 0.0
    field = ts.solve_filter(*_t(C, mask, noise, n, m), 1e-8, npx=npx,
                            sweeps=6).numpy()
    assert np.isfinite(field).all()
    assert (field[:, :, 16:48] == 0).all()
    a2t, b2 = ts.solve_matrices(*_t(m2, msum, nov, n), 1e-8, npx=npx,
                                sweeps=6)
    assert bool(torch.isfinite(a2t).all() and torch.isfinite(b2).all())


def test_solve_wrappers_refuse_bad_inputs():
    C, mask, noise, n, m = _t(*make_inputs(np.random.default_rng(15), P=4))
    with pytest.raises(ValueError, match="3 \\* npx"):
        ts.solve_filter(C, mask, noise, n, m, 1e-8, npx=25, sweeps=6)
    with pytest.raises(ValueError, match="mask_t"):
        ts.solve_filter(C, mask[:, :3], noise, n, m, 1e-8, npx=9, sweeps=6)
    with pytest.raises(ValueError, match="n_t"):
        ts.solve_filter(C, mask, noise, n[0], m, 1e-8, npx=9, sweeps=6)
    with pytest.raises(ValueError, match="msum_t"):
        ts.solve_matrices(torch.zeros(27, 27, 4), torch.zeros(27, 3),
                          torch.zeros(54, 4), torch.ones(1, 4), 1e-8, npx=9,
                          sweeps=6)


@pytest.mark.parametrize("d", [27, 75, 147, 243, 363, 507, 675, 867, 1083,
                               1323, 1587, 1875, 2187, 2523, 4107, 4563,
                               11163])
def test_kernel_dims(d):
    """The CUDA solve kernels: compiled for patch radius 1, 2 (registers),
    3 (shared memory), 4 to 12 (shared memory and a global slot); from
    radius 13 (d = 2187) the runtime-d kernel takes every patch dimension,
    also past radius 18 (d = 4,107), where its vectors begin to move to the
    global slot, and at radius 30 (d = 11,163): none is refused for a
    layout."""
    assert (d in ts.KERNEL_DIMS) == (d <= 1875)
    assert (d >= ts.BIG_FROM_D) == (d not in ts.KERNEL_DIMS)
    ts.check_kernel_dim(d)
    ts.check_kernel_dim(d, n_off=(int(np.sqrt(d)) + 2) ** 2, centers=32)


@pytest.mark.parametrize("d,shared_vectors,global_rows,slot_floats", [
    (2187, 9, 4363, 19_120_932), (4107, 9, 8215, 67_498_548),
    (4563, 8, 9127, 83_324_948), (11163, 4, 22328, 498_628_896),
])
def test_big_layout(d, shared_vectors, global_rows, slot_floats):
    """The runtime-d kernel's layout (``big_layout``, the kernel's
    ``make_layout``): every vector in shared memory through patch radius 18
    (d = 4,107, one shared row of W), from radius 19 (d = 4,563) the staged
    pivot rows in the global slot, at radius 30 five of the nine vectors;
    at d = 2187 13 of the 4,376 rows in shared memory and a slot of
    2 (d + 1)^2 + 4,363 (d + 1) floats a block (76.5 MB; 132 blocks take
    2,523,963,024 floats, past 2^31). The shared bytes never pass a
    block's 232,448."""
    lay = ts.big_layout(d)
    dp = d + 1
    assert lay["shared_vectors"] == shared_vectors
    assert lay["global_rows"] == global_rows
    assert lay["slot_floats"] == slot_floats == (
        2 * dp * dp + global_rows * dp + lay["global_vector_floats"])
    assert lay["smem_bytes"] <= ts.SMEM_BYTES
    assert lay["shared_rows"] + global_rows == 2 * dp
    assert ts.big_layout(2187)["slot_floats"] * 132 == 2_523_963_024
    assert ts.big_layout(2188) is None and ts.big_layout(2186) is None


@pytest.mark.parametrize("d,n_off,centers,refused", [
    (2187, 2209, 32, False), (24843, 25281, 32, True),
    (24843, 25281, 16, False), (77763, 0, 0, True), (2187, 361201, 32, True),
])
def test_kernel_dim_refused_only_for_memory(d, n_off, centers, refused):
    """A patch dimension is refused only where one block's global slot of
    the runtime-d kernel and one band of the candidate stack (``centers``
    centers of ``n_off`` offsets) pass the card's memory (on a host with
    no card an H100's 80 GB), and the message names the bytes: r = 45
    (d = 24,843) at its smallest window reaching the solve, b = 79, with a
    row of 32 centers (80.4 GB of stack), not with 16; r = 80 (d = 77,763),
    whose slot alone takes 96.8 GB; r = 13 at b = 300 (361,201 offsets,
    101 GB a row). A d that is no patch dimension is refused as such."""
    if refused:
        with pytest.raises(NotImplementedError,
                           match="bytes in all, more than the card's"):
            ts.check_kernel_dim(d, n_off, centers)
    else:
        ts.check_kernel_dim(d, n_off, centers)
    with pytest.raises(NotImplementedError, match="not a patch dimension"):
        ts.check_kernel_dim(2000)


def test_smem_build_units_cover_every_dim():
    """The library's build compiles csrc/solve_filter_smem.cu once for each
    d that ``solve_filter_pm`` sends it (``SMEM_DIMS``) and once for its C
    entries, and the file instantiates and dispatches every one of them;
    csrc/solve_filter_big.cu, the runtime-d kernel, is one unit of its own
    with its own launch counter and C entries."""
    from bcd_tpu_torch.ops import _build

    one, entries, dims = _build.SPLIT["solve_filter_smem.cu"]
    assert sorted(dims) == sorted(ts.SMEM_DIMS)
    assert set(ts.SMEM_DIMS.values()) <= set(_build.LAUNCHES)
    src = _build.CSRC / "solve_filter_smem.cu"
    flags = [extra for unit, extra, _ in _build._units([src])]
    assert flags == [[f"-D{entries}"]] + [[f"-D{one}={d}"] for d in dims]
    text = src.read_text()
    for d in dims:
        assert f"d == {d}" in text and f"launch<{d}>(" in text
        assert f"Smem<{d}>::SCRATCH" in text
    big = _build.CSRC / "solve_filter_big.cu"
    assert "solve_filter_big.cu" not in _build.SPLIT
    assert _build._units([big]) == [(big, [], "solve_filter_big")]
    assert "solve_filter_big" in _build.LAUNCHES
    text = big.read_text()
    for entry in ("bcd_solve_filter_big", "bcd_solve_filter_big_layout",
                  "bcd_solve_filter_big_scratch_floats"):
        assert f'extern "C" ' in text and f" {entry}(" in text
        assert entry in _build._SIGNATURES


@pytest.mark.parametrize("r,b,accepted", [
    (4, 6, True), (4, 7, True), (4, 8, True), (5, 9, True), (5, 10, True),
    (6, 10, True), (6, 11, True), (6, 13, True), (7, 12, True),
    (7, 13, True), (8, 14, True), (8, 15, True), (9, 15, True),
    (9, 16, True), (10, 17, True), (10, 18, True), (11, 19, True),
    (11, 20, True), (12, 21, True), (12, 22, True), (13, 22, True),
    (13, 23, True), (14, 25, True), (30, 53, True), (45, 79, False),
    (13, 300, False),
])
def test_solve_path_gate(r, b, accepted):
    """The CUDA engine's and CLI's gate: a center needs n >= d + 1 similar
    candidates to reach the solve, so a window of (2b + 1)^2 <= d offsets
    never launches a solve kernel and runs whatever d is (r = 4 at b <= 7,
    r = 5 at b <= 9, r = 6 at b <= 10, r = 7 at b <= 12, r = 8 at b <= 14,
    r = 9 at b <= 15, r = 10 at b <= 17, r = 11 at b <= 19, r = 12 at
    b <= 21, r = 13 at b <= 22: every center takes the fallback, as in
    JAX); r = 5 at b = 10 runs the d = 363 kernel, r = 6 from b = 11 the
    d = 507 one, r = 7 from b = 13 the d = 675 one, r = 8 from b = 15 the
    d = 867 one, r = 9 from b = 16 the d = 1083 one, r = 10 from b = 18 the
    d = 1323 one, r = 11 from b = 20 the d = 1587 one, r = 12 from b = 22
    the d = 1875 one; r = 13 from b = 23 (2,209 offsets >= 2,188) the
    runtime-d one, and so every larger radius, r = 14 from b = 25 and r = 30
    from b = 53, until one block's slot and a row of 32 centers' stack pass
    the card's memory (an H100's 80 GB here): r = 45 at b = 79, r = 13 at
    b = 300."""
    d, n_off = 3 * (2 * r + 1) ** 2, (2 * b + 1) ** 2
    if accepted:
        ts.check_solve_path(d, n_off)
    else:
        with pytest.raises(NotImplementedError,
                           match="bytes in all, more than the card's"):
            ts.check_solve_path(d, n_off)


# ---------------------------------------------------------------------------
# K2's schedule model (the register Jacobi of csrc/solve_matrices_pm.cu)
# ---------------------------------------------------------------------------


def _schedule(m2_pm, misc, sweeps, **kw):
    a2t, small = ts.solve_matrices_pm_schedule(
        torch.from_numpy(m2_pm), torch.from_numpy(misc[:, :ts.MISC_CH].copy()),
        1e-8, sweeps, **kw)
    return a2t.numpy(), small.numpy()


def test_schedule_matches_jax_kernel_interpret():
    """The model runs the TPU kernel's own Jacobi (one-sided, fast Givens,
    Brent-Luk re-seating) at the engine's 4 sweeps: with the TPU kernel's
    clamp it agrees with JAX's kernel to rounding (rms 1.7e-7 here), so the
    bound is tight, 1e-5. With K2's clamp (Cemp plus the negative
    eigen-directions) the two differ by the unconverged off-diagonal
    residue that K2's clamp leaves out."""
    import jax.numpy as jnp
    from bcd_tpu.ops.solve_filter_pallas import solve_matrices_pm

    m2_pm, misc = _pm_inputs(np.random.default_rng(4321), P=128)
    a2t_k, small_k = (np.asarray(x) for x in solve_matrices_pm(
        jnp.asarray(m2_pm), jnp.asarray(misc), 1e-8, interpret=True,
        sweeps=4))
    a2t, small = _schedule(m2_pm, misc, 4, jax_clamp=True)
    assert _rms(a2t, a2t_k) < 1e-5
    assert _rms(small, small_k[:, :ts.SMALL_CH]) < 1e-5
    np.testing.assert_array_equal(small[:, D], small_k[:, D])
    np.testing.assert_array_equal(small[:, 2 * D + 1], small_k[:, 2 * D + 1])


def test_schedule_matches_twin():
    """K2's clamp through the model against the float64 twin, within the
    kernels' 2e-4 at 6 sweeps (the bound the card's K2 is held to on
    synthetic moments; at 4 the raw A2 carries the unconverged part)."""
    m2_pm, misc = _pm_inputs(np.random.default_rng(77), P=128)
    a2t, small = _schedule(m2_pm, misc, 6)
    a2t_p, small_p = _torch_solve_plain(m2_pm, misc)
    assert _rms(a2t, a2t_p) < 2e-4
    assert _rms(small, small_p) < 2e-4
    np.testing.assert_array_equal(small[:, D], small_p[:, D])
    np.testing.assert_array_equal(small[:, 2 * D + 1], small_p[:, 2 * D + 1])


def _torch_solve_plain(m2_pm, misc):
    a2t, small = ts.solve_matrices_pm_plain(
        torch.from_numpy(m2_pm), torch.from_numpy(misc[:, :ts.MISC_CH].copy()),
        1e-8)
    return a2t.numpy(), small.numpy()


def degenerate_pm_inputs(rng, P=128):
    """K2 inputs with degenerate pixels: 0-15 n = 1 and zero moments (pad
    lanes), 16-31 n = 0 (empty sets), 32-47 the moments of a single
    candidate repeated n = 40 times (rank 1), 48-63 those of 5 candidates
    (rank 5, n = 30, on the main path)."""
    from bcd_tpu_torch.ops.fused import _tri_pack

    m2_pm, misc = _pm_inputs(rng, P=P)
    m2_pm[:32] = 0.0
    misc[:32, : D + 54] = 0.0
    misc[:16, D + 54] = 1.0
    misc[16:32, D + 54] = 0.0
    for lo, k, n in ((32, 1, 40), (48, 5, 30)):
        for p in range(lo, lo + 16):
            c = rng.standard_normal((k, D))
            reps = np.full(k, n // k)
            m2 = np.einsum("o,ok,ol->kl", reps, c, c)
            m2_pm[p] = m2.reshape(-1)[_tri_pack(D)]
            misc[p, :D] = reps @ c
            misc[p, D + 54] = n
            misc[p, D + 55] = 1.0
    return m2_pm, misc


def test_schedule_degenerate_pixels():
    """Empty, single-sample and rank-deficient similar sets: finite filters
    and gates equal to the twin's (rank-deficient sets of n >= 28 stay on
    the main path)."""
    m2_pm, misc = degenerate_pm_inputs(np.random.default_rng(8))
    a2t, small = _schedule(m2_pm, misc, 4)
    _, small_p = _torch_solve_plain(m2_pm, misc)
    assert np.isfinite(a2t).all() and np.isfinite(small).all()
    np.testing.assert_array_equal(small[:, D], small_p[:, D])
    np.testing.assert_array_equal(small[:, 2 * D + 1], small_p[:, 2 * D + 1])
    assert (small[:32, D] == 0).all() and (small[32:64, D] == 1).all()


@pytest.mark.parametrize("dp", [28, 76, 148, 244, 364, 508, 676, 868, 1084,
                                1324, 1588, 1876])
def test_reseat_order_is_one_sweep_cycle(dp):
    """reseat_order is the TPU kernel's re-seating (the concatenation of
    solve_filter_pallas.py:184-187, written out on row labels): a
    permutation that keeps row 0 and moves the other rows along one cycle
    of length dp - 1, the round-robin order of a Brent-Luk sweep, at K2's
    dp = 28 and solve_filter's dp = 76, 148, 244, 364, 508, 676, 868, 1084,
    1324, 1588 and 1876 (d = 75, 147, 243, 363, 507, 675, 867, 1083, 1323,
    1587 and 1875)."""
    order = ts.reseat_order(dp)
    half = dp // 2
    u, dn = np.arange(half), np.arange(half, dp)
    tpu = np.concatenate([u[0:1], dn[0:1], u[1 : half - 1], dn[1:half],
                          u[half - 1 : half]])
    assert order == tpu.tolist()
    assert order[0] == 0
    row, length = 1, 0
    while True:
        row = order.index(row)  # the new position of the old row
        length += 1
        if row == 1:
            break
    assert length == dp - 1


@pytest.mark.parametrize("d", [75, 147])
@pytest.mark.parametrize("form", ["solve_filter", "solve_matrices"])
def test_schedule_matches_twins(form, d):
    """The kernels' fp32 schedule (the Jacobi as a function of d) against
    the float64 twins, within the kernels' 2e-4: at d = 75, 6 sweeps on 16
    pixels of 121 candidates (about 4e-6 here); at d = 147, the engine's 8
    sweeps (core/monoscale.solve_filter_sweeps) on 8 pixels of 49
    candidates (about 7e-7). The model the card's solve kernels are held
    to."""
    npx = d // 3
    O, P = (121, 16) if d == 75 else (49, 8)
    sweeps = solve_filter_sweeps(d)
    m2, msum, nov, n, C, mask, noise, m = _moment_inputs(
        np.random.default_rng(21), O=O, d=d, npx=npx, P=P)
    if form == "solve_filter":
        pm = [t for t in _t(C.transpose(2, 0, 1), mask.T, noise.T, n[0],
                            m.T)]
        got = ts.solve_filter_pm_schedule(*pm, 1e-8, npx, sweeps)
        want = ts.solve_filter_pm_plain(*pm, 1e-8, npx)
        assert got.shape == want.shape == (P, O, d)
        assert _rms(got, want) < 2e-4
    else:
        got = ts.solve_matrices_schedule(*_t(m2, msum, nov, n), 1e-8, npx,
                                         sweeps)
        want = ts.solve_matrices_plain(*_t(m2, msum, nov, n), 1e-8, npx)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert _rms(g, w) < 2e-4


def test_schedule_sweeps_at_d147():
    """Why the engine runs 8 sweeps at d = 147 where it runs 6 at d = 75:
    on 8 pixels of 169 candidates the fp32 schedule at 6 sweeps is about
    4.7e-4 rms from the float64 twin, past the kernels' 2e-4; at 8 about
    3e-6."""
    npx, d = 49, 147
    pm = _t(*(a for a in _pm_stacks(np.random.default_rng(21), 169, d, 8)))
    want = ts.solve_filter_pm_plain(*pm, 1e-8, npx)
    assert solve_filter_sweeps(d) == 8
    assert _rms(ts.solve_filter_pm_schedule(*pm, 1e-8, npx, 6), want) > 2e-4
    assert _rms(ts.solve_filter_pm_schedule(*pm, 1e-8, npx, 8), want) < 2e-5


def test_schedule_sweeps_at_d243():
    """Why the engine runs 8 sweeps at d = 243, the smallest count that
    keeps the fp32 schedule within 2e-5 rms of the float64 twin: on 8
    pixels of 289 candidates 7 sweeps leave about 1.1e-4, 8 about 5e-6."""
    npx, d = 81, 243
    pm = _t(*(a for a in _pm_stacks(np.random.default_rng(21), 289, d, 8)))
    want = ts.solve_filter_pm_plain(*pm, 1e-8, npx)
    assert solve_filter_sweeps(d) == 8
    assert _rms(ts.solve_filter_pm_schedule(*pm, 1e-8, npx, 7), want) > 2e-5
    assert _rms(ts.solve_filter_pm_schedule(*pm, 1e-8, npx, 8), want) < 2e-5


def test_schedule_sweeps_at_d363():
    """Why the engine runs 8 sweeps at d = 363 too, the smallest count that
    keeps the fp32 schedule within 2e-5 rms of the float64 twin: on 8
    pixels of 441 candidates 7 sweeps leave about 1.1e-4, 8 about 7e-6."""
    npx, d = 121, 363
    pm = _t(*(a for a in _pm_stacks(np.random.default_rng(21), 441, d, 8)))
    want = ts.solve_filter_pm_plain(*pm, 1e-8, npx)
    assert solve_filter_sweeps(d) == 8
    assert _rms(ts.solve_filter_pm_schedule(*pm, 1e-8, npx, 7), want) > 2e-5
    assert _rms(ts.solve_filter_pm_schedule(*pm, 1e-8, npx, 8), want) < 2e-5


def _pm_stacks(rng, O, d, P):
    """make_inputs' stacks in solve_filter_pm's pixel-major layout."""
    C, mask, noise, n, m = make_inputs(rng, O=O, d=d, npx=d // 3, P=P)
    return C.transpose(2, 0, 1), mask.T, noise.T, n[0], m.T


def test_schedule_core_is_k2_schedule():
    """solve_matrices_pm_schedule (K2's model) is solve_schedule_core on
    K1's channel maps: the lane solve_matrices' model on the same moments
    gives the same filter to rounding."""
    from bcd_tpu_torch.ops.fused import _tri_pack

    m2, msum, nov, n, *_ = _moment_inputs(np.random.default_rng(22), P=16)
    m2_pm = m2.transpose(2, 0, 1).reshape(16, -1)[:, _tri_pack(D)]
    misc = np.zeros((16, ts.MISC_CH), np.float32)
    misc[:, :D] = msum.T
    misc[:, D : D + 54] = nov.T
    misc[:, D + 54] = n[0]
    misc[:, D + 55] = 1.0
    a2t, small = _schedule(np.ascontiguousarray(m2_pm), misc, 4)
    lane_a2t, lane_b2 = ts.solve_matrices_schedule(*_t(m2, msum, nov, n),
                                                   1e-8, 9, 4)
    assert _rms(a2t.reshape(16, D, D), lane_a2t.numpy().transpose(2, 0, 1)) \
        < 1e-5
    assert _rms(small[:, :D], lane_b2.numpy()[0].T) < 1e-5


def test_solve_filter_pm_is_the_lane_form():
    """solve_filter (JAX's lane layout) is solve_filter_pm on the transposed
    stacks; with ``rows`` only those pixels are solved, bit for bit, and the
    other rows are 0 (the engine's in-place entry)."""
    args = make_inputs(np.random.default_rng(23), P=24)
    C, mask, noise, n, m = _t(*args)
    lane = ts.solve_filter(C, mask, noise, n, m, 1e-8, npx=9, sweeps=6)
    pm = [C.permute(2, 0, 1).contiguous(), mask.T.contiguous(),
          noise.T.contiguous(), n[0].contiguous(), m.T.contiguous()]
    field = ts.solve_filter_pm(*pm, 1e-8, npx=9, sweeps=6)
    assert torch.equal(field, lane.permute(2, 0, 1))
    rows = torch.tensor([3, 7, 8, 20])
    part = ts.solve_filter_pm(*pm, 1e-8, npx=9, sweeps=6, rows=rows)
    assert torch.equal(part[rows], ts.solve_filter_pm(
        *[x[rows] for x in pm], 1e-8, npx=9, sweeps=6))
    rest = torch.ones(24, dtype=torch.bool)
    rest[rows] = False
    assert not bool(part[rest].any())
    empty = ts.solve_filter_pm(*pm, 1e-8, npx=9, sweeps=6,
                               rows=torch.zeros(0, dtype=torch.long))
    assert not bool(empty.any())


def test_solve_filter_pm_refuses_bad_inputs():
    C, mask, noise, n, m = _t(*make_inputs(np.random.default_rng(24), P=4))
    pm = [C.permute(2, 0, 1).contiguous(), mask.T.contiguous(),
          noise.T.contiguous(), n[0].contiguous(), m.T.contiguous()]
    with pytest.raises(ValueError, match="3 \\* npx"):
        ts.solve_filter_pm(*pm, 1e-8, npx=25, sweeps=6)
    with pytest.raises(ValueError, match="noise"):
        ts.solve_filter_pm(pm[0], pm[1], pm[2][:, :6], pm[3], pm[4], 1e-8,
                           npx=9, sweeps=6)
    with pytest.raises(ValueError, match="n must be"):
        ts.solve_filter_pm(pm[0], pm[1], pm[2], n, pm[4], 1e-8, npx=9,
                           sweeps=6)
