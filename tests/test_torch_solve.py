"""The port's solve twins (bcd_tpu_torch/ops/solve_filter.py) against the JAX
solves: K2 (solve_matrices_pm), the candidate-stack solve_filter and the
lane-form solve_matrices, each against its XLA reference and its Pallas
kernel in interpret mode."""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("O,d", [(49, 27), (121, 75)])
def test_solve_filter_twin_matches_jax_reference(O, d):
    """d = 27 (r = 1) and d = 75 (r = 2, npx = 25), P = 128, within JAX's
    own kernel-vs-reference bound (test_solve_filter_pallas.py:34)."""
    import jax.numpy as jnp
    from bcd_tpu.ops.solve_filter_pallas import solve_filter_reference

    npx = d // 3
    args = make_inputs(np.random.default_rng(O), O=O, d=d, npx=npx, P=128)
    got = ts.solve_filter(*_t(*args), 1e-8, npx=npx, sweeps=6).numpy()
    ref = np.asarray(solve_filter_reference(
        *(jnp.asarray(a) for a in args), 1e-8, npx=npx))
    assert got.shape == (O, d, 128)
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


@pytest.mark.parametrize("d", [27, 75, 147])
def test_kernel_dims(d):
    """The CUDA solve kernel is built for patch radius 1 and 2; radius 3
    (a thread's column of W or Q would be 148 floats of registers) is
    refused with its ROADMAP item."""
    if d in ts.KERNEL_DIMS:
        ts.check_kernel_dim(d)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ts.check_kernel_dim(d)


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


@pytest.mark.parametrize("dp", [28, 76])
def test_reseat_order_is_one_sweep_cycle(dp):
    """reseat_order is the TPU kernel's re-seating (the concatenation of
    solve_filter_pallas.py:184-187, written out on row labels): a
    permutation that keeps row 0 and moves the other rows along one cycle
    of length dp - 1, the round-robin order of a Brent-Luk sweep, at K2's
    dp = 28 and solve_filter's dp = 76 (d = 75)."""
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


@pytest.mark.parametrize("form", ["solve_filter", "solve_matrices"])
def test_schedule_d75_matches_twins(form):
    """The kernels' fp32 schedule at d = 75 (the Jacobi as a function of d,
    6 sweeps, 16 pixels) against the float64 twins, within the kernels'
    2e-4 (about 4e-6 here): the model the card's solve_filter and lane
    solve_matrices are held to."""
    npx, d = 25, 75
    m2, msum, nov, n, C, mask, noise, m = _moment_inputs(
        np.random.default_rng(21), O=121, d=d, npx=npx, P=16)
    if form == "solve_filter":
        pm = [t for t in _t(C.transpose(2, 0, 1), mask.T, noise.T, n[0],
                            m.T)]
        got = ts.solve_filter_pm_schedule(*pm, 1e-8, npx, 6)
        want = ts.solve_filter_pm_plain(*pm, 1e-8, npx)
        assert got.shape == want.shape == (16, 121, d)
        assert _rms(got, want) < 2e-4
    else:
        got = ts.solve_matrices_schedule(*_t(m2, msum, nov, n), 1e-8, npx, 6)
        want = ts.solve_matrices_plain(*_t(m2, msum, nov, n), 1e-8, npx)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert _rms(g, w) < 2e-4


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
