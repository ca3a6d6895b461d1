"""The port's solve twins (bcd_tpu_torch/ops/solve_filter.py) against the JAX
solves: K2 (solve_matrices_pm), the candidate-stack solve_filter and the
lane-form solve_matrices, each against its XLA reference and its Pallas
kernel in interpret mode."""

import numpy as np
import pytest
import torch

from bcd_tpu_torch.ops import solve_filter as ts
from tests.test_solve_filter_pallas import _moment_inputs, _pm_inputs, make_inputs

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
    (three 148 x 149 fp32 matrices, 264 KB) is refused with its ROADMAP
    item."""
    if d in ts.KERNEL_DIMS:
        ts.check_kernel_dim(d)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ts.check_kernel_dim(d)
