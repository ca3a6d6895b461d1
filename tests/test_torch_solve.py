"""The port's K2 plain twin (bcd_tpu_torch/ops/solve_filter.py) against the
JAX solve: its XLA reference and the Pallas kernel in interpret mode."""

import numpy as np
import pytest
import torch

from bcd_tpu_torch.ops.solve_filter import MISC_CH, SMALL_CH, solve_matrices
from tests.test_solve_filter_pallas import _pm_inputs

D = 27


def _rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _torch_solve(m2_pm, misc):
    a2t, small = solve_matrices(torch.from_numpy(m2_pm),
                                torch.from_numpy(misc[:, :MISC_CH].copy()),
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
    small_r = small_r[:, :SMALL_CH]
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
    assert _rms(small, small_k[:, :SMALL_CH]) < 2e-4
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
