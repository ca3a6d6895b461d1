"""Why the engine runs 9 Jacobi sweeps at d = 507 (patch radius 6), and
that no smaller d moves: the fp32 schedule of the solve kernels against
the float64 twin. A file of its own: the schedule's 4,563 rounds at
d = 507 take tens of seconds a call on a host's cores."""

import numpy as np
import pytest

from bcd_tpu_torch.core.monoscale import solve_filter_sweeps
from bcd_tpu_torch.ops import solve_filter as ts
from tests.test_torch_solve import _pm_stacks, _rms, _t
from tests.torch_workers import share_cores

share_cores()


def test_schedule_sweeps_at_d507():
    """The smallest count that keeps the fp32 schedule within 2e-5 rms of
    the float64 twin, as at d = 147 to 363: on 8 pixels of 529 candidates
    8 sweeps leave about 2.9e-5, 9 about 2.4e-6."""
    npx, d = 169, 507
    pm = _t(*(a for a in _pm_stacks(np.random.default_rng(21), 529, d, 8)))
    want = ts.solve_filter_pm_plain(*pm, 1e-8, npx)
    assert solve_filter_sweeps(d) == 9
    assert _rms(ts.solve_filter_pm_schedule(*pm, 1e-8, npx, 8), want) > 2e-5
    assert _rms(ts.solve_filter_pm_schedule(*pm, 1e-8, npx, 9), want) < 2e-5


@pytest.mark.parametrize("d,sweeps", [(27, 6), (75, 6), (147, 8), (243, 8),
                                      (363, 8), (507, 9), (675, 9),
                                      (867, 9), (1083, 10), (1323, 10),
                                      (1587, 10), (1875, 10), (2187, 10),
                                      (2523, 11), (11163, 11)])
def test_sweeps_by_patch_dimension(d, sweeps):
    """The engine's sweeps for each patch radius: 9 at d = 507, 675 and
    867, 10 at d = 1083, 1323, 1587, 1875 and 2187 (at d = 675 to 1083, at
    1587, 1875 and 2187 the smallest count within 2e-5 rms of the float64
    twin, read on the card:
    tests/test_torch_kernels_gpu.py::test_schedule_sweeps_at_d675,
    ::test_schedule_sweeps_at_d867, ::test_schedule_sweeps_at_d1083,
    ::test_schedule_sweeps_at_d1587, ::test_schedule_sweeps_at_d1875 and
    ::test_schedule_sweeps_at_d2187; at d = 1323 the smallest that holds
    there and at d = 1083, ::test_schedule_sweeps_at_d1323), and d = 27 to
    363 keep the counts their results were read at. Past d = 2187 (r = 14
    and up) no count was read: one sweep more than there."""
    assert solve_filter_sweeps(d) == sweeps
