"""The port's CUDA kernels (K1, K2, K4, solve_filter at d = 27 and 75, its
shared-memory form at d = 147, 243, 363, 507, 675, 867, 1083, 1323, 1587
and 1875, its runtime-d form from d = 2187, the lane-form solve_matrices
at d = 27 and 75 and on the runtime-d kernel at every other d, and the
TPU-compiler probes' microbenchmarks) against their plain twins, and the
solve kernels against the plain fp32 model of their own schedule, on the
card. Run on a machine with an NVIDIA Hopper card:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Without a card every test skips (the decision is made in a fixture, so
every pytest worker collects the same tests)."""

import numpy as np
import pytest
import torch

from bcd_tpu_torch.core.monoscale import solve_filter_sweeps
from bcd_tpu_torch.ops import fused as tfused
from bcd_tpu_torch.ops.solve_filter import (
    D, MISC_CH, SMALL_CH, solve_filter, solve_filter_plain, solve_filter_pm,
    solve_filter_pm_big, solve_filter_pm_plain, solve_filter_pm_schedule,
    solve_matrices,
    solve_matrices_pm,
    solve_matrices_pm_plain, solve_matrices_pm_schedule, solve_matrices_plain,
    solve_matrices_schedule)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scene(rng, n, t, h, nbins):
    tp = t + 2 * h
    base = rng.random(nbins) * 4
    histo = base + 0.5 * rng.random((n, tp, tp, nbins))
    nb = rng.random((n, tp, tp, 1)) * 8 + 4
    color = rng.random((n, tp, tp, 3))
    pixcov = 0.01 * rng.standard_normal((n, tp, tp, 6))
    yy, xx = np.meshgrid(np.arange(tp), np.arange(tp), indexing="ij")
    interior = (yy >= 1) & (yy < tp - 1) & (xx >= 1) & (xx < tp - 1)
    core = (yy >= h) & (yy < h + t) & (xx >= h) & (xx < h + t)
    valid = np.broadcast_to(
        np.stack([interior & core, interior], -1), (n, tp, tp, 2))
    return [torch.tensor(np.ascontiguousarray(a, np.float32))
            for a in (histo, nb, color, pixcov, valid)]


def check_k1(cpu_args, thr, t, h, b, dev):
    """K1 kernel vs twin: masks may differ only where the distance lies
    within 1e-5 (relative) of the threshold; moments within rtol 2e-5 at
    centers whose masks all agree, n exact. Returns the mismatch count."""
    ref = tfused.masks_moments(*cpu_args, thr, t=t, h=h, b=b)
    got = [x.cpu() for x in tfused.masks_moments(
        *(a.to(dev) for a in cpu_args), thr, t=t, h=h, b=b)]
    dist = tfused.distances_plain(cpu_args[0], cpu_args[1], t, h, b)
    diff = got[0] != ref[0]
    near = (dist.reshape(diff.shape) - thr).abs() <= 1e-5 * max(thr, 1e-30)
    assert bool((~diff | near).all()), "mask mismatch away from threshold"
    same = ~diff.any(-1)
    np.testing.assert_allclose(got[1][same].numpy(), ref[1][same].numpy(),
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(got[2][same].numpy(), ref[2][same].numpy(),
                               rtol=2e-5, atol=1e-5)
    assert torch.equal(got[2][same][:, D + 54 :], ref[2][same][:, D + 54 :])
    return int(diff.sum())


@pytest.mark.parametrize("t,b,nbins", [(16, 2, 30), (32, 6, 60)])
def test_k1_kernel_matches_twin(cuda, t, b, nbins):
    h = b + 1
    args = _scene(np.random.default_rng(t + b), 2, t, h, nbins)
    check_k1(args, 0.25 if b == 2 else 1.0, t, h, b, cuda)


@pytest.mark.parametrize("t,b,zero_counts", [
    (64, 3, False), (40, 6, False), (32, 7, False), (16, 3, True),
    (32, 6, True), (24, 9, False)])
def test_k1_kernel_bands_and_zero_counts(cuda, t, b, zero_counts):
    """Tiles whose chi^2 band (the largest square one that fits shared
    memory, chi_band in csrc/masks_moments.cu) does not divide the tile, so
    the last bands are ragged: 22 x 22 of 64 at b = 3, 14 x 14 of 40 at
    b = 6, 11 x 11 of 32 at b = 7; and all-zero sample counts (every chi^2
    denominator is 0 and counts as 1)."""
    h = b + 1
    args = _scene(np.random.default_rng(7 * t + b), 2, t, h, 60)
    if zero_counts:
        args[1].zero_()
    check_k1(args, 1.0, t, h, b, cuda)


def _moments(rng, P, n_off=169):
    """Pixel-major moments of random candidate sets (K1's contract)."""
    C = rng.standard_normal((P, n_off, D))
    mask = rng.random((P, n_off)) < 0.7
    mask[:, n_off // 2] = True
    n = mask.sum(1)
    m2 = np.einsum("pok,pol->pkl", mask[..., None] * C, C)
    m2_pm = m2.reshape(P, D * D)[:, tfused._tri_pack(D)]
    misc = np.zeros((P, MISC_CH))
    misc[:, :D] = (mask[..., None] * C).sum(1)
    nov = np.zeros((P, 9, 6))
    nov[..., 0:3] = 0.05 + 0.1 * rng.random((P, 9, 3))
    nov[..., 3:6] = 0.01 * rng.standard_normal((P, 9, 3))
    misc[:, D : D + 54] = (nov * n[:, None, None]).reshape(P, 54)
    misc[:, D + 54] = n
    misc[:, D + 55] = rng.random(P) < 0.9
    return (torch.tensor(np.ascontiguousarray(m2_pm, np.float32)),
            torch.tensor(np.ascontiguousarray(misc, np.float32)))


def test_k2_kernel_matches_twin(cuda):
    m2, misc = _moments(np.random.default_rng(99), 512)
    a2t_r, small_r = solve_matrices_pm_plain(m2, misc, 1e-8)
    a2t, small = (x.cpu() for x in solve_matrices_pm(
        m2.to(cuda), misc.to(cuda), 1e-8, sweeps=6))
    rms = float(torch.sqrt(torch.mean((a2t - a2t_r) ** 2)))
    assert rms < 2e-4, rms
    rms = float(torch.sqrt(torch.mean((small - small_r) ** 2)))
    assert rms < 2e-4, rms
    assert torch.equal(small[:, D], small_r[:, D])
    assert torch.equal(small[:, 2 * D + 1], small_r[:, 2 * D + 1])


def test_k2_kernel_matches_schedule(cuda):
    """K2 against the plain fp32 model of its own schedule (the same
    rotations, re-seating, clamp and Cholesky arithmetic): rms 1e-5 at the
    engine's 4 sweeps (about 1e-7 on an H100), gates exact. A sharper probe
    of the lane and register-slot maps than the float64 twin's 2e-4."""
    m2, misc = _moments(np.random.default_rng(98), 512)
    a2t_m, small_m = solve_matrices_pm_schedule(m2, misc, 1e-8, 4)
    a2t, small = (x.cpu() for x in solve_matrices_pm(
        m2.to(cuda), misc.to(cuda), 1e-8, sweeps=4))
    assert float(torch.sqrt(torch.mean((a2t - a2t_m) ** 2))) < 1e-5
    assert float(torch.sqrt(torch.mean((small - small_m) ** 2))) < 1e-5
    assert torch.equal(small[:, D], small_m[:, D])
    assert torch.equal(small[:, 2 * D + 1], small_m[:, 2 * D + 1])


def test_k2_kernel_degenerate_gates(cuda):
    """Empty sets (n = 0), single samples (n = 1, zero moments) and
    rank-deficient moments (one candidate repeated, or 5 distinct ones, with
    n >= 28 on the main path): finite filters and the twin's exact gates."""
    rng = np.random.default_rng(6)
    m2, misc = _moments(rng, 128)
    m2[:32] = 0.0
    misc[:32, : D + 54] = 0.0
    misc[:16, D + 54] = 1.0
    misc[16:32, D + 54] = 0.0
    for lo, k, n in ((32, 1, 40), (48, 5, 30)):
        for p in range(lo, lo + 16):
            c = rng.standard_normal((k, D))
            reps = np.full(k, n // k)
            full = np.einsum("o,ok,ol->kl", reps, c, c)
            m2[p] = torch.tensor(full.reshape(-1)[tfused._tri_pack(D)])
            misc[p, :D] = torch.tensor(reps @ c)
            misc[p, D + 54] = n
            misc[p, D + 55] = 1.0
    _, small_r = solve_matrices_pm_plain(m2, misc, 1e-8)
    a2t, small = (x.cpu() for x in solve_matrices_pm(
        m2.to(cuda), misc.to(cuda), 1e-8, sweeps=4))
    assert bool(torch.isfinite(a2t).all() and torch.isfinite(small).all())
    assert torch.equal(small[:, D], small_r[:, D])
    assert torch.equal(small[:, 2 * D + 1], small_r[:, 2 * D + 1])
    assert bool((small[32:64, D] == 1).all())


def test_k2_kernel_degenerate_pixels_finite(cuda):
    m2, misc = _moments(np.random.default_rng(5), 128)
    m2[:32] = 0.0
    misc[:32, : D + 54] = 0.0
    misc[:16, D + 54] = 1.0
    misc[16:32, D + 54] = 0.0
    a2t, small = solve_matrices_pm(m2.to(cuda), misc.to(cuda), 1e-8,
                               sweeps=4)
    assert bool(torch.isfinite(a2t).all() and torch.isfinite(small).all())


@pytest.mark.parametrize("case,t,b", [
    ("mixed", 32, 6), ("mixed", 16, 2), ("mixed", 17, 2),
    ("no_main", 32, 6), ("fallback_only", 16, 3), ("mixed", 8, 9),
    ("mixed", 6, 17)])
def test_k4_kernel_matches_twin(cuda, case, t, b):
    """K4 against its twin: sums within atol/rtol 3e-5 (the kernel sums each
    source's filter before applying it), counts exact, bitwise repeatable.
    t = 17, b = 2 gives 21 candidate rows and columns, which neither the
    kernel's 2-row band nor its 4-column staging divides; "no_main" empties
    tile 0 (no main-path and no fallback center); "fallback_only" has no
    main-path center at all. b = 9 and b = 17 run in passes over blocks of
    the offsets (2 x 2 of width 11, 3 x 3 of width 13; the last ones
    ragged)."""
    h = b + 1
    rng = np.random.default_rng(3 + t + b)
    args = _scene(rng, 2, t, h, 60)
    masks, _, misc = tfused.masks_moments(*args, 1.0, t=t, h=h, b=b)
    cv = misc[..., D + 55]
    a2t = torch.tensor(rng.standard_normal((2, t * t, D * D)) * 0.1,
                       dtype=torch.float32)
    small = torch.zeros((2, t * t, SMALL_CH))
    small[..., :D] = torch.tensor(rng.standard_normal((2, t * t, D)),
                                  dtype=torch.float32)
    gate = (torch.tensor(rng.random((2, t * t)) < 0.6) & (cv > 0)).float()
    if case == "fallback_only":
        gate[:] = 0.0
    small[..., D] = gate
    fb = cv * (1 - gate)
    if case == "no_main":
        gate[0] = 0.0
        small[0, :, D] = 0.0
        fb[0] = 0.0
    small[..., D + 1 : 2 * D + 1] = fb[..., None] * torch.tensor(
        rng.standard_normal((2, t * t, D)), dtype=torch.float32)
    small[..., 2 * D + 1] = fb
    assert fb.any() and (gate.any() or case == "fallback_only")
    ref = tfused.apply_scatter(masks, a2t, small, args[2], t=t, h=h, b=b)
    dev_args = [x.to(cuda) for x in (masks, a2t, small, args[2])]
    got = tfused.apply_scatter(*dev_args, t=t, h=h, b=b).cpu()
    np.testing.assert_allclose(got[..., :3].numpy(), ref[..., :3].numpy(),
                               rtol=3e-5, atol=3e-5)
    assert torch.equal(got[..., 3], ref[..., 3])
    again = tfused.apply_scatter(*dev_args, t=t, h=h, b=b).cpu()
    assert torch.equal(got, again)  # fixed summation order, no atomics
    if case == "no_main":
        assert not bool(got[0].any())


# ---------------------------------------------------------------------------
# solve_filter and the lane-form solve_matrices (csrc/solve_filter.cu)
# ---------------------------------------------------------------------------


def _stack_inputs(rng, O, d, P):
    """Random candidate stacks in JAX's lane layout (the inputs of
    tests/test_solve_filter_pallas.py::make_inputs), with the raw moments
    the lane solve_matrices takes (a float64 batched product: numpy's
    einsum over (O, d, d, P) took minutes a call from d = 867)."""
    npx = d // 3
    C = rng.standard_normal((O, d, P))
    mask = (rng.random((O, P)) < 0.7).astype(np.float64)
    mask[O // 2] = 1.0
    n = mask.sum(axis=0, keepdims=True)
    m = (C * mask[:, None, :]).sum(axis=0) / n
    noise = np.zeros((npx, 6, P))
    noise[:, 0:3] = 0.05 + 0.1 * rng.random((npx, 3, P))
    noise[:, 3:6] = 0.01 * rng.standard_normal((npx, 3, P))
    noise = noise.reshape(6 * npx, P)
    mk = mask[:, None, :]
    Cp = torch.from_numpy(C).permute(2, 0, 1)  # (P, O, d)
    m2 = ((torch.from_numpy(mk).permute(2, 0, 1) * Cp).mT @ Cp).permute(
        1, 2, 0).numpy()
    msum = (mk * C).sum(axis=0)
    return {k: torch.tensor(np.ascontiguousarray(v, np.float32)) for k, v in
            dict(C=C, mask=mask, noise=noise, n=n, m=m, m2=m2, msum=msum,
                 nov=noise * n).items()}


def _degenerate(x):
    """Pixels 0-15: n = 1 with zero moments (pad lanes); 16-31: n = 0, an
    empty set; 32-47: every candidate masked out."""
    for k in ("C", "noise", "m", "m2", "msum", "nov"):
        x[k][..., :32] = 0.0
    x["n"][:, :16] = 1.0
    x["n"][:, 16:32] = 0.0
    x["mask"][:, 16:48] = 0.0
    return x


def _rms(a, b):
    return float(torch.sqrt(torch.mean((a.double() - b.double()) ** 2)))


@pytest.mark.parametrize("O,d", [(49, 27), (169, 75), (169, 147),
                                 (289, 243), (441, 363), (529, 507),
                                 (729, 675)])
def test_solve_filter_kernel_matches_twin(cuda, O, d):
    """At the engine's sweeps for d (6 at d = 27 and 75, 8 at d = 147, 243
    and 363, where the shared-memory kernel runs, and 9 at d = 507 and
    675). The float64 twin runs on the card too: on a host's cores its
    eigh at d = 675 took most of this file's time."""
    x = _degenerate(_stack_inputs(np.random.default_rng(d), O, d, 256))
    args = [x[k] for k in ("C", "mask", "noise", "n", "m")]
    ref = solve_filter_plain(*(a.to(cuda) for a in args), 1e-8,
                             npx=d // 3).cpu()
    got = solve_filter(*(a.to(cuda) for a in args), 1e-8, npx=d // 3,
                       sweeps=solve_filter_sweeps(d)).cpu()
    assert bool(torch.isfinite(got).all())
    assert bool((got[:, :, 16:48] == 0).all())
    assert _rms(got, ref) < 2e-4


@pytest.mark.parametrize("O,d", [(49, 27), (169, 75)])
def test_solve_matrices_kernel_matches_twin(cuda, O, d):
    """The lane form against its twin, and against solve_filter's kernel:
    field = mask (A2 c + b2)."""
    x = _degenerate(_stack_inputs(np.random.default_rng(d + 1), O, d, 256))
    npx = d // 3
    args = [x[k] for k in ("m2", "msum", "nov", "n")]
    ref = solve_matrices_plain(*args, 1e-8, npx=npx)
    got = [t.cpu() for t in solve_matrices(*(a.to(cuda) for a in args), 1e-8,
                                           npx=npx, sweeps=6)]
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert bool(torch.isfinite(g).all())
        assert _rms(g, r) < 2e-4
    field = solve_filter(*(x[k].to(cuda) for k in ("C", "mask", "noise", "n",
                                                   "m")),
                         1e-8, npx=npx, sweeps=6).cpu()
    a2 = got[0].permute(2, 1, 0)  # (P, j, k)
    want = x["mask"][:, None, :] * (
        torch.einsum("pjk,okp->ojp", a2, x["C"]) + got[1][0][None])
    assert _rms(field[..., 48:], want[..., 48:]) < 2e-4


@pytest.mark.parametrize("O,d", [(49, 27), (169, 75)])
def test_solve_kernels_match_schedule(cuda, O, d):
    """solve_filter and the lane solve_matrices against the plain fp32 model
    of their own schedule (solve_schedule_core: the same rotations,
    re-seating, clamp and Cholesky arithmetic), rms 1e-5 (about 2e-6 at
    d = 75 on an H100), with the degenerate pixels in the batch."""
    x = _degenerate(_stack_inputs(np.random.default_rng(d + 2), O, d, 256))
    npx = d // 3
    pm = [x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
          x["noise"].T.contiguous(), x["n"][0].contiguous(),
          x["m"].T.contiguous()]
    want = solve_filter_pm_schedule(*pm, 1e-8, npx, 6)
    got = solve_filter_pm(*(a.to(cuda) for a in pm), 1e-8, npx=npx,
                          sweeps=6).cpu()
    assert bool(torch.isfinite(got).all())
    assert _rms(got, want) < 1e-5
    args = [x[k] for k in ("m2", "msum", "nov", "n")]
    want = solve_matrices_schedule(*args, 1e-8, npx, 6)
    got = [t.cpu() for t in solve_matrices(*(a.to(cuda) for a in args), 1e-8,
                                           npx=npx, sweeps=6)]
    for g, w in zip(got, want):
        assert _rms(g[..., 48:], w[..., 48:]) < 1e-5


# the shared-memory kernel at d = 147 against the plain fp32 model of its
# schedule on 64 synthetic pixels: chip_smoke.py's limit for the same
# check on 1,024 pixels (its readings on an H100: 2.3e-6, 2.4e-6)
SMEM_MODEL_RMS = 1e-5


def test_solve_filter_smem_kernel_matches_schedule(cuda):
    """solve_filter_pm at d = 147 (csrc/solve_filter_smem.cu) against the
    fp32 model of its schedule, rms SMEM_MODEL_RMS, and against the
    float64 twin, rms 2e-4, on 64 synthetic pixels of 169 candidates at
    the engine's 8 sweeps; it launches the shared-memory kernel only."""
    from bcd_tpu_torch.ops import _build

    x = _stack_inputs(np.random.default_rng(147), 169, 147, 64)
    pm = [x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
          x["noise"].T.contiguous(), x["n"][0].contiguous(),
          x["m"].T.contiguous()]
    _build.reset_launches()
    got = solve_filter_pm(*(a.to(cuda) for a in pm), 1e-8, npx=49,
                          sweeps=8).cpu()
    assert _build.LAUNCHES["solve_filter_smem"] == 1
    assert _build.LAUNCHES["solve_filter"] == 0
    assert bool(torch.isfinite(got).all())
    assert _rms(got, solve_filter_pm_schedule(*pm, 1e-8, 49, 8)) \
        < SMEM_MODEL_RMS
    assert _rms(got, solve_filter_pm_plain(*pm, 1e-8, 49)) < 2e-4


def test_solve_filter_243_kernel_matches_schedule(cuda):
    """solve_filter_pm at d = 243 (csrc/solve_filter_smem.cu with 261 of the
    488 rows of W and Q in a global slot) against the fp32 model of its
    schedule, rms SMEM_MODEL_RMS, and against the float64 twin, rms 2e-4,
    on 64 synthetic pixels of 289 candidates at the engine's 8 sweeps; it
    launches the d = 243 kernel only."""
    from bcd_tpu_torch.ops import _build

    x = _stack_inputs(np.random.default_rng(243), 289, 243, 64)
    pm = [x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
          x["noise"].T.contiguous(), x["n"][0].contiguous(),
          x["m"].T.contiguous()]
    _build.reset_launches()
    got = solve_filter_pm(*(a.to(cuda) for a in pm), 1e-8, npx=81,
                          sweeps=solve_filter_sweeps(243)).cpu()
    assert _build.LAUNCHES["solve_filter_243"] == 1
    assert _build.LAUNCHES["solve_filter_smem"] == 0
    assert bool(torch.isfinite(got).all())
    assert _rms(got, solve_filter_pm_schedule(*pm, 1e-8, 81, 8)) \
        < SMEM_MODEL_RMS
    assert _rms(got, solve_filter_pm_plain(*pm, 1e-8, 81)) < 2e-4


# d = 363 on synthetic rows, where every pixel is rank-deficient (n < 364):
# at the engine's 8 sweeps the schedule is not converged there, and two
# fp32 summation orders part by about as much as each sits from the exact
# solve (chip_smoke.py, phase 9); the kernel is held to its model at 10
# sweeps, where the schedule has converged, within SMEM_MODEL_RMS
R5_MODEL_SWEEPS = 10


def test_solve_filter_363_kernel_matches_schedule(cuda):
    """solve_filter_pm at d = 363 (csrc/solve_filter_smem.cu with 580 of the
    728 rows of W and Q in a global slot) on 64 synthetic pixels of 441
    candidates: against the fp32 model of its schedule at R5_MODEL_SWEEPS,
    rms SMEM_MODEL_RMS, and against the float64 twin at the engine's 8
    sweeps, rms 2e-4; it launches the d = 363 kernel only."""
    from bcd_tpu_torch.ops import _build

    x = _stack_inputs(np.random.default_rng(363), 441, 363, 64)
    # the twin and the model run on the card too: at d = 363 the model's
    # 3,630 rounds take minutes on a host's cores
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    _build.reset_launches()
    got = solve_filter_pm(*pm, 1e-8, npx=121, sweeps=solve_filter_sweeps(363))
    assert _build.LAUNCHES["solve_filter_363"] == 1
    assert _build.LAUNCHES["solve_filter_243"] == 0
    assert _build.LAUNCHES["solve_filter_smem"] == 0
    assert bool(torch.isfinite(got).all())
    assert _rms(got, solve_filter_pm_plain(*pm, 1e-8, 121)) < 2e-4
    got = solve_filter_pm(*pm, 1e-8, npx=121, sweeps=R5_MODEL_SWEEPS)
    assert _rms(got, solve_filter_pm_schedule(*pm, 1e-8, 121,
                                              R5_MODEL_SWEEPS)) \
        < SMEM_MODEL_RMS


# d = 507, as d = 363: the synthetic pixels are rank-deficient (n < 508),
# and at the engine's 9 sweeps two fp32 summation orders of the model part
# by about 5e-6; from 10 sweeps on the schedule has converged (chip_smoke.py,
# phase 10)
R6_MODEL_SWEEPS = 11


def test_solve_filter_507_kernel_matches_schedule(cuda):
    """solve_filter_pm at d = 507 (csrc/solve_filter_smem.cu with 913 of the
    1,016 rows of W and Q in a global slot) on 64 synthetic pixels of 529
    candidates: against the fp32 model of its schedule at R6_MODEL_SWEEPS,
    rms SMEM_MODEL_RMS, and against the float64 twin at the engine's 9
    sweeps, rms 2e-4; it launches the d = 507 kernel only."""
    from bcd_tpu_torch.ops import _build

    x = _stack_inputs(np.random.default_rng(507), 529, 507, 64)
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    _build.reset_launches()
    got = solve_filter_pm(*pm, 1e-8, npx=169, sweeps=solve_filter_sweeps(507))
    assert _build.LAUNCHES["solve_filter_507"] == 1
    assert _build.LAUNCHES["solve_filter_363"] == 0
    assert _build.LAUNCHES["solve_filter_243"] == 0
    assert _build.LAUNCHES["solve_filter_smem"] == 0
    assert bool(torch.isfinite(got).all())
    assert _rms(got, solve_filter_pm_plain(*pm, 1e-8, 169)) < 2e-4
    got = solve_filter_pm(*pm, 1e-8, npx=169, sweeps=R6_MODEL_SWEEPS)
    assert _rms(got, solve_filter_pm_schedule(*pm, 1e-8, 169,
                                              R6_MODEL_SWEEPS)) \
        < SMEM_MODEL_RMS


# d = 675, as d = 507: on rank-deficient synthetic pixels (n < 676) the
# kernel is held to its model two sweeps past the engine's
R7_MODEL_SWEEPS = 11


def test_solve_filter_675_kernel_matches_schedule(cuda):
    """solve_filter_pm at d = 675 (csrc/solve_filter_smem.cu with 1,280 of
    the 1,352 rows of W and Q in a global slot) on 64 synthetic pixels of
    729 candidates: against the fp32 model of its schedule at
    R7_MODEL_SWEEPS, rms SMEM_MODEL_RMS, and against the float64 twin at
    the engine's sweeps, rms 2e-4; it launches the d = 675 kernel only."""
    from bcd_tpu_torch.ops import _build

    x = _stack_inputs(np.random.default_rng(675), 729, 675, 64)
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    _build.reset_launches()
    got = solve_filter_pm(*pm, 1e-8, npx=225, sweeps=solve_filter_sweeps(675))
    assert _build.LAUNCHES["solve_filter_675"] == 1
    assert sum(_build.LAUNCHES.values()) == 1, _build.LAUNCHES
    assert bool(torch.isfinite(got).all())
    assert _rms(got, solve_filter_pm_plain(*pm, 1e-8, 225)) < 2e-4
    got = solve_filter_pm(*pm, 1e-8, npx=225, sweeps=R7_MODEL_SWEEPS)
    assert _rms(got, solve_filter_pm_schedule(*pm, 1e-8, 225,
                                              R7_MODEL_SWEEPS)) \
        < SMEM_MODEL_RMS


def test_schedule_sweeps_at_d675(cuda):
    """Why the engine runs solve_filter_sweeps(675) sweeps at d = 675: the
    smallest count that keeps the fp32 schedule within 2e-5 rms of the
    float64 twin, as at d = 147 to 507, on 8 synthetic pixels of 729
    candidates. Read here, on the card, where the model's rounds take
    seconds (on a host's cores, about ten minutes)."""
    x = _stack_inputs(np.random.default_rng(21), 729, 675, 8)
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    want = solve_filter_pm_plain(*pm, 1e-8, 225)
    sweeps = solve_filter_sweeps(675)
    assert _rms(solve_filter_pm_schedule(*pm, 1e-8, 225, sweeps - 1),
                want) > 2e-5
    assert _rms(solve_filter_pm_schedule(*pm, 1e-8, 225, sweeps), want) \
        < 2e-5


# d = 867, as d = 675: the model two sweeps past the engine's
R8_MODEL_SWEEPS = solve_filter_sweeps(867) + 2


def test_solve_filter_867_kernel_matches_schedule(cuda):
    """solve_filter_pm at d = 867 (csrc/solve_filter_smem.cu with 1,683 of
    the 1,736 rows of W and Q in a global slot) on 64 synthetic pixels of
    961 candidates: against the fp32 model of its schedule at
    R8_MODEL_SWEEPS, rms SMEM_MODEL_RMS, and against the float64 twin at
    the engine's sweeps, rms 2e-4; it launches the d = 867 kernel only."""
    from bcd_tpu_torch.ops import _build

    x = _stack_inputs(np.random.default_rng(867), 961, 867, 64)
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    _build.reset_launches()
    got = solve_filter_pm(*pm, 1e-8, npx=289, sweeps=solve_filter_sweeps(867))
    assert _build.LAUNCHES["solve_filter_867"] == 1
    assert sum(_build.LAUNCHES.values()) == 1, _build.LAUNCHES
    assert bool(torch.isfinite(got).all())
    assert _rms(got, solve_filter_pm_plain(*pm, 1e-8, 289)) < 2e-4
    got = solve_filter_pm(*pm, 1e-8, npx=289, sweeps=R8_MODEL_SWEEPS)
    assert _rms(got, solve_filter_pm_schedule(*pm, 1e-8, 289,
                                              R8_MODEL_SWEEPS)) \
        < SMEM_MODEL_RMS


def test_schedule_sweeps_at_d867(cuda):
    """Why the engine runs solve_filter_sweeps(867) sweeps at d = 867: the
    smallest count that keeps the fp32 schedule within 2e-5 rms of the
    float64 twin, as at d = 147 to 675, on 8 synthetic pixels of 961
    candidates. Read on the card (on a host's cores the model would take
    about 20 minutes)."""
    x = _stack_inputs(np.random.default_rng(21), 961, 867, 8)
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    want = solve_filter_pm_plain(*pm, 1e-8, 289)
    sweeps = solve_filter_sweeps(867)
    rms = [_rms(solve_filter_pm_schedule(*pm, 1e-8, 289, s), want)
           for s in (sweeps - 1, sweeps)]
    print(f"d = 867: {sweeps - 1} sweeps {rms[0]:.3e}, {sweeps} {rms[1]:.3e} "
          "rms from the float64 twin")
    assert rms[0] > 2e-5 and rms[1] < 2e-5


# d = 1083, as d = 867: the model two sweeps past the engine's
R9_MODEL_SWEEPS = solve_filter_sweeps(1083) + 2


def test_solve_filter_1083_kernel_matches_schedule(cuda):
    """solve_filter_pm at d = 1083 (csrc/solve_filter_smem.cu with 2,128 of
    the 2,168 rows of W and Q in a global slot and nine pivot passes a
    round) on 32 synthetic pixels of 1,089 candidates: against the fp32
    model of its schedule at R9_MODEL_SWEEPS, rms SMEM_MODEL_RMS, and
    against the float64 twin at the engine's sweeps, rms 2e-4; it launches
    the d = 1083 kernel only. The first round's pairs of the ninth pass,
    seats (512 + p, 1054 + p), have non-zero pivots on every pixel: a lane
    forms those angles besides its first pass's, and pairs it skipped
    would leave the clamp far from the model."""
    from bcd_tpu_torch.ops import _build
    from bcd_tpu_torch.ops.solve_filter import _cemp, _noise_bd

    x = _stack_inputs(np.random.default_rng(1083), 1089, 1083, 32)
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    mk = pm[1][..., None]
    w = (_cemp(torch.einsum("poi,poj->pij", mk * pm[0], pm[0]), pm[4], pm[3])
         - _noise_bd(pm[2], 361))
    seats = torch.arange(512, 541, device=cuda)
    assert bool((w[:, seats, seats + 542] != 0).all())
    del w
    _build.reset_launches()
    got = solve_filter_pm(*pm, 1e-8, npx=361,
                          sweeps=solve_filter_sweeps(1083))
    assert _build.LAUNCHES["solve_filter_1083"] == 1
    assert sum(_build.LAUNCHES.values()) == 1, _build.LAUNCHES
    assert bool(torch.isfinite(got).all())
    assert _rms(got, solve_filter_pm_plain(*pm, 1e-8, 361)) < 2e-4
    got = solve_filter_pm(*pm, 1e-8, npx=361, sweeps=R9_MODEL_SWEEPS)
    assert _rms(got, solve_filter_pm_schedule(*pm, 1e-8, 361,
                                              R9_MODEL_SWEEPS)) \
        < SMEM_MODEL_RMS


def test_schedule_sweeps_at_d1083(cuda):
    """Why the engine runs solve_filter_sweeps(1083) sweeps at d = 1083:
    the smallest count that keeps the fp32 schedule within 2e-5 rms of the
    float64 twin, as at d = 147 to 867, on 8 synthetic pixels of 1,089
    candidates, read on the card."""
    x = _stack_inputs(np.random.default_rng(21), 1089, 1083, 8)
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    want = solve_filter_pm_plain(*pm, 1e-8, 361)
    sweeps = solve_filter_sweeps(1083)
    rms = [_rms(solve_filter_pm_schedule(*pm, 1e-8, 361, s), want)
           for s in (sweeps - 1, sweeps)]
    print(f"d = 1083: {sweeps - 1} sweeps {rms[0]:.3e}, {sweeps} "
          f"{rms[1]:.3e} rms from the float64 twin")
    assert rms[0] > 2e-5 and rms[1] < 2e-5


# d = 1323, as d = 1083: the model two sweeps past the engine's
R10_MODEL_SWEEPS = solve_filter_sweeps(1323) + 2


def test_solve_filter_1323_kernel_matches_schedule(cuda):
    """solve_filter_pm at d = 1323 (csrc/solve_filter_smem.cu with 2,618 of
    the 2,648 rows of W and Q in a global slot and eleven pivot passes a
    round) on 32 synthetic pixels of 1,369 candidates: against the fp32
    model of its schedule at R10_MODEL_SWEEPS, rms SMEM_MODEL_RMS, and
    against the float64 twin at the engine's sweeps, rms 2e-4; it launches
    the d = 1323 kernel only. The first round's pairs of the ninth to
    eleventh passes, seats (512 + p, 1174 + p) for p < 149 (p = 149 pairs
    the padding row), have non-zero pivots on every pixel: lanes 0-2 of a
    group form those angles besides their first pass's, and pairs they
    skipped would leave the clamp far from the model."""
    from bcd_tpu_torch.ops import _build
    from bcd_tpu_torch.ops.solve_filter import _cemp, _noise_bd

    x = _stack_inputs(np.random.default_rng(1323), 1369, 1323, 32)
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    mk = pm[1][..., None]
    w = (_cemp(torch.einsum("poi,poj->pij", mk * pm[0], pm[0]), pm[4], pm[3])
         - _noise_bd(pm[2], 441))
    seats = torch.arange(512, 661, device=cuda)
    assert bool((w[:, seats, seats + 662] != 0).all())
    del w
    _build.reset_launches()
    got = solve_filter_pm(*pm, 1e-8, npx=441,
                          sweeps=solve_filter_sweeps(1323))
    assert _build.LAUNCHES["solve_filter_1323"] == 1
    assert sum(_build.LAUNCHES.values()) == 1, _build.LAUNCHES
    assert bool(torch.isfinite(got).all())
    assert _rms(got, solve_filter_pm_plain(*pm, 1e-8, 441)) < 2e-4
    got = solve_filter_pm(*pm, 1e-8, npx=441, sweeps=R10_MODEL_SWEEPS)
    assert _rms(got, solve_filter_pm_schedule(*pm, 1e-8, 441,
                                              R10_MODEL_SWEEPS)) \
        < SMEM_MODEL_RMS


def test_schedule_sweeps_at_d1323(cuda):
    """Why the engine runs solve_filter_sweeps(1323) sweeps at d = 1323:
    the count keeps the fp32 schedule within 2e-5 rms of the float64 twin,
    as at d = 147 to 1083, on 8 synthetic pixels of 1,369 candidates, read
    on the card. One sweep fewer sits at that edge (1.874e-5 on an H100;
    at d = 1083 it passed it, 2.321e-5), far from the converged schedule
    (1.616e-6 at ten), so d = 1323 keeps the count of the step it shares
    with d = 1083, the smallest that holds at both."""
    x = _stack_inputs(np.random.default_rng(21), 1369, 1323, 8)
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    want = solve_filter_pm_plain(*pm, 1e-8, 441)
    sweeps = solve_filter_sweeps(1323)
    rms = [_rms(solve_filter_pm_schedule(*pm, 1e-8, 441, s), want)
           for s in (sweeps - 1, sweeps)]
    print(f"d = 1323: {sweeps - 1} sweeps {rms[0]:.3e}, {sweeps} "
          f"{rms[1]:.3e} rms from the float64 twin")
    assert sweeps == solve_filter_sweeps(1083)
    assert rms[0] > 1e-5 and rms[1] < 2e-5


# d = 1587, as d = 1323: the model two sweeps past the engine's
R11_MODEL_SWEEPS = solve_filter_sweeps(1587) + 2


def test_solve_filter_1587_kernel_matches_schedule(cuda):
    """solve_filter_pm at d = 1587 (csrc/solve_filter_smem.cu with 3,153 of
    the 3,176 rows of W and Q in a global slot and thirteen pivot passes a
    round) on 16 synthetic pixels of 1,681 candidates: against the fp32
    model of its schedule at R11_MODEL_SWEEPS, rms SMEM_MODEL_RMS, and
    against the float64 twin at the engine's sweeps, rms 2e-4; it launches
    the d = 1587 kernel only. The first round's pairs of the ninth to
    thirteenth passes, seats (512 + p, 1306 + p) for p < 281 (p = 281 pairs
    the padding row), have non-zero pivots on every pixel: lanes 0-4 of a
    group form those angles besides their first pass's."""
    from bcd_tpu_torch.ops import _build
    from bcd_tpu_torch.ops.solve_filter import _cemp, _noise_bd

    x = _stack_inputs(np.random.default_rng(1587), 1681, 1587, 16)
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    mk = pm[1][..., None]
    w = (_cemp(torch.einsum("poi,poj->pij", mk * pm[0], pm[0]), pm[4], pm[3])
         - _noise_bd(pm[2], 529))
    seats = torch.arange(512, 793, device=cuda)
    assert bool((w[:, seats, seats + 794] != 0).all())
    del w
    _build.reset_launches()
    got = solve_filter_pm(*pm, 1e-8, npx=529,
                          sweeps=solve_filter_sweeps(1587))
    assert _build.LAUNCHES["solve_filter_1587"] == 1
    assert sum(_build.LAUNCHES.values()) == 1, _build.LAUNCHES
    assert bool(torch.isfinite(got).all())
    assert _rms(got, solve_filter_pm_plain(*pm, 1e-8, 529)) < 2e-4
    got = solve_filter_pm(*pm, 1e-8, npx=529, sweeps=R11_MODEL_SWEEPS)
    assert _rms(got, solve_filter_pm_schedule(*pm, 1e-8, 529,
                                              R11_MODEL_SWEEPS)) \
        < SMEM_MODEL_RMS


def test_schedule_sweeps_at_d1587(cuda):
    """Why the engine runs solve_filter_sweeps(1587) sweeps at d = 1587:
    the smallest count that keeps the fp32 schedule within 2e-5 rms of the
    float64 twin, as at d = 147 to 1323, on 8 synthetic pixels of 1,681
    candidates, read on the card (an H100: nine 2.984e-5, ten 2.806e-6)."""
    x = _stack_inputs(np.random.default_rng(21), 1681, 1587, 8)
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    want = solve_filter_pm_plain(*pm, 1e-8, 529)
    sweeps = solve_filter_sweeps(1587)
    rms = [_rms(solve_filter_pm_schedule(*pm, 1e-8, 529, s), want)
           for s in (sweeps - 1, sweeps)]
    print(f"d = 1587: {sweeps - 1} sweeps {rms[0]:.3e}, {sweeps} "
          f"{rms[1]:.3e} rms from the float64 twin")
    assert rms[0] > 2e-5 and rms[1] < 2e-5


# d = 1875, as d = 1587: the model two sweeps past the engine's
R12_MODEL_SWEEPS = solve_filter_sweeps(1875) + 2


def test_solve_filter_1875_kernel_matches_schedule(cuda):
    """solve_filter_pm at d = 1875 (csrc/solve_filter_smem.cu with 3,735 of
    the 3,752 rows of W and Q in a global slot and fifteen pivot passes a
    round) on 8 synthetic pixels of 2,025 candidates: against the fp32
    model of its schedule at R12_MODEL_SWEEPS, rms SMEM_MODEL_RMS, and
    against the float64 twin at the engine's sweeps, rms 2e-4; it launches
    the d = 1875 kernel only. The first round's pairs of the ninth to
    fifteenth passes, seats (512 + p, 1450 + p) for p < 425 (p = 425 pairs
    the padding row), have non-zero pivots on every pixel: lanes 0-6 of a
    group form those angles besides their first pass's."""
    from bcd_tpu_torch.ops import _build
    from bcd_tpu_torch.ops.solve_filter import _cemp, _noise_bd

    x = _stack_inputs(np.random.default_rng(1875), 2025, 1875, 8)
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    mk = pm[1][..., None]
    w = (_cemp(torch.einsum("poi,poj->pij", mk * pm[0], pm[0]), pm[4], pm[3])
         - _noise_bd(pm[2], 625))
    seats = torch.arange(512, 937, device=cuda)
    assert bool((w[:, seats, seats + 938] != 0).all())
    del w
    _build.reset_launches()
    got = solve_filter_pm(*pm, 1e-8, npx=625,
                          sweeps=solve_filter_sweeps(1875))
    assert _build.LAUNCHES["solve_filter_1875"] == 1
    assert sum(_build.LAUNCHES.values()) == 1, _build.LAUNCHES
    assert bool(torch.isfinite(got).all())
    assert _rms(got, solve_filter_pm_plain(*pm, 1e-8, 625)) < 2e-4
    got = solve_filter_pm(*pm, 1e-8, npx=625, sweeps=R12_MODEL_SWEEPS)
    assert _rms(got, solve_filter_pm_schedule(*pm, 1e-8, 625,
                                              R12_MODEL_SWEEPS)) \
        < SMEM_MODEL_RMS


def test_schedule_sweeps_at_d1875(cuda):
    """Why the engine runs solve_filter_sweeps(1875) sweeps at d = 1875:
    the smallest count that keeps the fp32 schedule within 2e-5 rms of the
    float64 twin, as at d = 147 to 1587, on 8 synthetic pixels of 2,025
    candidates, read on the card (an H100: nine 3.591e-5, ten 3.277e-6)."""
    x = _stack_inputs(np.random.default_rng(21), 2025, 1875, 8)
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    want = solve_filter_pm_plain(*pm, 1e-8, 625)
    sweeps = solve_filter_sweeps(1875)
    rms = [_rms(solve_filter_pm_schedule(*pm, 1e-8, 625, s), want)
           for s in (sweeps - 1, sweeps)]
    print(f"d = 1875: {sweeps - 1} sweeps {rms[0]:.3e}, {sweeps} "
          f"{rms[1]:.3e} rms from the float64 twin")
    assert rms[0] > 2e-5 and rms[1] < 2e-5


@pytest.mark.parametrize("d", [75, 507])
def test_schedule_model_graph_is_its_rounds_op_by_op(cuda, d):
    """On the card the fp32 model's Jacobi replays one captured round as a
    CUDA graph (its rounds are bound by their launches op by op): the same
    kernels on the same buffers, so the same bits as the rounds run one
    operation at a time."""
    from bcd_tpu_torch.ops.solve_filter import _jacobi_fp32

    a = torch.randn(3, d, d, generator=torch.Generator().manual_seed(d))
    a = (a + a.mT).to(cuda)
    lam_g, q_g = _jacobi_fp32(a, 3)
    lam_e, q_e = _jacobi_fp32(a, 3, graphs=False)
    assert torch.equal(lam_g, lam_e) and torch.equal(q_g, q_e)


def _smem_scratch_floats(d, n_blocks):
    """``Smem<D>::SCRATCH`` times n_blocks, by the struct's formulas
    (csrc/solve_filter_smem.cu): Cemp, H and the rows of W and Q that
    shared memory does not hold."""
    dp, nov = d + d % 2, 6 * (d // 3)
    piv = 2 * dp if (d + 31) // 32 > 16 else 0
    vec = dp + (nov + 3) // 4 * 4 + 4 * dp + 4 * (dp // 2) + 2 * dp + piv
    rs = min((232448 // 4 - vec) // dp, 2 * dp)
    return n_blocks * (2 * dp * dp + (2 * dp - rs) * dp)


def test_smem_scratch_floats_is_a_64_bit_count(cuda):
    """The kernel's scratch size, a 64-bit count: 1,326,659,664 floats for
    132 blocks at d = 1587 (5.31 GB) and 1,854,020,784 at d = 1875
    (7.42 GB), the formula's; past 2^31 floats (300 blocks) still exact; -1
    for a d with no kernel."""
    from bcd_tpu_torch.ops import _build

    lib = _build.library()
    for d in (147, 243, 1323, 1587, 1875):
        for n_blocks in (1, 132, 300):
            assert lib.bcd_solve_filter_smem_scratch_floats(d, n_blocks) \
                == _smem_scratch_floats(d, n_blocks)
    assert _smem_scratch_floats(1587, 132) == 1326659664
    assert _smem_scratch_floats(1875, 132) == 1854020784
    assert lib.bcd_solve_filter_smem_scratch_floats(1587, 300) > 2 ** 31
    assert lib.bcd_solve_filter_smem_scratch_floats(2187, 132) == -1


@pytest.mark.parametrize("d", [75, 147, 243, 363, 507, 675, 867, 1083,
                               1323, 1587, 1875])
def test_solve_filter_pm_rows_in_place(cuda, d):
    """The engine's entry: with ``rows`` the kernel reads those pixels of the
    stacks in place and writes their fields, bit for bit those of the
    compact stacks; the other rows are 0."""
    x = _stack_inputs(np.random.default_rng(31),
                      {243: 289, 363: 441, 507: 529, 675: 729,
                       867: 961, 1083: 1089, 1323: 1369,
                       1587: 1681, 1875: 2025}.get(d, 169),
                      d, 64)
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    rows = torch.tensor([1, 5, 6, 40, 63], device=cuda)
    sweeps = solve_filter_sweeps(d)
    part = solve_filter_pm(*pm, 1e-8, npx=d // 3, sweeps=sweeps, rows=rows)
    compact = solve_filter_pm(*[v[rows].contiguous() for v in pm], 1e-8,
                              npx=d // 3, sweeps=sweeps)
    assert torch.equal(part[rows], compact)
    rest = torch.ones(64, dtype=torch.bool, device=cuda)
    rest[rows] = False
    assert not bool(part[rest].any())


def test_wrappers_count_only_launches(cuda):
    """A wrapper adds to its launch counter only where its kernel runs: an
    empty ``rows`` (no main-path center in the batch) and empty batches
    launch nothing and count nothing, and give the right empty or zero
    results."""
    from bcd_tpu_torch.ops import _build

    x = _stack_inputs(np.random.default_rng(32), 169, 75, 8)
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    _build.reset_launches()
    field = solve_filter_pm(*pm, 1e-8, npx=25, sweeps=6,
                            rows=torch.zeros(0, dtype=torch.long, device=cuda))
    assert field.shape == (8, 169, 75) and not bool(field.any())
    x3 = _stack_inputs(np.random.default_rng(33), 169, 147, 4)
    pm3 = [v.to(cuda) for v in (
        x3["C"].permute(2, 0, 1).contiguous(), x3["mask"].T.contiguous(),
        x3["noise"].T.contiguous(), x3["n"][0].contiguous(),
        x3["m"].T.contiguous())]
    field = solve_filter_pm(*pm3, 1e-8, npx=49, sweeps=8,
                            rows=torch.zeros(0, dtype=torch.long, device=cuda))
    assert field.shape == (4, 169, 147) and not bool(field.any())
    assert solve_filter_pm(*[v[:0] for v in pm3], 1e-8, npx=49,
                           sweeps=8).shape == (0, 169, 147)
    assert solve_filter_pm(*[v[:0] for v in pm], 1e-8, npx=25,
                           sweeps=6).shape == (0, 169, 75)
    a2t, small = solve_matrices_pm(torch.zeros((0, 378), device=cuda),
                                   torch.zeros((0, MISC_CH), device=cuda),
                                   1e-8, sweeps=4)
    assert a2t.shape == (0, D * D) and small.shape == (0, SMALL_CH)
    lane = solve_matrices(*(x[k][..., :0].contiguous().to(cuda)
                            for k in ("m2", "msum", "nov", "n")), 1e-8,
                          npx=25, sweeps=6)
    assert lane[0].shape == (75, 75, 0) and lane[1].shape == (1, 75, 0)
    t, b = 8, 2
    tp = t + 2 * (b + 1)
    empty = [torch.zeros((0, tp, tp, c), device=cuda) for c in (60, 1, 3, 6, 2)]
    masks, _, _ = tfused.masks_moments(*empty, 1.0, t=t, h=b + 1, b=b)
    out = tfused.apply_scatter(
        masks, torch.zeros((0, t * t, D * D), device=cuda),
        torch.zeros((0, t * t, SMALL_CH), device=cuda), empty[2], t=t,
        h=b + 1, b=b)
    assert out.shape == (0, tp, tp, 4)
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


def _pm_light(rng, O, d, P, cuda):
    """Pixel-major stacks (cand, mask, noise, n, m) on the card without the
    raw moments (at d = 77,763 those would take 145 GB)."""
    cand = torch.from_numpy(rng.standard_normal((P, O, d), np.float32))
    mask = torch.ones((P, O))
    n = mask.sum(1)
    noise = torch.full((P, 6 * (d // 3)), 0.05)
    return [v.to(cuda) for v in (cand, mask, noise, n, cand.mean(1))]


# a patch dimension the card's memory refuses: r = 80, whose runtime-d
# kernel's slot alone takes 96.8 GB a block (at r = 77 it takes 83.1 GB,
# which an H100 80GB's 85 GB would hold)
D_REFUSED = 3 * 161 ** 2


def test_solve_filter_pm_empty_rows_at_any_d(cuda):
    """No pixel to solve (a batch where no center reaches the main path):
    zeros and no launch, also at d = 77,763, whose one block of the solve
    kernel the card's memory cannot hold."""
    from bcd_tpu_torch.ops import _build

    pm = _pm_light(np.random.default_rng(1), 9, D_REFUSED, 3, cuda)
    _build.reset_launches()
    field = solve_filter_pm(*pm, 1e-8, npx=D_REFUSED // 3, sweeps=11,
                            rows=torch.zeros(0, dtype=torch.long, device=cuda))
    assert field.shape == (3, 9, D_REFUSED) and not bool(field.any())
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


def test_solve_filter_kernel_refuses_large_patches(cuda):
    """d = 77,763 (patch radius 80) with a pixel to solve: one block of the
    runtime-d kernel takes 96.8 GB, more than the card holds; refused with
    the bytes named, before any launch, by solve_filter and by the lane
    solve_matrices (on stride-0 views: its moments alone would take 24 GB a
    pixel); and the lane form at d = 147 runs, on the runtime-d kernel."""
    from bcd_tpu_torch.ops import _build

    pm = _pm_light(np.random.default_rng(0), 9, D_REFUSED, 2, cuda)
    _build.reset_launches()
    with pytest.raises(NotImplementedError, match="bytes"):
        solve_filter_pm(*pm, 1e-8, npx=D_REFUSED // 3, sweeps=11,
                        rows=torch.tensor([1], device=cuda))
    lane = [pm[0].permute(1, 2, 0).contiguous(), pm[1].T.contiguous(),
            pm[2].T.contiguous(), pm[3][None].contiguous(),
            pm[4].T.contiguous()]
    with pytest.raises(NotImplementedError, match="bytes"):
        solve_filter(*lane, 1e-8, npx=D_REFUSED // 3, sweeps=11)
    zero = torch.zeros(1, device=cuda)
    with pytest.raises(NotImplementedError, match="bytes"):
        solve_matrices(zero.expand(D_REFUSED, D_REFUSED, 2),
                       zero.expand(D_REFUSED, 2),
                       zero.expand(2 * D_REFUSED, 2), torch.ones(
                           (1, 2), device=cuda), 1e-8, npx=D_REFUSED // 3,
                       sweeps=11)
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
    x = {k: v.to(cuda) for k, v in
         _stack_inputs(np.random.default_rng(0), 9, 147, 2).items()}
    a2t, b2 = solve_matrices(*(x[k] for k in ("m2", "msum", "nov", "n")),
                             1e-8, npx=49, sweeps=8)
    assert a2t.shape == (147, 147, 2) and b2.shape == (1, 147, 2)
    assert _build.LAUNCHES["solve_matrices_big"] == 1


def test_solve_matrices_big_empty_makes_no_launch(cuda):
    """The lane form with no pixel (P = 0) at d = 147 and at d = 77,763,
    whose one block the card cannot hold: empty results, no launch, no
    refusal."""
    from bcd_tpu_torch.ops import _build

    _build.reset_launches()
    for d in (147, D_REFUSED):
        a2t, b2 = solve_matrices(
            torch.zeros((d, d, 0), device=cuda), torch.zeros((d, 0),
                                                             device=cuda),
            torch.zeros((2 * d, 0), device=cuda),
            torch.zeros((1, 0), device=cuda), 1e-8, npx=d // 3, sweeps=8)
        assert a2t.shape == (d, d, 0) and b2.shape == (1, d, 0)
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


def test_cli_refuses_radius_3_on_cuda(cuda, capsys):
    """Every patch radius runs on the card now; ``-w 45 -b 79``, where a
    center can reach the solve and one block of the solve kernel with a
    row of 32 centers' stack (80.4 GB) passes the card's memory, is refused
    before the inputs are read, with the bytes named, and nothing runs."""
    from bcd_tpu_torch import cli

    assert cli.main(["-i", "/nonexistent/x.exr", "-o", "y.exr", "-w",
                     "45", "-b", "79"]) == 1
    out = capsys.readouterr().out
    assert "bytes in all" in out and "card's" in out


# ---------------------------------------------------------------------------
# the runtime-d solve_filter (csrc/solve_filter_big.cu)
# ---------------------------------------------------------------------------


def _pm_of(x, cuda):
    return [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]


@pytest.mark.parametrize("O,d,model_sweeps", [(169, 147, 8), (441, 363, 10)])
def test_solve_filter_big_kernel_matches_smem_and_schedule(cuda, O, d,
                                                           model_sweeps):
    """The runtime-d kernel forced to d = 147 and 363 (its test-only entry
    ``solve_filter_pm_big``) on 8 synthetic pixels: at the engine's sweeps
    bit for bit the compiled ``Smem<147>`` and ``Smem<363>`` (the same
    pair arithmetic, pivot sums and reduction order), and against the fp32
    model of its schedule within SMEM_MODEL_RMS (at d = 363 two sweeps past
    the engine's, where the rank-deficient synthetic rows have converged:
    phase 9); it launches only its own kernel; in place on some rows it
    gives the compact call's bits."""
    from bcd_tpu_torch.ops import _build

    pm = _pm_of(_stack_inputs(np.random.default_rng(d), O, d, 8), cuda)
    sweeps = solve_filter_sweeps(d)
    _build.reset_launches()
    got = solve_filter_pm_big(*pm, 1e-8, npx=d // 3, sweeps=sweeps)
    assert _build.LAUNCHES["solve_filter_big"] == 1
    assert sum(_build.LAUNCHES.values()) == 1, _build.LAUNCHES
    assert torch.equal(got, solve_filter_pm(*pm, 1e-8, npx=d // 3,
                                            sweeps=sweeps))
    got = solve_filter_pm_big(*pm, 1e-8, npx=d // 3, sweeps=model_sweeps)
    assert _rms(got, solve_filter_pm_schedule(*pm, 1e-8, d // 3,
                                              model_sweeps)) < SMEM_MODEL_RMS
    rows = torch.tensor([1, 4, 6], device=cuda)
    part = solve_filter_pm_big(*pm, 1e-8, npx=d // 3, sweeps=sweeps,
                               rows=rows)
    assert torch.equal(part[rows], got[rows] if model_sweeps == sweeps else
                       solve_filter_pm_big(*[v[rows].contiguous()
                                             for v in pm], 1e-8,
                                           npx=d // 3, sweeps=sweeps))
    rest = torch.ones(8, dtype=torch.bool, device=cuda)
    rest[rows] = False
    assert not bool(part[rest].any())


def test_solve_filter_2187_kernel_matches_schedule(cuda):
    """solve_filter_pm at d = 2187 (the runtime-d kernel: 4,363 of the
    4,376 rows of W and Q in a global slot, eighteen pivot passes a round)
    on 4 synthetic pixels of 2,209 candidates: at the engine's sweeps
    against the float64 twin, rms 2e-4, and two sweeps past them against
    the fp32 model of its schedule on 2 of them, rms SMEM_MODEL_RMS, as at
    d = 1875; it launches the runtime-d kernel only. The first round's
    pairs of the ninth to eighteenth passes, seats (512 + p, 1606 + p) for
    p < 581 (p = 581 pairs the padding row), have non-zero pivots on every
    pixel: a lane forms the angles of passes k, k + 8 and k + 16."""
    from bcd_tpu_torch.ops import _build
    from bcd_tpu_torch.ops.solve_filter import _cemp, _noise_bd

    pm = _pm_of(_stack_inputs(np.random.default_rng(2187), 2209, 2187, 4),
                cuda)
    mk = pm[1][..., None]
    w = (_cemp(torch.einsum("poi,poj->pij", mk * pm[0], pm[0]), pm[4], pm[3])
         - _noise_bd(pm[2], 729))
    seats = torch.arange(512, 1093, device=cuda)
    assert bool((w[:, seats, seats + 1094] != 0).all())
    del w
    sweeps = solve_filter_sweeps(2187)
    _build.reset_launches()
    got = solve_filter_pm(*pm, 1e-8, npx=729, sweeps=sweeps)
    assert _build.LAUNCHES["solve_filter_big"] == 1
    assert sum(_build.LAUNCHES.values()) == 1, _build.LAUNCHES
    assert bool(torch.isfinite(got).all())
    e_t = _rms(got, solve_filter_pm_plain(*pm, 1e-8, 729))
    got = solve_filter_pm(*pm, 1e-8, npx=729, sweeps=sweeps + 2)
    e_m = _rms(got[:2], solve_filter_pm_schedule(*[v[:2] for v in pm], 1e-8,
                                                 729, sweeps + 2))
    print(f"d = 2187: {sweeps} sweeps vs the twin {e_t:.3e}, {sweeps + 2} "
          f"vs the fp32 model {e_m:.3e}")
    assert e_t < 2e-4 and e_m < SMEM_MODEL_RMS


def test_schedule_sweeps_at_d2187(cuda):
    """Why the engine runs solve_filter_sweeps(2187) sweeps at d = 2187:
    the smallest count that keeps the fp32 schedule within 2e-5 rms of the
    float64 twin, as at d = 147 to 1875, on 8 synthetic pixels of 2,209
    candidates, read on the card (an H100: nine 3.951e-05, ten 3.816e-06,
    eleven 1.826e-06)."""
    x = _stack_inputs(np.random.default_rng(21), 2209, 2187, 8)
    pm = _pm_of(x, cuda)
    want = solve_filter_pm_plain(*pm, 1e-8, 729)
    sweeps = solve_filter_sweeps(2187)
    rms = [_rms(solve_filter_pm_schedule(*pm, 1e-8, 729, s), want)
           for s in (sweeps - 1, sweeps, sweeps + 1)]
    print(f"d = 2187: {sweeps - 1} sweeps {rms[0]:.3e}, {sweeps} "
          f"{rms[1]:.3e}, {sweeps + 1} {rms[2]:.3e} rms from the float64 "
          "twin")
    assert rms[0] > 2e-5 and rms[1] < 2e-5


def test_big_scratch_floats_is_a_64_bit_count(cuda):
    """The runtime-d kernel's scratch, a 64-bit count: 2,523,963,024 floats
    for 132 blocks at d = 2187 (10.1 GB), past 2^31; -1 for a d it cannot
    lay out."""
    from bcd_tpu_torch.ops import _build

    lib = _build.library()
    assert lib.bcd_solve_filter_big_scratch_floats(2187, 132) \
        == 2_523_963_024 > 2 ** 31
    assert lib.bcd_solve_filter_big_scratch_floats(2187, 1) == 19_120_932
    assert lib.bcd_solve_filter_big_scratch_floats(2188, 1) == -1


def test_big_layout_entry_matches_the_formula(cuda):
    """The kernel's layout entry (no launch) at every patch radius 3 to 30
    is ``ops/solve_filter.big_layout``'s: shared bytes within a block's
    232,448, rows and vectors split between shared memory and the slot, the
    slot's floats 2 (d + 1)^2 + (global rows) (d + 1) + (global vector
    floats)."""
    import ctypes

    from bcd_tpu_torch.ops import _build
    from bcd_tpu_torch.ops.solve_filter import SMEM_BYTES, big_layout

    lib = _build.library()
    out = (ctypes.c_longlong * 6)()
    for r in range(3, 31):
        d = 3 * (2 * r + 1) ** 2
        assert lib.bcd_solve_filter_big_layout(d, out) == 0
        lay = big_layout(d)
        assert list(out) == [lay[k] for k in (
            "smem_bytes", "shared_rows", "global_rows", "shared_vectors",
            "global_vector_floats", "slot_floats")]
        assert out[0] <= SMEM_BYTES
        assert out[5] == 2 * (d + 1) ** 2 + out[2] * (d + 1) + out[4]
    assert lib.bcd_solve_filter_big_layout(2000, out) == -1


def test_solve_filter_big_matches_smem_at_d1875(cuda):
    """The runtime-d kernel forced to d = 1875 on 4 synthetic pixels of
    2,025 candidates, then ``Smem<1875>`` on the same pixels: bit for bit
    its field at the engine's sweeps, and each call's time (CUDA events,
    one after the other: launched beside each other on two streams, the
    second call's time held the first's; a call on a few pixels lasts a
    pixel's latency) for PERF.md's speed note."""
    pm = _pm_of(_stack_inputs(np.random.default_rng(1875), 2025, 1875, 4),
                cuda)
    sweeps = solve_filter_sweeps(1875)
    out, ms = {}, {}
    for name, fn in (("big", solve_filter_pm_big), ("smem", solve_filter_pm)):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out[name] = fn(*pm, 1e-8, npx=625, sweeps=sweeps)
        ev[1].record()
        torch.cuda.synchronize()
        ms[name] = ev[0].elapsed_time(ev[1])
    print(f"d = 1875 on 4 pixels at {sweeps} sweeps: the runtime-d kernel "
          f"{ms['big']:.3f} ms, Smem<1875> {ms['smem']:.3f} ms")
    assert torch.equal(out["big"], out["smem"])


def test_solve_filter_2187_wave_against_its_bound(cuda):
    """One wave of the persistent grid at d = 2187 (132 synthetic pixels of
    2,209 candidates, the engine's sweeps), timed once, beside its bound
    (``ops/bounds.solve_filter``): for PERF.md's table, too costly for the
    smoke (a pixel's latency is the wave's). Finite, and 2 of its pixels
    against the float64 twin within 2e-4."""
    import time

    from bcd_tpu_torch.ops import bounds

    pm = _pm_of(_stack_inputs(np.random.default_rng(2188), 2209, 2187, 132),
                cuda)
    sweeps = solve_filter_sweeps(2187)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = solve_filter_pm(*pm, 1e-8, npx=729, sweeps=sweeps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = solve_filter_pm_plain(*[v[:2] for v in pm], 1e-8, 729)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bound = bounds.solve_filter(132, 2209, 2187, sweeps)
    print(f"d = 2187 wave: 132 pixels at {sweeps} sweeps {ms:.3f} ms, bound "
          f"{bound[0]:.3f} ms ({bound[1]}), {ms / bound[0]:.1f}x; the twin "
          f"on 2 pixels {plain_ms:.3f} ms")
    assert bool(torch.isfinite(got).all())
    assert _rms(got[:2], want) < 2e-4


# ---------------------------------------------------------------------------
# the lane solve_matrices on the runtime-d kernel (bcd_solve_matrices_big)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("O,d,P,model_sweeps,consistent", [
    (289, 147, 4, 8, True), (625, 363, 4, 10, True),
    (2025, 1875, 2, 12, True), (2209, 2187, 2, 12, False)])
def test_solve_matrices_big_matches_twin_model_and_solve_filter(
        cuda, O, d, P, model_sweeps, consistent):
    """The lane solve_matrices at d = 147, 363, 1875 and 2187 on P synthetic
    pixels, the runtime-d kernel fed by the moments (one launch, counted as
    solve_matrices_big): at the engine's sweeps within 2e-4 rms of the
    float64 twin and, but at d = 2187 (a call lasts about 70 s there on an
    NVIDIA H100 80GB HBM3 at 700 W), its
    filter mask (A2 c + b2) within 2e-4 of solve_filter_pm_big's field on
    the same stack; at the sweeps the smoke holds solve_filter to at that d
    (two past the engine's from d = 363) within SMEM_MODEL_RMS of the fp32
    model of its schedule on 2 pixels (1 at d = 2187)."""
    from bcd_tpu_torch.ops import _build

    x = _stack_inputs(np.random.default_rng(d + 3), O, d, P)
    mom = [x[k].to(cuda) for k in ("m2", "msum", "nov", "n")]
    npx, sweeps = d // 3, solve_filter_sweeps(d)
    _build.reset_launches()
    got = solve_matrices(*mom, 1e-8, npx=npx, sweeps=sweeps)
    assert _build.LAUNCHES["solve_matrices_big"] == 1
    assert sum(_build.LAUNCHES.values()) == 1, _build.LAUNCHES
    assert all(bool(torch.isfinite(g).all()) for g in got)
    twin = solve_matrices_plain(*mom, 1e-8, npx=npx)
    e_t = max(_rms(g, r) for g, r in zip(got, twin))
    e_c = None
    if consistent:
        field = solve_filter_pm_big(*_pm_of(x, cuda), 1e-8, npx=npx,
                                    sweeps=sweeps).cpu()
        a2 = got[0].cpu().permute(2, 1, 0)  # (P, j, k)
        want = x["mask"][:, None, :] * (
            torch.einsum("pjk,okp->ojp", a2, x["C"]) + got[1].cpu()[0][None])
        e_c = _rms(field.permute(1, 2, 0), want)
    n_m = 1 if d == 2187 else 2
    got = solve_matrices(*mom, 1e-8, npx=npx, sweeps=model_sweeps)
    model = solve_matrices_schedule(*(v[..., :n_m] for v in mom), 1e-8, npx,
                                    model_sweeps)
    e_m = max(_rms(g[..., :n_m], w) for g, w in zip(got, model))
    print(f"lane solve_matrices d = {d}: {sweeps} sweeps vs the twin "
          f"{e_t:.3e}, its filter vs solve_filter_pm_big "
          f"{'not read' if e_c is None else f'{e_c:.3e}'}; "
          f"{model_sweeps} sweeps vs the fp32 model {e_m:.3e}")
    assert e_t < 2e-4 and (e_c is None or e_c < 2e-4)
    assert e_m < SMEM_MODEL_RMS


# ---------------------------------------------------------------------------
# the TPU-compiler probes' microbenchmarks (csrc/probes.cu)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [
    "probe_transpose_a", "probe_transpose_b", "probe_transpose_c",
    "probe_transpose_d", "probe_mosaic_aligned", "probe_mosaic_unaligned",
    "probe_banded_batched", "probe_banded_loop"])
def test_probe_variant_matches_its_plain_version(cuda, name):
    """Each probe variant at its script's shapes, one launch counted under
    its name, against its plain version: transpose B, C and D bit for bit,
    the others within fp32 rounding (``probes.FP32_REL`` of the largest
    magnitude); transpose A and D exact against float64 (the expansion and
    its transpose move values; A's products of exactly split TF32 parts
    each hold one non-zero term)."""
    from bcd_tpu_torch.ops import _build, probes

    (v,) = [v for v in probes.variants(cuda) if v.name == name]
    _build.reset_launches()
    got = v.run()
    assert _build.LAUNCHES[name] == 1
    assert sum(_build.LAUNCHES.values()) == 1, _build.LAUNCHES
    ok, err, limit = probes.held(v, got, v.plain())
    print(f"{name}: {probes.exactness(got, v.ref64())} vs float64; vs its "
          f"plain version {err:.3e} (limit {limit:.3e})")
    assert ok
    if name in ("probe_transpose_a", "probe_transpose_d"):
        assert probes.max_err(got, v.ref64()) == 0.0


def test_cli_accepts_radius_4_at_b6_on_cuda(cuda, tmp_path):
    """``bcd -w 4`` at the default b = 6 (169 offsets, fewer than the 244
    candidates the main path needs) runs on the card: every center takes
    the fallback, no solve kernel launches, and the output is the CPU
    run's within the goldens' rmse 1e-4."""
    _cli_fallback_only_matches_cpu(tmp_path, ["-w", "4"])


def test_cli_accepts_radius_6_at_b10_on_cuda(cuda, tmp_path):
    """``bcd -w 6 -b 10`` (441 offsets, fewer than the 508 candidates the
    d = 507 main path needs) runs on the card though no kernel is built
    for d = 507: every center takes the fallback, no solve kernel
    launches, and the output is the CPU run's within rmse 1e-4."""
    _cli_fallback_only_matches_cpu(tmp_path, ["-w", "6", "-b", "10"])


def test_cli_accepts_radius_9_at_b15_on_cuda(cuda, tmp_path):
    """``bcd -w 9 -b 15`` (961 offsets, fewer than the 1,084 candidates the
    d = 1083 main path needs) runs on the card: no solve kernel launches,
    and the output is the CPU run's within rmse 1e-4."""
    _cli_fallback_only_matches_cpu(tmp_path, ["-w", "9", "-b", "15"])


def test_cli_accepts_radius_10_at_b17_on_cuda(cuda, tmp_path):
    """``bcd -w 10 -b 17`` (1,225 offsets, fewer than the 1,324 candidates
    the d = 1323 main path needs) runs on the card: no solve kernel
    launches, and the output is the CPU run's within rmse 1e-4."""
    _cli_fallback_only_matches_cpu(tmp_path, ["-w", "10", "-b", "17"])


def test_cli_accepts_radius_11_at_b19_on_cuda(cuda, tmp_path):
    """``bcd -w 11 -b 19`` (1,521 offsets, fewer than the 1,588 candidates
    the d = 1587 main path needs) runs on the card: no solve kernel
    launches, and the output is the CPU run's within rmse 1e-4."""
    _cli_fallback_only_matches_cpu(tmp_path, ["-w", "11", "-b", "19"])


def test_cli_accepts_radius_12_at_b21_on_cuda(cuda, tmp_path):
    """``bcd -w 12 -b 21`` (1,849 offsets, fewer than the 1,876 candidates
    the d = 1875 main path needs) runs on the card: no solve kernel
    launches, and the output is the CPU run's within rmse 1e-4."""
    _cli_fallback_only_matches_cpu(tmp_path, ["-w", "12", "-b", "21"])


def _cli_fallback_only_matches_cpu(tmp_path, flags):
    from bcd_tpu_torch import cli
    from bcd_tpu_torch.io import image_io
    from bcd_tpu_torch.ops import _build

    color, nb, histo, cov = _golden_crop(32)
    image_io.write_exr(color, str(tmp_path / "in.exr"))
    image_io.write_multi_channels_exr(
        image_io.merge_histogram_and_nb_of_samples(histo, nb),
        str(tmp_path / "in_hist.exr"))
    image_io.write_multi_channels_exr(cov, str(tmp_path / "in_cov.exr"))
    outs = []
    for device in ("cuda", "cpu"):
        _build.reset_launches()
        out = str(tmp_path / f"out_{device}.exr")
        assert cli.main(["-i", str(tmp_path / "in.exr"), "-o", out, *flags,
                         "--device", device]) == 0
        assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
        outs.append(image_io.load_exr(out))
    assert np.isfinite(outs[0]).all()
    assert np.sqrt(np.mean((outs[0] - outs[1]) ** 2)) < 1e-4


def test_cli_radius_3_cuda_matches_cpu(cuda, tmp_path):
    """``bcd -w 3 -d 2.25`` (-p 1 -s 3, b = 6) on a 48x48 golden crop (2.5%
    of its finest-scale centers on the main path at this threshold): the card
    launches solve_filter_smem (and no r = 1 kernel) and its output is
    within the goldens' rmse 1e-4 of the CPU run's."""
    from bcd_tpu_torch import cli
    from bcd_tpu_torch.io import image_io
    from bcd_tpu_torch.ops import _build

    color, nb, histo, cov = _golden_crop(48)
    image_io.write_exr(color, str(tmp_path / "in.exr"))
    image_io.write_multi_channels_exr(
        image_io.merge_histogram_and_nb_of_samples(histo, nb),
        str(tmp_path / "in_hist.exr"))
    image_io.write_multi_channels_exr(cov, str(tmp_path / "in_cov.exr"))
    outs = []
    for device in ("cuda", "cpu"):
        _build.reset_launches()
        out = str(tmp_path / f"out_{device}.exr")
        assert cli.main(["-i", str(tmp_path / "in.exr"), "-o", out, "-w",
                         "3", "-d", "2.25", "--device", device]) == 0
        if device == "cuda":
            assert _build.LAUNCHES["solve_filter_smem"] > 0, _build.LAUNCHES
            assert _build.LAUNCHES["masks_moments"] == 0
        outs.append(image_io.load_exr(out))
    assert np.isfinite(outs[0]).all()
    assert np.sqrt(np.mean((outs[0] - outs[1]) ** 2)) < 1e-4


# ---------------------------------------------------------------------------
# the renderer-facing surface on the card
# ---------------------------------------------------------------------------


def _golden_crop(n):
    """An n x n crop of the golden inputs, read with the port's own EXR
    codec (this file runs where JAX is not installed)."""
    import os

    from bcd_tpu_torch.io import image_io

    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")

    def load(name):
        return image_io.load_multi_channels_exr(os.path.join(folder, name))

    histo, nb = image_io.separate_nb_of_samples_from_histogram(
        load("in_hist.exr"))
    return [np.ascontiguousarray(x[:n, :n])
            for x in (load("in_color.exr"), nb, histo, load("in_cov.exr"))]


def test_accumulator_cuda_matches_cpu_and_repeats(cuda):
    """Streamed row blocks on the card against the same on the host (nb
    exact, the rest within the CPU tests' tolerances against JAX), bitwise
    equal from run to run, and the one-shot form the same sums."""
    from bcd_tpu_torch.ops.accumulator import (SamplesAccumulator,
                                               accumulate_samples)

    rng = np.random.default_rng(21)
    samples = np.abs(rng.random((40, 33, 1, 4)) * 2
                     + 0.5 * rng.standard_normal((40, 33, 16, 4))
                     ).astype(np.float32)
    samples[0, :, :5, 0] = 1e3  # saturated
    samples[1, :, :5, 1] = np.float32(2.5 ** 2.2)  # on the last bin edge

    def streamed(device):
        acc = SamplesAccumulator(40, 33, device=device)
        for r0 in (32, 0, 16):
            acc.add_samples(samples[r0 : r0 + 16], row0=r0)
        return acc.extract_samples_statistics()

    host, a, b = streamed("cpu"), streamed(cuda), streamed(cuda)
    once = accumulate_samples(samples, device=cuda)
    tol = [(0, 0), (1e-5, 1e-6), (1e-4, 1e-5), (1e-4, 1e-4)]
    for x, y, z, ref, (rtol, atol) in zip(a, b, once, host, tol):
        assert x.device.type == "cuda"
        assert torch.equal(x, y)
        np.testing.assert_allclose(x.cpu().numpy(), ref.numpy(), rtol=rtol,
                                   atol=atol)
        np.testing.assert_allclose(z.cpu().numpy(), ref.numpy(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("radius", [1, 2])
def test_stats_counters_cuda_equal_cpu(cuda, radius):
    """The DenoisingStatistics counters of both engines on the card equal
    those of the CPU twins on a 32x32 golden crop (r = 1 at b = 6, r = 2
    at b = 5 and threshold 2.25), and stats leave the card's output
    bitwise unchanged."""
    from bcd_tpu_torch.chrono import PhaseStats
    from bcd_tpu_torch.core.monoscale import denoise_monoscale
    from bcd_tpu_torch.params import DenoiserParameters

    params = (DenoiserParameters() if radius == 1 else DenoiserParameters(
        patch_radius=2, search_window_radius=5,
        histogram_distance_threshold=2.25))
    args = _golden_crop(32)
    counters = []
    for device in ("cpu", cuda):
        stats = PhaseStats()
        out = denoise_monoscale(*args, params, device, stats=stats)
        counters.append(dict(stats.counters))
    assert torch.equal(out, denoise_monoscale(*args, params, cuda))
    assert counters[0] == counters[1]
    assert counters[1]["pixels: main-path solves"] > 0
    assert counters[1]["pixels: managed"] == (32 - 2 * radius) ** 2


def test_api_on_cuda_launches_the_kernels(cuda):
    """MultiscaleDenoiser (r = 1) launches K1, K2 and K4 and Denoiser at
    r = 2 launches solve_filter; both outputs within the goldens' rmse of
    the CPU twins'."""
    from bcd_tpu_torch.core.api import (Denoiser, DenoiserInputs,
                                        MultiscaleDenoiser)
    from bcd_tpu_torch.ops import _build
    from bcd_tpu_torch.params import DenoiserParameters

    args = _golden_crop(32)
    r2 = DenoiserParameters(patch_radius=2, search_window_radius=5,
                            histogram_distance_threshold=2.25)
    for make, params, kernels in (
            (lambda d: MultiscaleDenoiser(2, device=d), DenoiserParameters(),
             ("masks_moments", "solve_matrices_pm", "apply_scatter")),
            (lambda d: Denoiser(device=d), r2, ("solve_filter",))):
        outs = []
        for device in (cuda, "cpu"):
            den = make(device)
            den.set_inputs(DenoiserInputs(*args))
            den.set_parameters(params)
            _build.reset_launches()
            assert den.denoise()
            outs.append(den.get_outputs().denoised_colors)
            if device is cuda:
                assert all(_build.LAUNCHES[k] > 0 for k in kernels), \
                    _build.LAUNCHES
        assert outs[0].dtype == np.float32 and outs[0].shape == (32, 32, 3)
        assert np.sqrt(np.mean((outs[0] - outs[1]) ** 2)) < 1e-4


def test_api_and_batch_at_radius_3_match_the_cli_on_cuda(cuda, tmp_path):
    """The API and the batch CLI at a radius past 2 on the card:
    ``core/api.Denoiser`` and a one-frame ``--batch`` preset (patchRadius
    3, one scale, no prefilter, threshold 2.25) on a 48x48 golden crop's
    EXR files, each bit for bit ``bcd -w 3 -s 1 -p 0 -d 2.25`` on the same
    files (the CLI's output EXR holds half floats: the API's output is
    sanitized as the CLI's and rounded to half), each launching
    solve_filter_smem."""
    import json

    from bcd_tpu_torch import batch_cli, cli
    from bcd_tpu_torch.core.api import Denoiser, DenoiserInputs
    from bcd_tpu_torch.core.pipeline import sanitize_output
    from bcd_tpu_torch.io import image_io
    from bcd_tpu_torch.ops import _build
    from bcd_tpu_torch.params import DenoiserParameters

    color, nb, histo, cov = _golden_crop(48)
    src = str(tmp_path / "in.exr")
    image_io.write_exr(color, src)
    image_io.write_multi_channels_exr(
        image_io.merge_histogram_and_nb_of_samples(histo, nb),
        str(tmp_path / "in_hist.exr"))
    image_io.write_multi_channels_exr(cov, str(tmp_path / "in_cov.exr"))
    _build.reset_launches()
    assert cli.main(["-i", src, "-o", str(tmp_path / "cli.exr"), "-w", "3",
                     "-s", "1", "-p", "0", "-d", "2.25"]) == 0
    assert _build.LAUNCHES["solve_filter_smem"] > 0, _build.LAUNCHES
    want = image_io.load_exr(str(tmp_path / "cli.exr"))

    preset = tmp_path / "r3.bcd.json"
    preset.write_text(json.dumps({
        "patchRadius": 3, "nbOfScales": 1,
        "performSpikeRemovalPrefiltering": False,
        "histoDistanceThreshold": 2.25}))
    _build.reset_launches()
    assert batch_cli.main(["-a", str(preset), "-o", str(tmp_path / "out"),
                           "--batch", src]) == 0
    assert _build.LAUNCHES["solve_filter_smem"] > 0, _build.LAUNCHES
    got = image_io.load_exr(str(tmp_path / "out" / "in_BCDfiltered.exr"))
    np.testing.assert_array_equal(got, want)

    den = Denoiser(device=cuda)
    den.set_inputs(DenoiserInputs(*batch_cli.load_frame(src)))
    den.set_parameters(DenoiserParameters(
        patch_radius=3, histogram_distance_threshold=2.25))
    _build.reset_launches()
    assert den.denoise()
    assert _build.LAUNCHES["solve_filter_smem"] > 0, _build.LAUNCHES
    out = sanitize_output(torch.from_numpy(
        den.get_outputs().denoised_colors)).numpy()
    np.testing.assert_array_equal(out.astype(np.float16).astype(np.float32),
                                  want)
