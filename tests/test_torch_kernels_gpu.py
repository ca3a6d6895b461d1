"""The port's CUDA kernels (K1, K2, K4, solve_filter and the lane-form
solve_matrices) against their plain twins, and the solve kernels against
the plain fp32 model of their own schedule, on the card. Run on a machine
with an NVIDIA Hopper card:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Without a card every test skips (the decision is made in a fixture, so
every pytest worker collects the same tests)."""

import numpy as np
import pytest
import torch

from bcd_tpu_torch.ops import fused as tfused
from bcd_tpu_torch.ops.solve_filter import (
    D, MISC_CH, SMALL_CH, solve_filter, solve_filter_plain, solve_filter_pm,
    solve_filter_pm_schedule, solve_matrices, solve_matrices_pm,
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
    the lane solve_matrices takes."""
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
    m2 = np.einsum("okp,olp->klp", mk * C, C)
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


@pytest.mark.parametrize("O,d", [(49, 27), (169, 75)])
def test_solve_filter_kernel_matches_twin(cuda, O, d):
    x = _degenerate(_stack_inputs(np.random.default_rng(d), O, d, 256))
    args = [x[k] for k in ("C", "mask", "noise", "n", "m")]
    ref = solve_filter_plain(*args, 1e-8, npx=d // 3)
    got = solve_filter(*(a.to(cuda) for a in args), 1e-8, npx=d // 3,
                       sweeps=6).cpu()
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


def test_solve_filter_pm_rows_in_place(cuda):
    """The engine's entry: with ``rows`` the kernel reads those pixels of the
    stacks in place and writes their fields, bit for bit those of the
    compact stacks; the other rows are 0."""
    x = _stack_inputs(np.random.default_rng(31), 169, 75, 64)
    pm = [v.to(cuda) for v in (
        x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
        x["noise"].T.contiguous(), x["n"][0].contiguous(),
        x["m"].T.contiguous())]
    rows = torch.tensor([1, 5, 6, 40, 63], device=cuda)
    part = solve_filter_pm(*pm, 1e-8, npx=25, sweeps=6, rows=rows)
    compact = solve_filter_pm(*[v[rows].contiguous() for v in pm], 1e-8,
                              npx=25, sweeps=6)
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


def test_solve_filter_kernel_refuses_large_patches(cuda):
    d = 147  # patch radius 3
    x = {k: v.to(cuda) for k, v in
         _stack_inputs(np.random.default_rng(0), 9, d, 2).items()}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve_filter(*(x[k] for k in ("C", "mask", "noise", "n", "m")), 1e-8,
                     npx=d // 3, sweeps=6)


def test_cli_refuses_radius_3_on_cuda(cuda, capsys):
    """No kernel instantiation for d = 147: the CLI refuses before reading
    its inputs and never runs the twin."""
    from bcd_tpu_torch import cli

    assert cli.main(["-i", "/nonexistent/x.exr", "-o", "y.exr", "-w",
                     "3"]) == 1
    assert "ROADMAP" in capsys.readouterr().out


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
