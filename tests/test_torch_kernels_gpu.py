"""The port's CUDA kernels (K1, K2, K4, solve_filter and the lane-form
solve_matrices) against their plain twins, on the card. Run on a machine
with an NVIDIA Hopper card:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Without a card every test skips (the decision is made in a fixture, so
every pytest worker collects the same tests)."""

import numpy as np
import pytest
import torch

from bcd_tpu_torch.ops import fused as tfused
from bcd_tpu_torch.ops.solve_filter import (
    D, MISC_CH, SMALL_CH, solve_filter, solve_filter_plain, solve_matrices,
    solve_matrices_pm, solve_matrices_pm_plain, solve_matrices_plain)

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
    centers whose masks all agree. Returns the mismatch count."""
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
    return int(diff.sum())


@pytest.mark.parametrize("t,b,nbins", [(16, 2, 30), (32, 6, 60)])
def test_k1_kernel_matches_twin(cuda, t, b, nbins):
    h = b + 1
    args = _scene(np.random.default_rng(t + b), 2, t, h, nbins)
    check_k1(args, 0.25 if b == 2 else 1.0, t, h, b, cuda)


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


def test_k2_kernel_degenerate_pixels_finite(cuda):
    m2, misc = _moments(np.random.default_rng(5), 128)
    m2[:32] = 0.0
    misc[:32, : D + 54] = 0.0
    misc[:16, D + 54] = 1.0
    misc[16:32, D + 54] = 0.0
    a2t, small = solve_matrices_pm(m2.to(cuda), misc.to(cuda), 1e-8,
                               sweeps=4)
    assert bool(torch.isfinite(a2t).all() and torch.isfinite(small).all())


def test_k4_kernel_matches_twin(cuda):
    t, b = 32, 6
    h = b + 1
    rng = np.random.default_rng(3)
    args = _scene(rng, 2, t, h, 60)
    masks, _, misc = tfused.masks_moments(*args, 1.0, t=t, h=h, b=b)
    cv = misc[..., D + 55]
    a2t = torch.tensor(rng.standard_normal((2, t * t, D * D)) * 0.1,
                       dtype=torch.float32)
    small = torch.zeros((2, t * t, SMALL_CH))
    small[..., :D] = torch.tensor(rng.standard_normal((2, t * t, D)),
                                  dtype=torch.float32)
    gate = (torch.tensor(rng.random((2, t * t)) < 0.6) & (cv > 0)).float()
    small[..., D] = gate
    fb = cv * (1 - gate)
    small[..., D + 1 : 2 * D + 1] = fb[..., None] * torch.tensor(
        rng.standard_normal((2, t * t, D)), dtype=torch.float32)
    small[..., 2 * D + 1] = fb
    assert gate.any() and fb.any()
    ref = tfused.apply_scatter(masks, a2t, small, args[2], t=t, h=h, b=b)
    got = tfused.apply_scatter(masks.to(cuda), a2t.to(cuda), small.to(cuda),
                               args[2].to(cuda), t=t, h=h, b=b).cpu()
    np.testing.assert_allclose(got[..., :3].numpy(), ref[..., :3].numpy(),
                               rtol=3e-5, atol=3e-5)
    assert torch.equal(got[..., 3], ref[..., 3])
    again = tfused.apply_scatter(masks.to(cuda), a2t.to(cuda), small.to(cuda),
                                 args[2].to(cuda), t=t, h=h, b=b).cpu()
    assert torch.equal(got, again)  # gather form: bitwise deterministic


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
