"""The port's candidate-stack engine (bcd_tpu_torch/core/monoscale.py, the
patch radius r != 1 path, plain twins on the CPU) against the JAX plain
engine and the float64 oracle, on a scene where the r = 2 main path runs."""

import functools

import numpy as np
import pytest
import torch

from bcd_tpu_torch.convert import to_device, to_numpy
from bcd_tpu_torch.core import monoscale as tmono
from tests import reference_impl as oracle
from tests.test_ops_vs_oracle import make_stats
from tests.torch_workers import share_cores

share_cores()

CPU = torch.device("cpu")
# r = 2 needs n >= d + 1 = 76 similar patches for the main path; b = 5
# offers 121, and at this threshold 47% of the 20x20 scene's centers take
# the main path (61% is the most the window truncation at the borders
# allows)
R2_THRESHOLD = 2.25


def _padded(cfg, args):
    h = cfg.halo
    color, nb, histo, cov = (torch.from_numpy(a) for a in args)
    pad = functools.partial(tmono._pad_hw, top=h, bottom=h, left=h, right=h)
    return pad(color), pad(nb, fill=1.0), pad(histo), pad(cov)


def main_path_fraction(cfg, args, threshold):
    """Main-path centers over managed (main + fallback) centers."""
    height, width = args[0].shape[:2]
    main = managed = 0
    for _, (ly, lx), slabs in tmono.tile_batches(cfg, *_padded(cfg, args)):
        s = tmono.candidate_stacks(cfg, *slabs, ly, lx, ly, lx, height,
                                   width, height, width, threshold)
        main += int(s["main"].sum())
        managed += int((s["main"] | s["fb"]).sum())
    return main / managed


@functools.lru_cache(maxsize=None)
def scene20():
    """A 20x20 scene, its color rounded to half precision so that an EXR
    file holds it exactly."""
    _, st = make_stats(np.random.default_rng(7), h=20, w=20, spp=16)
    args = [np.asarray(st[k], np.float32)
            for k in ("mean", "nb_of_samples", "histo", "cov")]
    args[0] = args[0].astype(np.float16).astype(np.float32)
    return args


def jax_plain(args, radius, b, skip_stride=1):
    """JAX's plain XLA engine (``_denoise_image``, tile 8) with its exact
    ``jnp.linalg.eigh`` (``eigh_impl="lax"``), the eigh the port's twins
    use. Its default fixed-schedule Jacobi eigh gives the same result at
    r = 2 but takes about 40 s a call on a CPU core, against 3 s."""
    import jax.numpy as jnp
    from bcd_tpu.core.monoscale import MonoscaleConfig, _denoise_image

    cfg = MonoscaleConfig(patch_radius=radius, search_radius=b, tile=8,
                          skip_stride=skip_stride, eigh_impl="lax")
    return np.asarray(_denoise_image(
        cfg, *(jnp.asarray(a) for a in args), jnp.float32(R2_THRESHOLD),
        jnp.float32(1e-8)))


def torch_r2(skip_stride=1, tile=8):
    cfg = tmono.MonoscaleConfig(patch_radius=2, search_radius=5, tile=tile,
                                skip_stride=skip_stride)
    return to_numpy(tmono.denoise_image(
        cfg, *to_device(*scene20(), CPU), R2_THRESHOLD, 1e-8))


def rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def test_r2_scene_reaches_the_main_path():
    cfg = tmono.MonoscaleConfig(patch_radius=2, search_radius=5, tile=8)
    assert not cfg.fused
    assert main_path_fraction(cfg, scene20(), R2_THRESHOLD) > 1 / 3


def test_r2_engine_matches_jax():
    assert rmse(torch_r2(), jax_plain(scene20(), 2, 5)) < 2e-4


def test_r2_engine_matches_oracle():
    from bcd_tpu.params import DenoiserParameters

    ref = oracle.denoise_monoscale(*scene20(), DenoiserParameters(
        patch_radius=2, search_window_radius=5,
        histogram_distance_threshold=R2_THRESHOLD))
    assert rmse(torch_r2(tile=16), ref) < 1e-4


@pytest.mark.parametrize("radius,stride,size", [(1, 2, 14), (2, 3, 14)])
def test_skip_stride_matches_jax(radius, stride, size):
    """Only the centers on the stride grid are solved: r = 1 through the
    fused engine, r = 2 through the candidate-stack engine, each against
    JAX's plain path at the same stride."""
    _, st = make_stats(np.random.default_rng(40 + radius), h=size, w=size,
                       spp=16)
    args = [np.asarray(st[k], np.float32)
            for k in ("mean", "nb_of_samples", "histo", "cov")]
    b = 3 if radius == 1 else 5
    ref = jax_plain(args, radius, b, skip_stride=stride)
    cfg = tmono.MonoscaleConfig(patch_radius=radius, search_radius=b,
                                tile=16, skip_stride=stride)
    assert cfg.fused == (radius == 1)
    if radius == 2:
        assert main_path_fraction(cfg, args, R2_THRESHOLD) > 0.1
    got = to_numpy(tmono.denoise_image(cfg, *to_device(*args, CPU),
                                       R2_THRESHOLD, 1e-8))
    full = to_numpy(tmono.denoise_image(
        tmono.MonoscaleConfig(patch_radius=radius, search_radius=b, tile=16),
        *to_device(*args, CPU), R2_THRESHOLD, 1e-8))
    assert rmse(got, ref) < 2e-4
    assert rmse(got, full) > 1e-3  # the stride changed the result
    assert np.isfinite(got).all() and (got > 0).all()


@pytest.mark.parametrize("skip_stride", [1, 3])
def test_distance_masks_match_jax_with_zero_counts(skip_stride):
    """A tile whose sample counts hold zeros: JAX's plain path has no guard
    against the zero chi^2 denominator (monoscale.py:278-280), and neither
    has the port's, so the masks agree exactly, NaN distances included."""
    import jax.numpy as jnp
    from bcd_tpu.core.monoscale import MonoscaleConfig, _distance_masks

    t, r, b = 8, 2, 5
    h = r + b
    tp = t + 2 * h
    rng = np.random.default_rng(21)
    _, st = make_stats(rng, h=tp, w=tp, spp=16)
    histo = np.asarray(st["histo"], np.float32)
    nb = np.asarray(st["nb_of_samples"], np.float32)[..., 0]
    nb[rng.random(nb.shape) < 0.1] = 0.0
    assert (nb == 0).sum() > 10
    geom = (3, 2, 0, 0, t, t, 20, 20, R2_THRESHOLD)  # gy gx ly lx core hw
    ref, ref_cv = _distance_masks(
        MonoscaleConfig(patch_radius=r, search_radius=b, tile=t,
                        skip_stride=skip_stride),
        jnp.asarray(histo), jnp.asarray(nb), *geom)
    gy, gx, ly, lx = (torch.tensor([v]) for v in geom[:4])
    got, got_cv = tmono._distance_masks(
        tmono.MonoscaleConfig(patch_radius=r, search_radius=b, tile=t,
                              skip_stride=skip_stride),
        torch.from_numpy(histo)[None], torch.from_numpy(nb)[None],
        gy, gx, ly, lx, *geom[4:])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got_cv[0].numpy(), np.asarray(ref_cv))
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("tile", [8, 32])
def test_candidate_stacks_are_kernel_ready(tile):
    """The stacks ``solve_filter_pm`` reads in place on the card must be
    contiguous float32 in every batch, also a batch of one tile (tile 32
    covers the 20x20 scene in one), where the mask's reshape alone would be
    a strided view."""
    cfg = tmono.MonoscaleConfig(patch_radius=2, search_radius=5, tile=tile)
    height, width = scene20()[0].shape[:2]
    for _, (ly, lx), slabs in tmono.tile_batches(cfg, *_padded(cfg,
                                                               scene20())):
        s = tmono.candidate_stacks(cfg, *slabs, ly, lx, ly, lx, height,
                                   width, height, width, R2_THRESHOLD)
        for k in ("cand", "mask", "noise", "n", "m"):
            assert s[k].dtype == torch.float32 and s[k].is_contiguous(), k
