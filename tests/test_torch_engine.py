"""The port's engine (bcd_tpu_torch/core, plain twins on the CPU) against the
JAX engine, the committed goldens, and module-level parity of the plain
ops (cov3x3, resample, spike removal)."""

import functools
import os

import numpy as np
import pytest
import torch

from bcd_tpu.io import image_io
from bcd_tpu import params as jparams
from bcd_tpu_torch import params as tparams
from bcd_tpu_torch.convert import to_device, to_numpy
from bcd_tpu_torch.core import monoscale as tmono
from tests.test_golden import GOLDEN_DIR, _inputs, rmse
from tests.test_ops_vs_oracle import make_stats
from tests.torch_workers import share_cores

share_cores()

CPU = torch.device("cpu")


def _stats(rng, h, w, spike=False):
    _, st = make_stats(rng, h=h, w=w, spp=16, spike=spike)
    return [np.asarray(st[k], np.float32)
            for k in ("mean", "nb_of_samples", "histo", "cov")]


def _jax_image(cfg, args):
    import jax.numpy as jnp
    from bcd_tpu.core.monoscale import _denoise_image

    return np.asarray(_denoise_image(
        cfg, *(jnp.asarray(a) for a in args), jnp.float32(1.0),
        jnp.float32(1e-8)))


def _torch_image(cfg, args):
    return to_numpy(tmono.denoise_image(cfg, *to_device(*args, CPU), 1.0,
                                        1e-8))


@pytest.fixture(scope="module")
def scene14x12():
    return _stats(np.random.default_rng(1234), 14, 12)


@pytest.mark.parametrize("use_fused", [False, True])
def test_monoscale_matches_jax(scene14x12, use_fused):
    from bcd_tpu.core.monoscale import MonoscaleConfig

    ref = _jax_image(MonoscaleConfig(search_radius=3, tile=16 if use_fused
                                     else 8, use_fused=use_fused),
                     scene14x12)
    got = _torch_image(tmono.MonoscaleConfig(search_radius=3, tile=16),
                       scene14x12)
    assert np.sqrt(np.mean((got - ref) ** 2)) < 2e-4


def test_tile_grid_invariance():
    """Non-divisible image sizes: partial edge tiles, and tile batches that
    split the grid, contribute identically whatever the tile size."""
    args = _stats(np.random.default_rng(5), 13, 18)
    a = _torch_image(tmono.MonoscaleConfig(search_radius=2, tile=16), args)
    b = _torch_image(tmono.MonoscaleConfig(search_radius=2, tile=32), args)
    c = _torch_image(tmono.MonoscaleConfig(search_radius=2, tile=8,
                                           tile_batch=3), args)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scales,golden", [(1, "out_mono_b6.exr"),
                                           (2, "out_multi2_b6.exr")])
def test_goldens(scales, golden):
    from bcd_tpu_torch.core.multiscale import denoise_multiscale

    mean, nb, histo, cov = _inputs()
    ref = image_io.load_multi_channels_exr(os.path.join(GOLDEN_DIR, golden))
    params = tparams.DenoiserParameters(search_window_radius=6)
    if scales == 1:
        out = tmono.denoise_monoscale(mean, nb, histo, cov, params, CPU,
                                      tile=16)
    else:
        out = denoise_multiscale(mean, nb, histo, cov, params, CPU,
                                 nb_of_scales=2, tile=16)
    assert rmse(to_numpy(out), ref) < 1e-4


@functools.lru_cache(maxsize=None)
def prefilter_scene():
    """The 24x20 scene with a firefly, its color rounded to half precision
    so that an EXR file holds it exactly, and the JAX pipeline's output on
    it with the default flags but b=3 (-p 1, 3 scales). Shared with the
    CLI test, so the JAX pipeline runs once a process."""
    from bcd_tpu.core.pipeline import denoise_pipeline as jax_pipeline

    args = _stats(np.random.default_rng(11), 24, 20, spike=True)
    args[0] = args[0].astype(np.float16).astype(np.float32)
    p = jparams.PipelineParameters()
    p.denoiser.monoscale.search_window_radius = 3
    return args, np.asarray(jax_pipeline(*args, p))


def test_pipeline_with_prefilter_matches_jax():
    """The default pipeline (-p 1, 3 scales) on a scene with a firefly."""
    from bcd_tpu_torch.core.pipeline import denoise_pipeline

    args, ref = prefilter_scene()
    tp = tparams.PipelineParameters()
    tp.denoiser.monoscale.search_window_radius = 3
    got = to_numpy(denoise_pipeline(*args, CPU, tp))
    assert got.shape == (24, 20, 3)
    assert np.sqrt(np.mean((got - ref) ** 2)) < 2e-4


def test_unported_options_raise():
    """Every engine option is carried now: the DenoisingStatistics
    counters (collect_stats), other radii and skip_stride."""
    assert tmono.MonoscaleConfig(collect_stats=True).collect_stats
    assert not tmono.MonoscaleConfig(patch_radius=2, skip_stride=5).fused
    assert tmono.MonoscaleConfig(skip_stride=3).fused


@pytest.mark.parametrize("radius,stride", [(1, 0), (1, 4), (2, 6), (0, 1)])
def test_out_of_range_options_raise(radius, stride):
    """skip_stride must lie in [1, 2r + 1] (bcd_tpu/core/monoscale.py:200),
    and the patch radius be at least 1."""
    with pytest.raises(ValueError):
        tmono.MonoscaleConfig(patch_radius=radius, skip_stride=stride)


# ---------------------------------------------------------------------------
# module parity with the JAX ops
# ---------------------------------------------------------------------------


def test_cov3x3_matches_jax():
    import jax.numpy as jnp
    from bcd_tpu.ops import cov3x3 as jcov
    from bcd_tpu_torch.ops import cov3x3 as tcov

    rng = np.random.default_rng(3)
    c6 = rng.standard_normal((4, 9, 6)).astype(np.float32)
    mat = tcov.cov6_to_mat3(torch.from_numpy(c6))
    np.testing.assert_array_equal(mat.numpy(),
                                  np.asarray(jcov.cov6_to_mat3(jnp.asarray(c6))))
    np.testing.assert_array_equal(
        tcov.blockdiag_expand(mat).numpy(),
        np.asarray(jcov.blockdiag_expand(jnp.asarray(mat.numpy()))))


@pytest.mark.parametrize("shape", [(12, 10), (13, 11)])
def test_resample_matches_jax(shape):
    import jax.numpy as jnp
    from bcd_tpu.ops import resample as jres
    from bcd_tpu_torch.ops import resample as tres

    rng = np.random.default_rng(shape[0])
    img = rng.random(shape + (3,)).astype(np.float32)
    nb = (rng.random(shape + (1,)) * 8 + 1).astype(np.float32)
    cov = rng.standard_normal(shape + (6,)).astype(np.float32)
    low = rng.random((shape[0] // 2, shape[1] // 2, 3)).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (tres.downscale_sum(t(img)), jres.downscale_sum(jnp.asarray(img))),
        (tres.downscale_average(t(img)),
         jres.downscale_average(jnp.asarray(img))),
        (tres.downscale_sample_covariance_sum(t(cov), t(nb)),
         jres.downscale_sample_covariance_sum(jnp.asarray(cov),
                                              jnp.asarray(nb))),
        (tres.merge_outputs(t(img), t(low)),
         jres.merge_outputs(jnp.asarray(img), jnp.asarray(low))),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


def test_spike_removal_matches_jax():
    import jax.numpy as jnp
    from bcd_tpu.ops.spike_removal import spike_removal as jspike
    from bcd_tpu_torch.ops.spike_removal import spike_removal

    args = _stats(np.random.default_rng(2), 12, 10, spike=True)
    args[0][0, 0] = 30.0  # a corner spike: clamped-center window
    ref = jspike(*(jnp.asarray(a) for a in args), 2.0)
    got = spike_removal(*(torch.from_numpy(a) for a in args), 2.0)
    assert not np.array_equal(np.asarray(ref[0]), args[0])  # spikes found
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
