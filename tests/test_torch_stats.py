"""The port's DenoisingStatistics counters (``MonoscaleConfig.
collect_stats``, ``stats=`` on the drivers), phase timers and progress,
against the JAX package on the CPU. Kept apart from test_torch_engine.py,
the longest file of the suite, so that a separate test worker takes
them."""

import functools

import numpy as np
import pytest
import torch

from bcd_tpu import params as jparams
from bcd_tpu_torch import params as tparams
from bcd_tpu_torch.convert import to_device, to_numpy
from bcd_tpu_torch.core import monoscale as tmono
from tests.test_golden import _inputs
from tests.test_torch_engine import _stats
from tests.torch_workers import share_cores

share_cores()

CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def golden_crop():
    """A 14x14 crop of the golden inputs, its color rounded to half
    precision (an EXR file holds it exactly): at b = 3, 120 of its 144
    managed pixels take the r = 1 main path."""
    args = [np.ascontiguousarray(x[:14, :14]) for x in _inputs()]
    args[0] = args[0].astype(np.float16).astype(np.float32)
    return args


def _jax_counters(radius):
    """JAX's DenoisingStatistics counters and output: r = 1 through
    ``denoise_monoscale(stats=...)`` on the golden crop (b = 3), r = 2
    through ``_denoise_image`` with its exact eigh on the r = 2 scene
    (b = 5; the default Jacobi eigh takes about 40 s a call here)."""
    import jax.numpy as jnp
    from bcd_tpu.chrono import PhaseStats
    from bcd_tpu.core.monoscale import (MonoscaleConfig, _denoise_image,
                                        denoise_monoscale)
    from tests.test_torch_stack import R2_THRESHOLD, scene20

    if radius == 1:
        stats = PhaseStats()
        out = denoise_monoscale(*golden_crop(), jparams.DenoiserParameters(
            search_window_radius=3), tile=14, stats=stats)
        return dict(stats.counters), np.asarray(out)
    cfg = MonoscaleConfig(patch_radius=2, search_radius=5, tile=8,
                          collect_stats=True, eigh_impl="lax")
    out, counts = _denoise_image(cfg, *(jnp.asarray(a) for a in scene20()),
                                 jnp.float32(R2_THRESHOLD), jnp.float32(1e-8))
    main, fb = (int(x) for x in np.asarray(counts))
    return ({"pixels: main-path solves": main,
             "pixels: fallback (mean patch)": fb,
             "pixels: managed": main + fb}, np.asarray(out))


@pytest.mark.parametrize("radius", [1, 2])
def test_stats_counters_match_jax(radius):
    """The counters of both engines (fused K1 -> K2 -> K4 at r = 1, the
    candidate stacks at r = 2) equal JAX's; stats leave the output bitwise
    unchanged, and it agrees with JAX's within the engine bound."""
    from bcd_tpu_torch.chrono import PhaseStats
    from tests.test_torch_stack import R2_THRESHOLD, scene20

    params = tparams.DenoiserParameters(search_window_radius=3)
    args = golden_crop()
    if radius == 2:
        params = tparams.DenoiserParameters(
            patch_radius=2, search_window_radius=5,
            histogram_distance_threshold=R2_THRESHOLD)
        args = scene20()
    stats = PhaseStats()
    out = tmono.denoise_monoscale(*args, params, CPU, tile=8, stats=stats)
    plain = tmono.denoise_monoscale(*args, params, CPU, tile=8)
    assert torch.equal(out, plain)
    counters, ref = _jax_counters(radius)
    assert dict(stats.counters) == counters
    assert counters["pixels: main-path solves"] > 0
    h, w = args[0].shape[:2]
    assert counters["pixels: managed"] == (h - 2 * radius) * (w - 2 * radius)
    assert list(stats.timers) == [f"denoise {w}x{h}"]
    assert np.sqrt(np.mean((to_numpy(out) - ref) ** 2)) < 2e-4


def test_progress_is_monotone_and_ends_at_one():
    """Once per tile batch, in [0, 1], ending at 1.0, without changing the
    output; the multiscale driver maps each scale into its 4^s window."""
    from bcd_tpu_torch.core.multiscale import denoise_multiscale

    args = to_device(*_stats(np.random.default_rng(8), 20, 20), CPU)
    cfg = tmono.MonoscaleConfig(search_radius=2, tile=4, tile_batch=7)
    seen = []
    out = tmono.denoise_image(cfg, *args, 1.0, 1e-8, progress=seen.append)
    assert seen == [k / 4 for k in range(1, 5)]  # 25 tiles, 4 batches
    assert torch.equal(out, tmono.denoise_image(cfg, *args, 1.0, 1e-8))
    seen = []
    params = tparams.DenoiserParameters(search_window_radius=2)
    denoise_multiscale(*args, params, CPU, nb_of_scales=2, tile=4,
                       progress_callback=seen.append)
    assert seen == sorted(seen) and seen[0] == 0.0 and seen[-1] == 1.0
    # the fine scale's 25 tiles in one batch: its window [0.2, 1] is
    # reached from the coarse scale's end
    assert 0.2 in seen and all(0.0 <= p <= 1.0 for p in seen)


def test_pipeline_stats_phase_tree():
    """The phases of the default pipeline and the counters of its scales
    (main + fallback = managed = the interior pixels of every scale)."""
    from bcd_tpu_torch.chrono import PhaseStats
    from bcd_tpu_torch.core.pipeline import denoise_pipeline

    args = _stats(np.random.default_rng(11), 24, 20, spike=True)
    p = tparams.PipelineParameters()
    p.denoiser.monoscale.search_window_radius = 3
    stats = PhaseStats()
    out = denoise_pipeline(*args, CPU, p, stats=stats)
    assert torch.equal(out, denoise_pipeline(*args, CPU, p))
    assert set(stats.timers) == {"spike-removal prefilter", "pyramid build",
                                 "merge", "denoise 20x24", "denoise 10x12",
                                 "denoise 5x6"}
    c = stats.counters
    assert c["pixels: managed"] == 22 * 18 + 10 * 8 + 4 * 3
    assert (c["pixels: main-path solves"]
            + c["pixels: fallback (mean patch)"] == c["pixels: managed"])
    report = stats.report()
    assert "pixels: managed: 488" in report and "Chronometers:" in report
