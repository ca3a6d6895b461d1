"""The port's candidate-stack engine at patch radius 6 (d = 507, the plain
twins on the CPU) against JAX's plain engine.

At r = 6 the main path needs n >= d + 1 = 508 similar patches. b = 10
offers 441 offsets, so no center can take the main path there and every
one takes the mean-patch fallback; b = 11 (529 offsets) is the smallest
window that reaches the solve, and only where a center's window lies
almost wholly inside the patch-valid region (508 of its 529 offsets). On
the 32x32 scene no center gets there; on the 40x40 scene of the same
generator 4.6% of the managed centers take the main path at this
threshold: the floor below is 3%.

JAX's plain path (its exact eigh on every center of the scene, one
OpenBLAS thread; about two minutes on the 40x40 scene) is the
reference."""

import functools

import numpy as np
import torch

from bcd_tpu_torch.convert import to_device, to_numpy
from bcd_tpu_torch.core import monoscale as tmono
from tests.test_ops_vs_oracle import make_stats
from tests.test_torch_r5 import scene32
from tests.test_torch_stack import (R2_THRESHOLD, jax_plain,
                                    main_path_fraction, rmse)
from tests.torch_workers import share_cores

share_cores()

CPU = torch.device("cpu")
R6_MAIN_FLOOR = 0.03


@functools.lru_cache(maxsize=None)
def scene40():
    _, st = make_stats(np.random.default_rng(7), h=40, w=40, spp=16)
    return [np.asarray(st[k], np.float32)
            for k in ("mean", "nb_of_samples", "histo", "cov")]


def torch_r6(scene, b):
    cfg = tmono.MonoscaleConfig(patch_radius=6, search_radius=b, tile=8)
    return to_numpy(tmono.denoise_image(
        cfg, *to_device(*scene, CPU), R2_THRESHOLD, 1e-8))


def test_r6_b11_engine_matches_jax():
    """b = 11 on the 40x40 scene: a share of the centers takes the main
    path (the solve at d = 507), and the whole image is within 2e-4 of
    JAX's ``_denoise_image``."""
    cfg = tmono.MonoscaleConfig(patch_radius=6, search_radius=11, tile=8)
    assert not cfg.fused and cfg.d == 507
    assert main_path_fraction(cfg, scene40(), R2_THRESHOLD) > R6_MAIN_FLOOR
    got = torch_r6(scene40(), 11)
    assert np.isfinite(got).all()
    assert rmse(got, jax_plain(scene40(), 6, 11)) < 2e-4


def test_r6_b10_takes_no_solve_and_matches_jax():
    """b = 10 on the 32x32 scene of the r = 5 tests: 441 offsets, fewer
    than d + 1 = 508, so no center reaches the solve; the fallback-only
    image is JAX's within 2e-4."""
    cfg = tmono.MonoscaleConfig(patch_radius=6, search_radius=10, tile=8)
    assert len(tmono._offsets(cfg)) < cfg.d + 1
    assert main_path_fraction(cfg, scene32(), R2_THRESHOLD) == 0.0
    got = torch_r6(scene32(), 10)
    assert np.isfinite(got).all()
    assert rmse(got, jax_plain(scene32(), 6, 10)) < 2e-4
