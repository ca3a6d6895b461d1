"""The port's candidate-stack engine at patch radius 5 (d = 363, the plain
twins on the CPU) against JAX's plain engine.

At r = 5 the main path needs n >= d + 1 = 364 similar patches. The default
search radius b = 6 offers 169 offsets and b = 9 361, so no center can take
the main path there and every one takes the mean-patch fallback; b = 10
(441 offsets) is the smallest window that reaches the solve. On the 32x32
scene the window truncation at the borders lets 40 of the 484 managed
centers (8.3%) see 364 candidates, and at this threshold all of them take
the main path: the floor below is 5%. At b = 9 the window itself is too
small, wherever the center lies.

JAX's plain path (its exact eigh on every center of the scene, about a
minute on one core) is the reference."""

import functools

import numpy as np
import torch

from bcd_tpu_torch.convert import to_device, to_numpy
from bcd_tpu_torch.core import monoscale as tmono
from tests.test_ops_vs_oracle import make_stats
from tests.test_torch_stack import (R2_THRESHOLD, jax_plain,
                                    main_path_fraction, rmse)
from tests.torch_workers import share_cores

share_cores()

CPU = torch.device("cpu")
R5_MAIN_FLOOR = 0.05


@functools.lru_cache(maxsize=None)
def scene32():
    _, st = make_stats(np.random.default_rng(7), h=32, w=32, spp=16)
    return [np.asarray(st[k], np.float32)
            for k in ("mean", "nb_of_samples", "histo", "cov")]


def torch_r5(b):
    cfg = tmono.MonoscaleConfig(patch_radius=5, search_radius=b, tile=8)
    return to_numpy(tmono.denoise_image(
        cfg, *to_device(*scene32(), CPU), R2_THRESHOLD, 1e-8))


def test_r5_b10_engine_matches_jax():
    """b = 10: a share of the centers takes the main path (the solve at
    d = 363), and the whole image is within 2e-4 of JAX's
    ``_denoise_image``."""
    cfg = tmono.MonoscaleConfig(patch_radius=5, search_radius=10, tile=8)
    assert not cfg.fused and cfg.d == 363
    assert main_path_fraction(cfg, scene32(), R2_THRESHOLD) > R5_MAIN_FLOOR
    got = torch_r5(10)
    assert np.isfinite(got).all()
    assert rmse(got, jax_plain(scene32(), 5, 10)) < 2e-4


def test_r5_b9_takes_no_solve_and_matches_jax():
    """b = 9: 361 offsets, fewer than d + 1 = 364, so no center reaches the
    solve; the fallback-only image is JAX's within 2e-4."""
    cfg = tmono.MonoscaleConfig(patch_radius=5, search_radius=9, tile=8)
    assert len(tmono._offsets(cfg)) < cfg.d + 1
    assert main_path_fraction(cfg, scene32(), R2_THRESHOLD) == 0.0
    got = torch_r5(9)
    assert np.isfinite(got).all()
    assert rmse(got, jax_plain(scene32(), 5, 9)) < 2e-4
