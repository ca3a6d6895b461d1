"""The port's candidate-stack engine at patch radius 4 (d = 243, the plain
twins on the CPU) against JAX's plain engine.

At r = 4 the main path needs n >= d + 1 = 244 similar patches. The default
search radius b = 6 offers 169 offsets and b = 7 225, so no center can
take the main path there and every one takes the mean-patch fallback;
b = 8 (289 offsets) is the smallest window that reaches the solve. On the
28x28 scene the window truncation at the borders lets 52 of the 400
managed centers (13%) see 244 candidates, and at this threshold all of
them take the main path: the floor below is 10%.

JAX's plain path (its exact eigh) is the reference: the float64 oracle
``tests/reference_impl.py`` takes minutes on this scene."""

import functools

import numpy as np
import torch

from bcd_tpu_torch.convert import to_device, to_numpy
from bcd_tpu_torch.core import monoscale as tmono
from tests.test_ops_vs_oracle import make_stats
from tests.test_torch_stack import (R2_THRESHOLD, jax_plain,
                                    main_path_fraction, rmse, scene20)
from tests.torch_workers import share_cores

share_cores()

CPU = torch.device("cpu")
R4_MAIN_FLOOR = 0.1


@functools.lru_cache(maxsize=None)
def scene28():
    _, st = make_stats(np.random.default_rng(7), h=28, w=28, spp=16)
    return [np.asarray(st[k], np.float32)
            for k in ("mean", "nb_of_samples", "histo", "cov")]


def torch_r4(args, b):
    cfg = tmono.MonoscaleConfig(patch_radius=4, search_radius=b, tile=8)
    return to_numpy(tmono.denoise_image(
        cfg, *to_device(*args, CPU), R2_THRESHOLD, 1e-8))


def test_r4_b8_engine_matches_jax():
    """b = 8: a share of the centers takes the main path (the solve at
    d = 243), and the whole image is within 2e-4 of JAX's
    ``_denoise_image``."""
    cfg = tmono.MonoscaleConfig(patch_radius=4, search_radius=8, tile=8)
    assert not cfg.fused and cfg.d == 243
    assert main_path_fraction(cfg, scene28(), R2_THRESHOLD) > R4_MAIN_FLOOR
    got = torch_r4(scene28(), 8)
    assert np.isfinite(got).all()
    assert rmse(got, jax_plain(scene28(), 4, 8)) < 2e-4


def test_r4_b6_takes_no_solve_and_matches_jax():
    """b = 6: 169 offsets, fewer than d + 1 = 244, so no center reaches the
    solve; the fallback-only image is JAX's within 2e-4."""
    cfg = tmono.MonoscaleConfig(patch_radius=4, search_radius=6, tile=8)
    assert len(tmono._offsets(cfg)) < cfg.d + 1
    assert main_path_fraction(cfg, scene20(), R2_THRESHOLD) == 0.0
    got = torch_r4(scene20(), 6)
    assert np.isfinite(got).all()
    assert rmse(got, jax_plain(scene20(), 4, 6)) < 2e-4
