"""The port's candidate-stack engine at patch radius 3 (d = 147, the plain
twins on the CPU) against JAX's plain engine and the float64 oracle.

At r = 3 the main path needs n >= d + 1 = 148 similar patches, so the
search radius is 6 (169 offsets; b = 5 offers 121, and no center would
reach it). On the 20x20 scene the window truncation at the borders lets at
most 12 of the 196 managed centers (6.1%) see 148 candidates, and at this
threshold all 12 take the main path: the floor below is 5%, not the 1/3
of the r = 2 tests."""

import numpy as np
import torch

from bcd_tpu_torch.convert import to_device, to_numpy
from bcd_tpu_torch.core import monoscale as tmono
from tests import reference_impl as oracle
from tests.test_torch_stack import (R2_THRESHOLD, jax_plain,
                                    main_path_fraction, rmse, scene20)
from tests.torch_workers import share_cores

share_cores()

CPU = torch.device("cpu")
R3_MAIN_FLOOR = 0.05


def torch_r3(tile=8):
    cfg = tmono.MonoscaleConfig(patch_radius=3, search_radius=6, tile=tile)
    return to_numpy(tmono.denoise_image(
        cfg, *to_device(*scene20(), CPU), R2_THRESHOLD, 1e-8))


def test_r3_scene_reaches_the_main_path():
    cfg = tmono.MonoscaleConfig(patch_radius=3, search_radius=6, tile=8)
    assert not cfg.fused and cfg.d == 147
    assert main_path_fraction(cfg, scene20(), R2_THRESHOLD) > R3_MAIN_FLOOR


def test_r3_engine_matches_jax():
    """Against JAX's ``_denoise_image`` with its exact eigh, within 2e-4."""
    assert rmse(torch_r3(), jax_plain(scene20(), 3, 6)) < 2e-4


def test_r3_engine_matches_oracle():
    """Against the float64 oracle, within 1e-4."""
    from bcd_tpu.params import DenoiserParameters

    ref = oracle.denoise_monoscale(*scene20(), DenoiserParameters(
        patch_radius=3, search_window_radius=6,
        histogram_distance_threshold=R2_THRESHOLD))
    got = torch_r3(tile=16)
    assert np.isfinite(got).all()
    assert rmse(got, ref) < 1e-4
