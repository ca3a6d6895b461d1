"""The port's candidate-stack engine at patch radius 11 (d = 1587, the plain
twins on the CPU) against JAX's plain engine, on one tile.

At r = 11 the main path needs n >= d + 1 = 1,588 similar patches. b = 19
offers 1,521 offsets, so no center can take the main path there; b = 20
(1,681 offsets) is the smallest window that reaches the solve, and only
where at most 93 of a center's offsets fall outside the patch-valid region
or are dissimilar. The 58x58 scene of the r = 10 test cannot get there (its
patch-valid region is 36 wide, under the 41-wide window); on the 64x64
scene of the same generator (42 wide) the 2x2 centers (31..32, 31..32)
keep their whole window, and the centers around them that lose at most
two of its rows and columns in all keep enough. The 4x4 tile 119 (core
rows and columns 28..31) holds 6 of them, (31, 31), (30..31, 30..31) and
(29, 31), (31, 29), among its 16 managed centers at this threshold: the
floor below is 30%.

JAX's plain path runs the exact eigh three times on every center of what
it denoises, so the reference is JAX's ``denoise_tile`` on that one tile
(``tests/test_torch_r7.jax_tile``: ``eigh_impl="lax"``, one OpenBLAS
thread, in a child process), against the port's ``denoise_tiles`` on the
same slabs."""

import functools

import numpy as np

from bcd_tpu_torch.core import monoscale as tmono
from tests.test_ops_vs_oracle import make_stats
from tests.test_torch_r7 import (jax_tile, main_fraction, tile_gap,
                                 tile_slabs, torch_tile)
from tests.torch_workers import share_cores

share_cores()

R11_TILE = 4
R11_TILE_INDEX = 119
R11_MAIN_FLOOR = 0.30
R11_RMSE = 2e-4


@functools.lru_cache(maxsize=None)
def scene64():
    _, st = make_stats(np.random.default_rng(7), h=64, w=64, spp=16)
    return [np.asarray(st[k], np.float32)
            for k in ("mean", "nb_of_samples", "histo", "cov")]


def test_r11_b20_tile_matches_jax():
    """b = 20 on tile 119 of the 64x64 scene: a share of its centers takes
    the main path (the solve at d = 1587), and its contributions are JAX's
    ``denoise_tile``'s: the same counts, the estimates within R11_RMSE."""
    cfg = tmono.MonoscaleConfig(patch_radius=11, search_radius=20,
                                tile=R11_TILE)
    assert not cfg.fused and cfg.d == 1587
    slabs, ly, lx = tile_slabs(cfg, R11_TILE_INDEX, scene64)
    assert main_fraction(cfg, slabs, ly, lx, scene64) > R11_MAIN_FLOOR
    got = torch_tile(cfg, slabs, ly, lx, scene64)
    assert np.isfinite(got[0]).all()
    same_count, gap = tile_gap(got, jax_tile(cfg, slabs, ly, lx, scene64))
    assert same_count and gap < R11_RMSE
