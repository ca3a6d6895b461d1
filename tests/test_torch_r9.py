"""The port's candidate-stack engine at patch radius 9 (d = 1083, the plain
twins on the CPU) against JAX's plain engine, on one tile.

At r = 9 the main path needs n >= d + 1 = 1,084 similar patches. b = 15
offers 961 offsets, so no center can take the main path there; b = 16
(1,089 offsets) is the smallest window that reaches the solve, and only
where at most 5 of a center's offsets fall outside the patch-valid region
or are dissimilar: a window loses no row and no column. The 46x46 scene of
the r = 8 test cannot get there (its patch-valid region is 28 wide, under
the 33-wide window); on the 52x52 scene of the same generator (34 wide)
the 2x2 centers (25..26, 25..26) keep their whole window, and at this
threshold all 4 take the main path. They lie in 4x4 tile 84 (core rows
and columns 24..27), where 4 of the 16 managed centers take the main path:
the floor below is 20%.

JAX's plain path runs the exact eigh three times on every center of what
it denoises, so the reference is JAX's ``denoise_tile`` on that one tile,
the smallest that holds the main-path centers
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

R9_TILE = 4
R9_TILE_INDEX = 84
R9_MAIN_FLOOR = 0.20
R9_RMSE = 2e-4


@functools.lru_cache(maxsize=None)
def scene52():
    _, st = make_stats(np.random.default_rng(7), h=52, w=52, spp=16)
    return [np.asarray(st[k], np.float32)
            for k in ("mean", "nb_of_samples", "histo", "cov")]


def test_r9_b16_tile_matches_jax():
    """b = 16 on tile 84 of the 52x52 scene: a share of its centers takes
    the main path (the solve at d = 1083), and its contributions are JAX's
    ``denoise_tile``'s: the same counts, the estimates within R9_RMSE."""
    cfg = tmono.MonoscaleConfig(patch_radius=9, search_radius=16,
                                tile=R9_TILE)
    assert not cfg.fused and cfg.d == 1083
    slabs, ly, lx = tile_slabs(cfg, R9_TILE_INDEX, scene52)
    assert main_fraction(cfg, slabs, ly, lx, scene52) > R9_MAIN_FLOOR
    got = torch_tile(cfg, slabs, ly, lx, scene52)
    assert np.isfinite(got[0]).all()
    same_count, gap = tile_gap(got, jax_tile(cfg, slabs, ly, lx, scene52))
    assert same_count and gap < R9_RMSE
