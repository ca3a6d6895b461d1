"""The port's candidate-stack engine at patch radius 12 (d = 1875, the plain
twins on the CPU) against JAX's plain engine, on one tile.

At r = 12 the main path needs n >= d + 1 = 1,876 similar patches. b = 21
offers 1,849 offsets, so no center can take the main path there; b = 22
(2,025 offsets) is the smallest window that reaches the solve, and only
where at most 149 of a center's offsets fall outside the patch-valid region
or are dissimilar. The 64x64 scene of the r = 11 test cannot get there (its
patch-valid region is 40 wide: 1,600 offsets at most); on the 68x68 scene
of the same generator (44 wide, 1,936 offsets at most under the 45-wide
window) the center (33, 33) keeps 44 rows and columns of its window, and
(32, 33) and (33, 32) keep 43 of one and 44 of the other (1,892 offsets).
They lie in 2x2 tile 560 (core rows and columns 32..33), whose fourth
center (32, 32) keeps 43 x 43 = 1,849, under 1,876: the floor below is
50%, and the tile is the smallest that holds them, since JAX's plain path
runs the exact eigh three times on every center of the tile.

The reference is JAX's ``denoise_tile`` on that one tile
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

R12_TILE = 2
R12_TILE_INDEX = 560
R12_MAIN_FLOOR = 0.50
R12_RMSE = 2e-4


@functools.lru_cache(maxsize=None)
def scene68():
    _, st = make_stats(np.random.default_rng(7), h=68, w=68, spp=16)
    return [np.asarray(st[k], np.float32)
            for k in ("mean", "nb_of_samples", "histo", "cov")]


def test_r12_b22_tile_matches_jax():
    """b = 22 on tile 560 of the 68x68 scene: a share of its centers takes
    the main path (the solve at d = 1875), and its contributions are JAX's
    ``denoise_tile``'s: the same counts, the estimates within R12_RMSE."""
    cfg = tmono.MonoscaleConfig(patch_radius=12, search_radius=22,
                                tile=R12_TILE)
    assert not cfg.fused and cfg.d == 1875
    slabs, ly, lx = tile_slabs(cfg, R12_TILE_INDEX, scene68)
    assert main_fraction(cfg, slabs, ly, lx, scene68) > R12_MAIN_FLOOR
    got = torch_tile(cfg, slabs, ly, lx, scene68)
    assert np.isfinite(got[0]).all()
    same_count, gap = tile_gap(got, jax_tile(cfg, slabs, ly, lx, scene68))
    assert same_count and gap < R12_RMSE
