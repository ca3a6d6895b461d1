"""The port's candidate-stack engine at patch radius 8 (d = 867, the plain
twins on the CPU) against JAX's plain engine, on one tile.

At r = 8 the main path needs n >= d + 1 = 868 similar patches. b = 14
offers 841 offsets, so no center can take the main path there; b = 15
(961 offsets) is the smallest window that reaches the solve, and only
where at most 93 of a center's offsets fall outside the patch-valid
region or are dissimilar. The 40x40 scene of the r = 6 and 7 tests cannot
get there: its patch-valid region is 24 wide, so a window holds at most
576 offsets. On the 46x46 scene of the same generator (30 wide, at most
900 offsets) 8 of the 64 managed centers of 8x8 tile 14 (core rows and
columns 16..23) take the main path at this threshold: the floor below is
10%.

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

R8_TILE = 8
R8_TILE_INDEX = 14
R8_MAIN_FLOOR = 0.10
R8_RMSE = 2e-4


@functools.lru_cache(maxsize=None)
def scene46():
    _, st = make_stats(np.random.default_rng(7), h=46, w=46, spp=16)
    return [np.asarray(st[k], np.float32)
            for k in ("mean", "nb_of_samples", "histo", "cov")]


def test_r8_b15_tile_matches_jax():
    """b = 15 on tile 14 of the 46x46 scene: a share of its centers takes
    the main path (the solve at d = 867), and its contributions are JAX's
    ``denoise_tile``'s: the same counts, the estimates within R8_RMSE."""
    cfg = tmono.MonoscaleConfig(patch_radius=8, search_radius=15,
                                tile=R8_TILE)
    assert not cfg.fused and cfg.d == 867
    slabs, ly, lx = tile_slabs(cfg, R8_TILE_INDEX, scene46)
    assert main_fraction(cfg, slabs, ly, lx, scene46) > R8_MAIN_FLOOR
    got = torch_tile(cfg, slabs, ly, lx, scene46)
    assert np.isfinite(got[0]).all()
    same_count, gap = tile_gap(got, jax_tile(cfg, slabs, ly, lx, scene46))
    assert same_count and gap < R8_RMSE
