"""The port's candidate-stack engine at patch radius 13 (d = 2187, the
plain twins on the CPU; on the card the runtime-d kernel
``csrc/solve_filter_big.cu``) against JAX's plain engine, on one tile.

At r = 13 the main path needs n >= d + 1 = 2,188 similar patches. b = 22
offers 2,025 offsets, so no center can take the main path there; b = 23
(2,209 offsets) is the smallest window that reaches the solve, and only
where at most 21 of a center's offsets fall outside the patch-valid region
or are dissimilar. A window that loses a row or a column of its 47 loses
47 offsets, so a center must keep the whole window: on the 74x74 scene of
the r = 12 test's generator (a 48-wide patch-valid region, rows and
columns 13..60) only the centers (36..37, 36..37) do. They make up 2x2 tile
684 (core rows and columns 36..37), which the floor below holds to half of
them reaching the solve; the tile is the smallest that holds them, since
JAX's plain path runs the exact eigh three times on every center of the
tile. A 73x73 scene has one such center, a 72x72 one none.

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

R13_TILE = 2
R13_TILE_INDEX = 684
R13_MAIN_FLOOR = 0.50
R13_RMSE = 2e-4


@functools.lru_cache(maxsize=None)
def scene74():
    _, st = make_stats(np.random.default_rng(7), h=74, w=74, spp=16)
    return [np.asarray(st[k], np.float32)
            for k in ("mean", "nb_of_samples", "histo", "cov")]


def test_r13_b23_tile_matches_jax():
    """b = 23 on tile 684 of the 74x74 scene: a share of its centers takes
    the main path (the solve at d = 2187), and its contributions are JAX's
    ``denoise_tile``'s: the same counts, the estimates within R13_RMSE."""
    cfg = tmono.MonoscaleConfig(patch_radius=13, search_radius=23,
                                tile=R13_TILE)
    assert not cfg.fused and cfg.d == 2187 and cfg.band == R13_TILE
    slabs, ly, lx = tile_slabs(cfg, R13_TILE_INDEX, scene74)
    assert main_fraction(cfg, slabs, ly, lx, scene74) > R13_MAIN_FLOOR
    got = torch_tile(cfg, slabs, ly, lx, scene74)
    assert np.isfinite(got[0]).all()
    same_count, gap = tile_gap(got, jax_tile(cfg, slabs, ly, lx, scene74))
    assert same_count and gap < R13_RMSE
