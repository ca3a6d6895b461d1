"""The port's candidate-stack engine at patch radius 10 (d = 1323, the plain
twins on the CPU) against JAX's plain engine, on one tile.

At r = 10 the main path needs n >= d + 1 = 1,324 similar patches. b = 17
offers 1,225 offsets, so no center can take the main path there; b = 18
(1,369 offsets) is the smallest window that reaches the solve, and only
where at most 45 of a center's offsets fall outside the patch-valid region
or are dissimilar. The 52x52 scene of the r = 9 test cannot get there (its
patch-valid region is 32 wide, under the 37-wide window); on the 58x58
scene of the same generator (38 wide) the 2x2 centers (28..29, 28..29)
keep their whole window, and the four beside them in row or column 30 lose
one column or row of it (1,332 offsets left). They lie in 4x4 tile 112
(core rows and columns 28..31), where those 8 of the 16 managed centers
take the main path at this threshold: the floor below is 40%.

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

R10_TILE = 4
R10_TILE_INDEX = 112
R10_MAIN_FLOOR = 0.40
R10_RMSE = 2e-4


@functools.lru_cache(maxsize=None)
def scene58():
    _, st = make_stats(np.random.default_rng(7), h=58, w=58, spp=16)
    return [np.asarray(st[k], np.float32)
            for k in ("mean", "nb_of_samples", "histo", "cov")]


def test_r10_b18_tile_matches_jax():
    """b = 18 on tile 112 of the 58x58 scene: a share of its centers takes
    the main path (the solve at d = 1323), and its contributions are JAX's
    ``denoise_tile``'s: the same counts, the estimates within R10_RMSE."""
    cfg = tmono.MonoscaleConfig(patch_radius=10, search_radius=18,
                                tile=R10_TILE)
    assert not cfg.fused and cfg.d == 1323
    slabs, ly, lx = tile_slabs(cfg, R10_TILE_INDEX, scene58)
    assert main_fraction(cfg, slabs, ly, lx, scene58) > R10_MAIN_FLOOR
    got = torch_tile(cfg, slabs, ly, lx, scene58)
    assert np.isfinite(got[0]).all()
    same_count, gap = tile_gap(got, jax_tile(cfg, slabs, ly, lx, scene58))
    assert same_count and gap < R10_RMSE
