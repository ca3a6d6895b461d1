"""The port's candidate-stack engine at patch radius 7 (d = 675, the plain
twins on the CPU) against JAX's plain engine, one tile at a time.

At r = 7 the main path needs n >= d + 1 = 676 similar patches. b = 12
offers 625 offsets, so no center can take the main path there and every
one takes the mean-patch fallback; b = 13 (729 offsets) is the smallest
window that reaches the solve, and only where at most 53 of a center's
offsets fall outside the patch-valid region. The 40x40 scene of the r = 6
tests is the smallest of its generator where any center gets there: the
four centers (19..20, 19..20) lose one row and one column of their window
and keep 676 offsets, all of them similar at this threshold. They lie in
8x8 tile 12 (core rows and columns 16..23), where 4 of the 64 managed
centers take the main path: the floor below is 5%.

JAX's plain path runs the exact eigh three times on every center of what
it denoises, whatever its gate, so a whole 40x40 image would take tens of
minutes at d = 675 on one core. The reference is JAX's ``denoise_tile``
(``eigh_impl="lax"``, one OpenBLAS thread, in a child process) on that one
tile, against the port's ``denoise_tiles`` on the same slabs: the
apron-inclusive (out_sum, count) contributions."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from bcd_tpu_torch.core import monoscale as tmono
from tests.test_torch_r6 import scene40
from tests.test_torch_stack import ROOT, R2_THRESHOLD, _padded
from tests.torch_workers import share_cores

share_cores()

R7_TILE = 8
R7_TILE_INDEX = 12
R7_MAIN_FLOOR = 0.05
# the estimates out_sum / count of the two tiles, as the r = 3 to 6 tests
# hold the whole images
R7_RMSE = 2e-4

# the child process: argv = slabs (.npz), output (.npz), radius, b, tile,
# threshold, then gy gx ly lx core_h core_w height width. The tile runs as
# one jitted program: op by op, each of the fan-out's (2r + 1)^2 rolls is
# compiled on its own, and at r = 12 (tests/test_torch_r12.py) the child
# took 176 s so on an 8-core host where the jitted program takes 43 s (28 s
# of it the compile); the port's tile sits 4.07e-6 from either
_JAX_TILE = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from bcd_tpu.core.monoscale import MonoscaleConfig, denoise_tile
z = np.load(sys.argv[1])
radius, b, tile = (int(a) for a in sys.argv[3:6])
ints = [int(a) for a in sys.argv[7:15]]
cfg = MonoscaleConfig(patch_radius=radius, search_radius=b, tile=tile,
                      eigh_impl="lax")
tile_fn = jax.jit(denoise_tile, static_argnums=(0,) + tuple(range(5, 13)))
out_sum, count = tile_fn(
    cfg, *(jnp.asarray(z[f"arr_{i}"]) for i in range(4)), *ints,
    jnp.float32(float(sys.argv[6])), jnp.float32(1e-8))
np.savez(sys.argv[2], np.asarray(out_sum), np.asarray(count))
"""


def tile_slabs(cfg, index, scene=scene40):
    """The halo-padded slabs of tile ``index`` of ``scene()`` (the 40x40
    scene), as the port's engine cuts them, and its core origin (ly, lx)."""
    one = tmono.MonoscaleConfig(patch_radius=cfg.patch_radius,
                                search_radius=cfg.search_radius,
                                tile=cfg.tile, tile_batch=1)
    for idx, (ly, lx), slabs in tmono.tile_batches(
            one, *_padded(one, scene())):
        if int(idx[0]) == index:
            return slabs, int(ly[0]), int(lx[0])
    raise IndexError(index)


def main_fraction(cfg, slabs, ly, lx, scene=scene40):
    """Main-path centers over managed centers of the tile."""
    height, width = scene()[0].shape[:2]
    yx = [torch.tensor([v]) for v in (ly, lx)]
    s = tmono.candidate_stacks(cfg, *slabs, *yx, *yx, height, width, height,
                               width, R2_THRESHOLD)
    return float(s["main"].sum()) / float((s["main"] | s["fb"]).sum())


def jax_tile(cfg, slabs, ly, lx, scene=scene40):
    height, width = scene()[0].shape[:2]
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(src, *(s[0].numpy() for s in slabs))
        env = dict(os.environ, OPENBLAS_NUM_THREADS="1", JAX_PLATFORMS="cpu")
        subprocess.run(
            [sys.executable, "-c", _JAX_TILE, src, dst,
             str(cfg.patch_radius), str(cfg.search_radius), str(cfg.tile),
             repr(R2_THRESHOLD),
             *map(str, (ly, lx, ly, lx, height, width, height, width))],
            cwd=ROOT, env=env, check=True, timeout=900)
        z = np.load(dst)
        return z["arr_0"], z["arr_1"]


def torch_tile(cfg, slabs, ly, lx, scene=scene40):
    height, width = scene()[0].shape[:2]
    yx = [torch.tensor([v]) for v in (ly, lx)]
    out_sum, count = tmono.denoise_tiles(
        cfg, *slabs, *yx, *yx, height, width, height, width, R2_THRESHOLD,
        1e-8)
    return out_sum[0].numpy(), count[0].numpy()


def tile_gap(got, want):
    """(count equal, rmse of the estimates out_sum / count where count > 0)."""
    (g_sum, g_cnt), (w_sum, w_cnt) = got, want
    seen = w_cnt > 0
    est = [s[seen] / c[seen, None] for s, c in ((g_sum, g_cnt),
                                                (w_sum, w_cnt))]
    gap = float(np.sqrt(np.mean((est[0].astype(np.float64) - est[1]) ** 2)))
    return np.array_equal(g_cnt, w_cnt), gap


def test_r7_b13_tile_matches_jax():
    """b = 13 on tile 12 of the 40x40 scene: a share of its centers takes the
    main path (the solve at d = 675), and its contributions are JAX's
    ``denoise_tile``'s: the same counts, the estimates within R7_RMSE."""
    cfg = tmono.MonoscaleConfig(patch_radius=7, search_radius=13,
                                tile=R7_TILE)
    assert not cfg.fused and cfg.d == 675
    slabs, ly, lx = tile_slabs(cfg, R7_TILE_INDEX)
    assert main_fraction(cfg, slabs, ly, lx) > R7_MAIN_FLOOR
    got = torch_tile(cfg, slabs, ly, lx)
    assert np.isfinite(got[0]).all()
    same_count, gap = tile_gap(got, jax_tile(cfg, slabs, ly, lx))
    assert same_count and gap < R7_RMSE


def test_r7_b12_takes_no_solve_and_matches_jax():
    """b = 12 on the same tile: 625 offsets, fewer than d + 1 = 676, so no
    center reaches the solve; the fallback-only contributions are JAX's."""
    cfg = tmono.MonoscaleConfig(patch_radius=7, search_radius=12,
                                tile=R7_TILE)
    assert len(tmono._offsets(cfg)) < cfg.d + 1
    slabs, ly, lx = tile_slabs(cfg, R7_TILE_INDEX)
    assert main_fraction(cfg, slabs, ly, lx) == 0.0
    got = torch_tile(cfg, slabs, ly, lx)
    assert np.isfinite(got[0]).all()
    same_count, gap = tile_gap(got, jax_tile(cfg, slabs, ly, lx))
    assert same_count and gap < R7_RMSE
