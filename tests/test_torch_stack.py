"""The port's candidate-stack engine (bcd_tpu_torch/core/monoscale.py, the
patch radius r != 1 path, plain twins on the CPU) against the JAX plain
engine and the float64 oracle, on a scene where the r = 2 main path runs."""

import functools
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from bcd_tpu_torch.convert import to_device, to_numpy
from bcd_tpu_torch.core import monoscale as tmono
from tests import reference_impl as oracle
from tests.test_ops_vs_oracle import make_stats
from tests.torch_workers import share_cores

share_cores()

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# r = 2 needs n >= d + 1 = 76 similar patches for the main path; b = 5
# offers 121, and at this threshold 47% of the 20x20 scene's centers take
# the main path (61% is the most the window truncation at the borders
# allows)
R2_THRESHOLD = 2.25


def _padded(cfg, args):
    h = cfg.halo
    color, nb, histo, cov = (torch.from_numpy(a) for a in args)
    pad = functools.partial(tmono._pad_hw, top=h, bottom=h, left=h, right=h)
    return pad(color), pad(nb, fill=1.0), pad(histo), pad(cov)


def main_path_fraction(cfg, args, threshold):
    """Main-path centers over managed (main + fallback) centers."""
    height, width = args[0].shape[:2]
    main = managed = 0
    for _, (ly, lx), slabs in tmono.tile_batches(cfg, *_padded(cfg, args)):
        s = tmono.candidate_stacks(cfg, *slabs, ly, lx, ly, lx, height,
                                   width, height, width, threshold)
        main += int(s["main"].sum())
        managed += int((s["main"] | s["fb"]).sum())
    return main / managed


@functools.lru_cache(maxsize=None)
def scene20():
    """A 20x20 scene, its color rounded to half precision so that an EXR
    file holds it exactly."""
    _, st = make_stats(np.random.default_rng(7), h=20, w=20, spp=16)
    args = [np.asarray(st[k], np.float32)
            for k in ("mean", "nb_of_samples", "histo", "cov")]
    args[0] = args[0].astype(np.float16).astype(np.float32)
    return args


# jax_plain's child process: argv = inputs (.npz), output (.npy), radius,
# b, skip_stride, threshold
_JAX_PLAIN = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from bcd_tpu.core.monoscale import MonoscaleConfig, _denoise_image
z = np.load(sys.argv[1])
radius, b, stride = (int(a) for a in sys.argv[3:6])
cfg = MonoscaleConfig(patch_radius=radius, search_radius=b, tile=8,
                      skip_stride=stride, eigh_impl="lax")
np.save(sys.argv[2], np.asarray(_denoise_image(
    cfg, *(jnp.asarray(z[f"arr_{i}"]) for i in range(4)),
    jnp.float32(float(sys.argv[6])), jnp.float32(1e-8))))
"""


def jax_plain(args, radius, b, skip_stride=1):
    """JAX's plain XLA engine (``_denoise_image``, tile 8) with its exact
    ``jnp.linalg.eigh`` (``eigh_impl="lax"``), the eigh the port's twins
    use. Its default fixed-schedule Jacobi eigh gives the same result at
    r = 2 but takes about 40 s a call on a CPU core, against 3 s.

    It runs in a child process whose OpenBLAS has one thread. The eigh
    runs in scipy's OpenBLAS, whose threads wait by spinning: two test
    processes each running it at d = 363 on every core took over ten
    minutes where one took 42 s (one thread each: 46 s), and at d = 243
    beside another JAX test it held the whole suite past its time limit.
    OPENBLAS_NUM_THREADS is read only when the library loads, and a limit
    set later inside a process (threadpoolctl) did not help."""
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npy")
        np.savez(src, *args)
        env = dict(os.environ, OPENBLAS_NUM_THREADS="1", JAX_PLATFORMS="cpu")
        subprocess.run(
            [sys.executable, "-c", _JAX_PLAIN, src, dst, str(radius), str(b),
             str(skip_stride), repr(R2_THRESHOLD)],
            cwd=ROOT, env=env, check=True, timeout=900)
        return np.load(dst)


def torch_r2(skip_stride=1, tile=8):
    cfg = tmono.MonoscaleConfig(patch_radius=2, search_radius=5, tile=tile,
                                skip_stride=skip_stride)
    return to_numpy(tmono.denoise_image(
        cfg, *to_device(*scene20(), CPU), R2_THRESHOLD, 1e-8))


def rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def test_r2_scene_reaches_the_main_path():
    cfg = tmono.MonoscaleConfig(patch_radius=2, search_radius=5, tile=8)
    assert not cfg.fused
    assert main_path_fraction(cfg, scene20(), R2_THRESHOLD) > 1 / 3


def test_r2_engine_matches_jax():
    assert rmse(torch_r2(), jax_plain(scene20(), 2, 5)) < 2e-4


def test_r2_engine_matches_oracle():
    from bcd_tpu.params import DenoiserParameters

    ref = oracle.denoise_monoscale(*scene20(), DenoiserParameters(
        patch_radius=2, search_window_radius=5,
        histogram_distance_threshold=R2_THRESHOLD))
    assert rmse(torch_r2(tile=16), ref) < 1e-4


@pytest.mark.parametrize("radius,stride,size", [(1, 2, 14), (2, 3, 14)])
def test_skip_stride_matches_jax(radius, stride, size):
    """Only the centers on the stride grid are solved: r = 1 through the
    fused engine, r = 2 through the candidate-stack engine, each against
    JAX's plain path at the same stride."""
    _, st = make_stats(np.random.default_rng(40 + radius), h=size, w=size,
                       spp=16)
    args = [np.asarray(st[k], np.float32)
            for k in ("mean", "nb_of_samples", "histo", "cov")]
    b = 3 if radius == 1 else 5
    ref = jax_plain(args, radius, b, skip_stride=stride)
    cfg = tmono.MonoscaleConfig(patch_radius=radius, search_radius=b,
                                tile=16, skip_stride=stride)
    assert cfg.fused == (radius == 1)
    if radius == 2:
        assert main_path_fraction(cfg, args, R2_THRESHOLD) > 0.1
    got = to_numpy(tmono.denoise_image(cfg, *to_device(*args, CPU),
                                       R2_THRESHOLD, 1e-8))
    full = to_numpy(tmono.denoise_image(
        tmono.MonoscaleConfig(patch_radius=radius, search_radius=b, tile=16),
        *to_device(*args, CPU), R2_THRESHOLD, 1e-8))
    assert rmse(got, ref) < 2e-4
    assert rmse(got, full) > 1e-3  # the stride changed the result
    assert np.isfinite(got).all() and (got > 0).all()


@pytest.mark.parametrize("skip_stride", [1, 3])
def test_distance_masks_match_jax_with_zero_counts(skip_stride):
    """A tile whose sample counts hold zeros: JAX's plain path has no guard
    against the zero chi^2 denominator (monoscale.py:278-280), and neither
    has the port's, so the masks agree exactly, NaN distances included."""
    import jax.numpy as jnp
    from bcd_tpu.core.monoscale import MonoscaleConfig, _distance_masks

    t, r, b = 8, 2, 5
    h = r + b
    tp = t + 2 * h
    rng = np.random.default_rng(21)
    _, st = make_stats(rng, h=tp, w=tp, spp=16)
    histo = np.asarray(st["histo"], np.float32)
    nb = np.asarray(st["nb_of_samples"], np.float32)[..., 0]
    nb[rng.random(nb.shape) < 0.1] = 0.0
    assert (nb == 0).sum() > 10
    geom = (3, 2, 0, 0, t, t, 20, 20, R2_THRESHOLD)  # gy gx ly lx core hw
    ref, ref_cv = _distance_masks(
        MonoscaleConfig(patch_radius=r, search_radius=b, tile=t,
                        skip_stride=skip_stride),
        jnp.asarray(histo), jnp.asarray(nb), *geom)
    gy, gx, ly, lx = (torch.tensor([v]) for v in geom[:4])
    got, got_cv = tmono._distance_masks(
        tmono.MonoscaleConfig(patch_radius=r, search_radius=b, tile=t,
                              skip_stride=skip_stride),
        torch.from_numpy(histo)[None], torch.from_numpy(nb)[None],
        gy, gx, ly, lx, *geom[4:])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got_cv[0].numpy(), np.asarray(ref_cv))
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("tile", [8, 32])
def test_candidate_stacks_are_kernel_ready(tile):
    """The stacks ``solve_filter_pm`` reads in place on the card must be
    contiguous float32 in every batch, also a batch of one tile (tile 32
    covers the 20x20 scene in one), where the mask's reshape alone would be
    a strided view."""
    cfg = tmono.MonoscaleConfig(patch_radius=2, search_radius=5, tile=tile)
    height, width = scene20()[0].shape[:2]
    for _, (ly, lx), slabs in tmono.tile_batches(cfg, *_padded(cfg,
                                                               scene20())):
        s = tmono.candidate_stacks(cfg, *slabs, ly, lx, ly, lx, height,
                                   width, height, width, R2_THRESHOLD)
        for k in ("cand", "mask", "noise", "n", "m"):
            assert s[k].dtype == torch.float32 and s[k].is_contiguous(), k


@pytest.mark.parametrize("tile_batch", [8, 4, 1])
def test_tile_batch_leaves_the_image_bitwise(tile_batch):
    """The engine's tiles a batch change how many centers each launch
    solves, not their results: 8, 4 or 1 tiles a batch (two, three or nine
    batches of the 20x20 scene's 9 tiles) give the image of 16 (one batch)
    bit for bit."""
    outs = [to_numpy(tmono.denoise_image(
        tmono.MonoscaleConfig(patch_radius=2, search_radius=5, tile=8,
                              tile_batch=n),
        *to_device(*scene20(), CPU), R2_THRESHOLD, 1e-8))
        for n in (tile_batch, 16)]
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("r,b,tile,tile_batch,batch", [
    (1, 6, 32, None, 128), (2, 6, 32, None, 16), (5, 10, 32, None, 16),
    (6, 10, 32, None, 8), (6, 11, 32, None, 8), (6, 11, 8, None, 16),
    (6, 11, 32, 16, 16), (7, 13, 32, None, 4), (6, 18, 32, None, 4),
    (3, 33, 32, None, 4), (7, 30, 32, None, 1), (7, 33, 32, None, 1),
    (8, 15, 32, None, 2), (9, 16, 32, None, 2), (10, 18, 32, None, 1),
    (11, 20, 32, None, 1), (12, 22, 32, None, 1), (13, 23, 32, None, 1),
])
def test_stack_batch_by_bytes(r, b, tile, tile_batch, batch):
    """The candidate-stack engine takes 16 tiles a batch, halved while the
    fp32 candidate stack would pass STACK_BYTES (12 GB), down to one tile:
    8 at r = 6 from b = 10 on 32x32 tiles (a (16384, 441, 507) stack is
    14.6 GB), not at r = 5, b = 10 (10.5 GB) nor on 8x8 tiles; 4 at r = 7,
    b = 13 (an 8-tile (8192, 729, 675) stack is 16.1 GB, 4 tiles 8.06 GB),
    r = 6, b = 18 and r = 3, b = 33; 2 at r = 8, b = 15 (a 4-tile
    (4096, 961, 867) stack is 13.7 GB, 2 tiles 6.83 GB) and at r = 9,
    b = 16 (a 4-tile (4096, 1089, 1083) stack is 19.3 GB, 2 tiles
    9.66 GB); 1 at r = 10, b = 18 (a 2-tile (2048, 1369, 1323) stack is
    14.8 GB, one tile 7.42 GB), at r = 11, b = 20 (a 2-tile
    (2048, 1681, 1587) stack is 21.9 GB, one tile 10.9 GB), at r = 12,
    b = 22 (one (1024, 2025, 1875) tile is 15.6 GB, 3.89e9 elements) and at
    r = 7, b = 30 (10.3 GB a tile),
    and still 1 at b = 33, where one tile's 12.4 GB passes the limit (JAX
    refuses none), and at r = 13, b = 23 (19.8 GB a tile, solved in bands:
    ``test_stack_band_by_bytes``). An explicit ``tile_batch`` wins, and the
    fused r = 1 engine keeps its 128."""
    cfg = tmono.MonoscaleConfig(patch_radius=r, search_radius=b, tile=tile,
                                tile_batch=tile_batch)
    assert cfg.batch == batch


@pytest.mark.parametrize("r,b,tile,band", [
    (1, 6, 32, 32), (2, 6, 32, 32), (7, 33, 32, 32), (11, 20, 32, 32),
    (12, 22, 32, 32), (12, 23, 32, 16), (13, 22, 32, 16), (13, 23, 32, 16),
    (13, 23, 8, 8), (14, 25, 32, 8), (20, 40, 32, 2),
])
def test_stack_band_by_bytes(r, b, tile, band):
    """Below one tile: a tile's centers are solved a band of rows at a
    time only where one tile's fp32 stack passes r = 12, b = 22's 15.55 GB
    (BAND_FROM_BYTES), every setting that ran whole before running whole
    (r = 12, b = 22 and r = 7, b = 33: 12.4 GB); the band is the tile
    halved until its stack fits STACK_BYTES (12 GB): 16 rows at r = 13,
    b = 23 (19.8 GB a tile, 9.89 GB a band) and b = 22 (18.1 GB), and at
    r = 12, b = 23 (17.0 GB); 8 at r = 14, b = 25 (26.9 GB); an 8x8 tile
    at r = 13, b = 23 (4.9 GB) runs whole."""
    cfg = tmono.MonoscaleConfig(patch_radius=r, search_radius=b, tile=tile)
    assert cfg.band == band
    assert (band < tile) == (tile * cfg.row_stack > tmono.BAND_FROM_BYTES)
    assert tmono.BAND_FROM_BYTES == 15_552_000_000


@pytest.mark.parametrize("tile,rows", [(8, 4), (8, 1), (10, 3)])
def test_bands_leave_the_image(tile, rows, monkeypatch):
    """The bands change how many centers each solve takes and how the
    field is folded into the candidate frame, not the image: at r = 2 with
    the byte bounds patched so that a tile's centers go ``rows`` rows at a
    time (on 10x10 tiles three bands of 3 and one of 1), the image is the
    one tile at a time gives, within rms 1e-6. Not bit for bit: each band's
    fold is summed on its own and added to the frame, where one fold of
    the whole tile sums a frame pixel's contributions in kernel order."""
    cfg = tmono.MonoscaleConfig(patch_radius=2, search_radius=5, tile=tile)
    args = to_device(*scene20(), CPU)
    whole = to_numpy(tmono.denoise_image(cfg, *args, R2_THRESHOLD, 1e-8))
    monkeypatch.setattr(tmono, "BAND_FROM_BYTES", 0)
    monkeypatch.setattr(tmono, "STACK_BYTES", rows * cfg.row_stack)
    assert cfg.band == rows
    got = to_numpy(tmono.denoise_image(cfg, *args, R2_THRESHOLD, 1e-8))
    assert np.isfinite(got).all()
    assert rmse(got, whole) < 1e-6
