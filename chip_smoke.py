#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bcd_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero before
the final line:

1. The card (name, count, power limit) and the kernel build: nvcc's
   register, shared-memory and spill report for every kernel; K2's must
   show no spill (its Jacobi lives in registers).
2. Each kernel against its plain PyTorch twin, timed with CUDA events,
   beside its bound (``bcd_tpu_torch/ops/bounds.py``, from this run's
   shapes and mask counts); K2 also against the plain fp32 model of its own
   schedule. K1 masks_moments, K2 solve_matrices_pm and K4 apply_scatter at the
   -w 1 path's shapes (b=6, r=1, 60 bins, tile 32) on one tile batch of
   the golden scene and one of the full-size scene, K2 also through K4 on
   every pixel the batch's filters reach; solve_filter and the lane-form
   solve_matrices on synthetic stacks at d = 27 and 75, and on one real
   16-tile batch of the full-size scene at r=2, b=6 (the stacks the
   -w 2 engine builds), finite on every center; both also against the
   plain fp32 model of their schedule, and solve_filter's in-place entry
   (the engine's) against its compact one, bit for bit.
3. The golden scene (tests/golden) through the port: monoscale and 2-scale
   outputs within rmse 1e-4 of the committed goldens, and the main-path
   fraction (gate sum over managed pixels).
4. The default ``bcd`` run through ``python -m bcd_tpu_torch.cli``'s entry
   point on a 1088x1920, 4 spp scene (-p 1 -s 3, b=6, r=1): the output must
   beat the noisy input against the clean render, and K1, K2 and K4 must
   each have launched. Wall time, MPix/s, peak memory; the same pipeline
   with K2's float64 twin in K2's place, within the goldens' rmse bound;
   device time by kernel from one traced run.
5. The -w 2 run through the CLI's entry point on the same scene: it must
   launch solve_filter and beat the noisy input. Wall time, MPix/s and
   peak memory of the r=2 pipeline (bitwise repeatable); the card against
   the port's CPU pipeline on a 64x64 crop; device time by kernel.
6. Ingest and the renderer surface on a 1088x1920, 16 spp RGBA render of
   the same scene: its raw dump through ``raw2bcd_cli.main`` on the card
   (read, accumulate and write times; the statistics against the float64
   stand-in ``accumulate_statistics``; the accumulator bitwise repeatable,
   its device time beside its bound), ``bcd --stats`` on its EXRs (the
   counters against the managed pixel count, the output bitwise that of
   a run without stats, with the same launches), ``MultiscaleDenoiser``
   on the in-memory statistics bitwise ``denoise_multiscale``'s, and the
   batch CLI on two copies of the frame and a broken one (isolation, each
   output the CLI's bit for bit, ``--resume``).
7. One JSON line of kernel results, the card line, and the final line
   ``{"ok": true, "device": {...}}``.

Inputs are generated from fixed seeds; nothing is downloaded. No JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "chip_smoke")
GOLDEN = os.path.join(HERE, "tests", "golden")

# K2 against the plain fp32 model of its own schedule on synthetic moments
# (the same arithmetic; about 1e-7 on an H100)
K2_MODEL_RMS = 1e-5
# ... and on a tile batch's real moments, where rank-deficient similar sets
# amplify the rounding: relative rms of the filtered self-candidate, about
# 3x the largest reading on an H100 (6.3e-5, 1088x1920)
K2_MODEL_BATCH_REL_RMS = 2e-4
# K2 (4 sweeps) against its float64 twin, through K4 on every covered pixel
# of a tile batch (relative rms of the tile estimates): K2's rms bound in
# the tests, about 4x the largest reading on an H100 (5.2e-5, 1088x1920)
K2_CANDIDATE_REL_RMS = 2e-4
# the whole pipeline with K2 against it with the twin: the goldens' rmse bound
E2E_K2_RMSE = 1e-4
# solve_filter's Jacobi sweeps on the -w 2 path (core/monoscale.py)
SOLVE_SWEEPS = 6
# synthetic solves against their float64 twins: JAX's own kernel-vs-
# reference bound (tests/test_solve_filter_pallas.py:34)
SYNTH_RMS = 2e-4
# solve_filter and the lane solve_matrices against the plain fp32 model of
# their schedule (ops/solve_filter.solve_schedule_core): synthetic stacks
# (about 2e-6 at d = 75 on an H100), and the filtered field of the real
# r = 2 batch, relative rms, about 3x the reading on an H100 (6.9e-6)
SOLVE_MODEL_RMS = 1e-5
SOLVE_MODEL_BATCH_REL_RMS = 2e-5
# centers of the real r = 2 batch the fp32 model runs on
MODEL_CENTERS = 4096
# real r = 2 batch: the filtered field against the float64 twin's, relative
# rms, the bound K2's filtered self-candidate is held to
BATCH_REL_RMS = 1e-3
# the -w 2 pipeline on the card against the port's CPU pipeline: the
# goldens' bound
R2_CPU_RMSE = 1e-4
# the kernels each path launches (ops/_build.LAUNCHES keys)
R1_KERNELS = ("masks_moments", "solve_matrices_pm", "apply_scatter")
R2_KERNELS = ("solve_filter",)
# centers of the real r = 2 batch on which the lane solve_matrices, on no
# engine path, is held to its float64 twin (whose call takes about 3 ms a
# center on the card)
LANE_CENTERS = 2048
# solve_filter_pm's stack arguments, in order
PM_KEYS = ("cand", "mask", "noise", "n", "m")
# phase 6: samples a pixel of the ingest render
INGEST_SPP = 16
# the accumulator (float32) against the float64 stand-in at 16 spp: mean
# within rtol 1e-5 (float32 sums of 16 samples); cov within 1e-5 of
# |cov| + |mean_i mean_j| (it is E[x_i x_j] - mean_i mean_j, and the
# float32 error is that of the second moment, at most |cov| + |mean_i
# mean_j|); histo within 2e-4 (each sample moves its two bin weights by at
# most 18 |dv|, |dv| <= 2 ulp of v <= 2 between float32 and float64
# companding, about 9e-6 a sample, 1.4e-4 for 16)
ACC_MEAN_RTOL = 1e-5
ACC_COV_REL = 1e-5
ACC_HISTO_ATOL = 2e-4

def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def need(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def rmse(a, b) -> float:
    return float(np.sqrt(np.mean(
        (np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def timed_once(fn):
    """(fn(), ms) for one call timed with CUDA events, no warm-up: for the
    float64 twins, whose one call takes seconds."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls after one warm-up,
    timed with CUDA events."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def load_golden():
    from bcd_tpu_torch.io import image_io

    def load(name):
        return image_io.load_multi_channels_exr(os.path.join(GOLDEN, name))

    histo, nb = image_io.separate_nb_of_samples_from_histogram(
        load("in_hist.exr"))
    return (load("in_color.exr"), nb, histo, load("in_cov.exr"),
            load("out_mono_b6.exr"), load("out_multi2_b6.exr"))


def accumulate_statistics(samples, nb_of_bins=20, gamma=2.2, max_value=2.5):
    """Vectorized statistics of unweighted samples (H, W, S, 3): the
    semantics of tests/reference_impl.py::accumulate_samples (reference
    SamplesAccumulator.cpp:44-141) with the per-sample histogram splat as
    two bincounts. Returns float32 (color, nb, histo, cov)."""
    s = np.asarray(samples, np.float64)[..., :3]
    height, width, spp, _ = s.shape
    mean = s.mean(axis=2)
    r, g, b = s[..., 0], s[..., 1], s[..., 2]
    cov = np.stack([(r * r).sum(2), (g * g).sum(2), (b * b).sum(2),
                    (g * b).sum(2), (r * b).sum(2), (r * g).sum(2)],
                   axis=-1) / spp
    m0, m1, m2 = mean[..., 0], mean[..., 1], mean[..., 2]
    cov -= np.stack([m0 * m0, m1 * m1, m2 * m2, m1 * m2, m0 * m2, m0 * m1],
                    axis=-1)
    cov *= 1.0 / (1.0 - 1.0 / spp)  # bias 1 / (1 - w2sum / wsum^2)

    v = np.maximum(s, 0.0) ** (1.0 / gamma) / max_value
    v = np.minimum(v, 2.0)
    bin_float = v * (nb_of_bins - 2)
    floor_bin = bin_float.astype(np.int64)
    in_bounds = floor_bin < nb_of_bins - 2
    floor_bin = np.where(in_bounds, floor_bin, nb_of_bins - 2)
    ceil_w = np.where(in_bounds, bin_float - floor_bin, (v - 1.0) / 1.0)
    pix = np.arange(height * width).reshape(height, width, 1, 1)
    chan = np.arange(3).reshape(1, 1, 1, 3)
    idx = ((pix * 3 + chan) * nb_of_bins + floor_bin).ravel()
    size = height * width * 3 * nb_of_bins
    histo = (np.bincount(idx, weights=(1.0 - ceil_w).ravel(), minlength=size)
             + np.bincount(idx + 1, weights=ceil_w.ravel(), minlength=size))
    nb = np.full((height, width, 1), float(spp))
    return tuple(a.astype(np.float32) for a in (
        mean, nb, histo.reshape(height, width, 3 * nb_of_bins), cov))


def full_scene(height=1088, width=1920, spp=4, seed=0):
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from make_test_scene import render_clean, sample_noisy

    clean = render_clean(height, width)
    return clean, accumulate_statistics(sample_noisy(clean, spp, seed))


# ---------------------------------------------------------------------------
# engine pieces
# ---------------------------------------------------------------------------


def padded(cfg, color, nb, histo, cov, device):
    import torch
    import torch.nn.functional as F

    h = cfg.halo

    def pad(x, fill=0.0):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        return F.pad(x, (0, 0, h, h, h, h), value=fill)

    return pad(color), pad(nb, 1.0), pad(histo), pad(cov)


def k1_batches(cfg, color, nb, histo, cov, device):
    """K1's inputs [histo, nb, color, pixcov, valid] slabs, one list per
    tile batch of a whole image, as the engine builds them."""
    from bcd_tpu_torch.core.fused import validity_maps
    from bcd_tpu_torch.core.monoscale import tile_batches

    height, width = color.shape[:2]
    for _, (ly, lx), slabs in tile_batches(
            cfg, *padded(cfg, color, nb, histo, cov, device)):
        valid = validity_maps(cfg, ly, lx, ly, lx, height, width, height,
                              width)
        s_color, s_nb, s_histo, s_pixcov = slabs
        yield [s_histo, s_nb, s_color, s_pixcov, valid]


def tile_batch_inputs(cfg, color, nb, histo, cov, device, batch=0):
    """K1's inputs for tile batch number ``batch`` of a whole image."""
    it = k1_batches(cfg, color, nb, histo, cov, device)
    for _ in range(batch):
        next(it)
    return next(it)


def main_path_fraction(cfg, color, nb, histo, cov, params, device) -> float:
    """Main-path solves over managed (main + fallback) pixels: the sum of
    K2's gates over every tile of the image."""
    from bcd_tpu_torch.ops.fused import masks_moments
    from bcd_tpu_torch.ops.solve_filter import D, solve_matrices_pm

    t, h, b = cfg.tile, cfg.halo, cfg.search_radius
    main = fb = 0.0
    for inputs in k1_batches(cfg, color, nb, histo, cov, device):
        _, m2, misc = masks_moments(
            *inputs, params.histogram_distance_threshold, t=t, h=h, b=b)
        _, small = solve_matrices_pm(m2.reshape(-1, m2.shape[-1]),
                                     misc.reshape(-1, misc.shape[-1]),
                                     params.min_eigen_value, cfg.solve_sweeps)
        main += float(small[:, D].sum())
        fb += float(small[:, 2 * D + 1].sum())
    need(main + fb > 0, "no managed pixels")
    return main / (main + fb)


# ---------------------------------------------------------------------------
# phase 2: kernels against their twins
# ---------------------------------------------------------------------------


def synthetic_moments(rng, P=256, n_off=49):
    """Random masked moments (the synthetic set of scripts/verify_tpu.py)."""
    import torch
    from bcd_tpu_torch.ops.fused import _tri_pack
    from bcd_tpu_torch.ops.solve_filter import D, MISC_CH

    C = rng.standard_normal((n_off, D, P))
    mask = rng.random((n_off, P)) < 0.7
    mask[n_off // 2] = True
    n = mask.sum(axis=0)
    mk = mask[:, None, :]
    m2 = np.einsum("okp,olp->pkl", mk * C, C).reshape(P, D * D)
    misc = np.zeros((P, MISC_CH))
    misc[:, :D] = (mk * C).sum(axis=0).T
    nov = np.zeros((P, 9, 6))
    nov[..., 0:3] = 0.05 + 0.1 * rng.random((P, 9, 3))
    nov[..., 3:6] = 0.01 * rng.standard_normal((P, 9, 3))
    misc[:, D : D + 54] = (nov * n[:, None, None]).reshape(P, 54)
    misc[:, D + 54] = n
    misc[:, D + 55] = 1.0
    return (torch.tensor(np.ascontiguousarray(m2[:, _tri_pack(D)]),
                         dtype=torch.float32),
            torch.tensor(misc, dtype=torch.float32))


def compare_kernels(label, inputs, params, cfg, reps):
    """K1, K2 and K4 against their twins on one tile batch. Returns a dict
    kernel -> (max_abs_err, ms, plain_ms, (bound_ms, bound_by))."""
    import torch
    from bcd_tpu_torch.ops import bounds
    from bcd_tpu_torch.ops import fused as tf
    from bcd_tpu_torch.ops import solve_filter as ts

    D = ts.D
    t, h, b = cfg.tile, cfg.halo, cfg.search_radius
    thr, eps = params.histogram_distance_threshold, params.min_eigen_value
    n_tiles = inputs[0].shape[0]
    res = {}

    # K1: masks may differ only at the threshold; moments where they agree
    k1 = lambda: tf.masks_moments(*inputs, thr, t=t, h=h, b=b)  # noqa: E731
    k1_plain = lambda: tf.masks_moments_plain(  # noqa: E731
        *inputs, thr, t=t, h=h, b=b)
    masks, m2, misc = k1()
    masks_p, m2_p, misc_p = k1_plain()
    diff = masks != masks_p
    dist = tf.distances_plain(inputs[0], inputs[1], t, h, b)
    near = (dist.reshape(diff.shape) - thr).abs() <= 1e-5 * thr
    need(bool((~diff | near).all()),
         f"{label} K1: a mask differs away from the threshold")
    same = ~diff.any(-1)
    err = 0.0
    for got, ref in ((m2, m2_p), (misc, misc_p)):
        g, r = got[same], ref[same]
        need(bool(((g - r).abs() <= 1e-5 + 2e-5 * r.abs()).all()),
             f"{label} K1: moments beyond rtol 2e-5")
        err = max(err, float((g - r).abs().max()))
    need(torch.equal(misc[same][:, D + 54 :], misc_p[same][:, D + 54 :]),
         f"{label} K1: n / center_valid not exact")
    n_sel = int(masks.sum())
    res["K1"] = (err, cuda_ms(k1, reps), cuda_ms(k1_plain, 1), bounds.k1(
        n_tiles, t, h, b, inputs[0].shape[-1], n_sel))
    print(f"[2] {label} K1 masks_moments ({n_tiles} tiles, {n_sel} selected "
          f"candidates): {int(diff.sum())} mask mismatches of {diff.numel()} "
          f"(all at the threshold), moments max abs err {err:.3e}, n exact; "
          f"kernel {res['K1'][1]:.3f} ms, twin {res['K1'][2]:.3f} ms, bound "
          f"{res['K1'][3][0]:.3f} ms ({res['K1'][3][1]})", flush=True)

    # K2 on the real moments (the engine's 4 sweeps) vs the float64 twin
    m2f, miscf = m2.reshape(-1, ts.DTRI), misc.reshape(-1, ts.MISC_CH)
    k2 = lambda: ts.solve_matrices_pm(  # noqa: E731
        m2f, miscf, eps, sweeps=cfg.solve_sweeps)
    k2_plain = lambda: ts.solve_matrices_pm_plain(  # noqa: E731
        m2f, miscf, eps)
    a2t, small = k2()
    a2t_p, small_p = k2_plain()
    need(torch.equal(small[:, D], small_p[:, D])
         and torch.equal(small[:, 2 * D + 1], small_p[:, 2 * D + 1]),
         f"{label} K2: gates not exact")
    need(bool(torch.isfinite(a2t).all() and torch.isfinite(small).all()),
         f"{label} K2: non-finite filter")
    # The filter acts on candidate patches, and only where the main-path
    # gate is on. Raw A2 entries are a poor probe: in directions where the
    # similar set has no spread (rank-deficient moments) the kernel's
    # Cholesky of M + eps I and the twin's exact eigenvalue floor differ
    # legitimately, and no candidate has a component there. So the error
    # is measured on a real filtered candidate, the center's own patch c:
    # A2 c + b2 (the mean patch is no probe: A2 m + b2 = m identically).
    main = small_p[:, D] > 0
    c = tf._patchify(inputs[2])[:, h - 1 : h - 1 + t, h - 1 : h - 1 + t]
    c = c.reshape(-1, D)[main]

    def filtered(a, s):
        return torch.einsum("pk,pkj->pj", c, a[main].reshape(-1, D, D)) \
            + s[main, :D]

    def rms(x):
        return float(torch.sqrt(torch.mean(x ** 2)))

    f_p = filtered(a2t_p, small_p)
    rel = rms(filtered(a2t, small) - f_p) / rms(f_p)
    err = float((filtered(a2t, small) - f_p).abs().max())
    k2_6 = ts.solve_matrices_pm(m2f, miscf, eps, sweeps=6)
    rel6 = rms(filtered(*k2_6) - f_p) / rms(f_p)
    res["K2"] = (err, cuda_ms(k2, reps), cuda_ms(k2_plain, 1),
                 bounds.k2(m2f.shape[0], cfg.solve_sweeps))
    a2t_m, small_m = ts.solve_matrices_pm_schedule(m2f, miscf, eps,
                                                   cfg.solve_sweeps)
    f_m = filtered(a2t_m, small_m)
    rel_m = rms(filtered(a2t, small) - f_m) / rms(f_m)
    print(f"[2] {label} K2 solve_matrices_pm ({m2f.shape[0]} pixels, "
          f"{int(main.sum())} on the main path, real K1 moments) vs float64 "
          f"twin: filtered self-candidate rel rms {rel:.3e} at "
          f"sweeps={cfg.solve_sweeps} ({rel6:.3e} at sweeps=6), max abs "
          f"err {err:.3e}; raw a2t rms {rms(a2t - a2t_p):.3e}; gates exact; "
          f"vs its fp32 schedule model rel rms {rel_m:.3e} (limit "
          f"{K2_MODEL_BATCH_REL_RMS:g}), gates exact; kernel "
          f"{res['K2'][1]:.3f} ms, twin {res['K2'][2]:.3f} ms, bound "
          f"{res['K2'][3][0]:.3f} ms ({res['K2'][3][1]})", flush=True)
    need(rel < 1e-3, f"{label} K2: filtered candidates beyond rel rms 1e-3")
    need(rel_m < K2_MODEL_BATCH_REL_RMS
         and torch.equal(small[:, D], small_m[:, D])
         and torch.equal(small[:, 2 * D + 1], small_m[:, 2 * D + 1]),
         f"{label} K2 against its schedule model on real moments")

    # K2 on every candidate its filters touch: K4's tile estimates (sum /
    # count, every center and apron pixel some mask reaches) from the
    # kernel's K2 against those from the twin's, with K1's masks
    a2t_p = a2t_p.reshape(n_tiles, t * t, D * D)
    small_p = small_p.reshape(n_tiles, t * t, ts.SMALL_CH)
    via_k2 = tf.apply_scatter(masks, a2t.reshape(a2t_p.shape),
                              small.reshape(small_p.shape), inputs[2],
                              t=t, h=h, b=b)
    via_twin = tf.apply_scatter(masks, a2t_p, small_p, inputs[2],
                                t=t, h=h, b=b)
    need(torch.equal(via_k2[..., 3], via_twin[..., 3]),
         f"{label} K2: K4 counts differ between the kernel's and the "
         "twin's gates")
    covered = via_twin[..., 3] > 0
    est_k2, est_twin = ((o[..., :3] / o[..., 3:].clamp(min=1.0))[covered]
                        for o in (via_k2, via_twin))
    rel_cand = rms(est_k2 - est_twin) / rms(est_twin)
    print(f"[2] {label} K2 through K4, all {int(covered.sum())} covered "
          f"pixels: estimate rel rms {rel_cand:.3e}, max abs err "
          f"{float((est_k2 - est_twin).abs().max()):.3e} (limit rel rms "
          f"{K2_CANDIDATE_REL_RMS:g})", flush=True)
    need(rel_cand < K2_CANDIDATE_REL_RMS,
         f"{label} K2: K4 estimates beyond rel rms {K2_CANDIDATE_REL_RMS:g}")

    # K4 with identical inputs: the twin's K2 output
    k4 = lambda: tf.apply_scatter(  # noqa: E731
        masks, a2t_p, small_p, inputs[2], t=t, h=h, b=b)
    k4_plain = lambda: tf.apply_scatter_plain(  # noqa: E731
        masks, a2t_p, small_p, inputs[2], t=t, h=h, b=b)
    out, out_p = k4(), k4_plain()
    need(torch.equal(out[..., 3], out_p[..., 3]), f"{label} K4: counts differ")
    g, r = out[..., :3], out_p[..., :3]
    need(bool(((g - r).abs() <= 3e-5 + 3e-5 * r.abs()).all()),
         f"{label} K4: sums beyond rtol/atol 3e-5")
    need(torch.equal(out, k4()), f"{label} K4: not deterministic")
    err = float((g - r).abs().max())
    n_applied = int((masks.sum(-1).float() * small_p[..., D]).sum())
    res["K4"] = (err, cuda_ms(k4, reps), cuda_ms(k4_plain, 1),
                 bounds.k4(n_tiles, t, h, b, n_applied))
    print(f"[2] {label} K4 apply_scatter ({n_tiles} tiles, {n_applied} "
          f"filtered candidates): max abs err {err:.3e}, counts exact, "
          f"bitwise repeatable; kernel {res['K4'][1]:.3f} ms, twin "
          f"{res['K4'][2]:.3f} ms, bound {res['K4'][3][0]:.3f} ms "
          f"({res['K4'][3][1]})", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 2, continued: solve_filter and the lane-form solve_matrices
# ---------------------------------------------------------------------------


def stack_inputs(rng, O, d, P, device):
    """Random candidate stacks in JAX's lane layout (the synthetic inputs
    of tests/test_solve_filter_pallas.py::make_inputs) and their raw
    moments: dict of C (O, d, P), mask (O, P), noise (6 npx, P), n (1, P),
    m (d, P), m2 (d, d, P), msum (d, P), nov (6 npx, P)."""
    import torch

    npx = d // 3
    C = rng.standard_normal((O, d, P))
    mask = (rng.random((O, P)) < 0.7).astype(np.float64)
    mask[O // 2] = 1.0
    n = mask.sum(axis=0, keepdims=True)
    m = (C * mask[:, None, :]).sum(axis=0) / n
    noise = np.zeros((npx, 6, P))
    noise[:, 0:3] = 0.05 + 0.1 * rng.random((npx, 3, P))
    noise[:, 3:6] = 0.01 * rng.standard_normal((npx, 3, P))
    noise = noise.reshape(6 * npx, P)
    mk = mask[:, None, :]
    x = dict(C=C, mask=mask, noise=noise, n=n, m=m,
             m2=np.einsum("okp,olp->klp", mk * C, C), msum=(mk * C).sum(0),
             nov=noise * n)
    return {k: torch.tensor(np.ascontiguousarray(v, np.float32),
                            device=device) for k, v in x.items()}


def lane_moments(x):
    """The lane solve_matrices' inputs (m2, msum, nov, n) from a stack."""
    import torch

    mk = x["mask"][:, None, :]
    return (torch.einsum("okp,olp->klp", mk * x["C"], x["C"]).contiguous(),
            (mk * x["C"]).sum(0), (x["noise"] * x["n"]).contiguous(), x["n"])


def r2_batch(stats, dev, thr, batch=8):
    """The candidate-stack engine's solve inputs for tile batch ``batch``
    (16 tiles of 32x32) of a whole image at r = 2, b = 6, built as the
    engine builds them. Returns (pixel-major stacks cand, mask, noise, n, m
    of every center, main-path mask)."""
    from bcd_tpu_torch.core.monoscale import (MonoscaleConfig,
                                              candidate_stacks, tile_batches)

    cfg = MonoscaleConfig(patch_radius=2, search_radius=6)
    height, width = stats[0].shape[:2]
    batches = tile_batches(cfg, *padded(cfg, *stats, dev))
    for _ in range(batch):
        next(batches)
    _, (ly, lx), slabs = next(batches)
    s = candidate_stacks(cfg, *slabs, ly, lx, ly, lx, height, width, height,
                         width, thr)
    return {k: s[k] for k in PM_KEYS}, s["main"]


def pm_of(x):
    """solve_filter_pm's arguments (cand, mask, noise, n, m) from stacks in
    JAX's lane layout."""
    return (x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
            x["noise"].T.contiguous(), x["n"][0].contiguous(),
            x["m"].T.contiguous())


def lanes_of(x):
    """JAX's lane layout (pixels last) of pixel-major stacks: dict of C
    (O, d, P), mask (O, P), noise (6 npx, P), n (1, P), m (d, P)."""
    return {"C": x["cand"].permute(1, 2, 0).contiguous(),
            "mask": x["mask"].T.contiguous(), "noise": x["noise"].T.contiguous(),
            "n": x["n"][None].contiguous(), "m": x["m"].T.contiguous()}


def r2_main_fraction(stats, dev, thr) -> float:
    """Main-path centers over managed centers of the r = 2, b = 6 engine on
    a whole image: n >= d + 1 similar patches (distance masks only)."""
    from bcd_tpu_torch.core.monoscale import (MonoscaleConfig,
                                              _distance_masks, tile_batches)

    cfg = MonoscaleConfig(patch_radius=2, search_radius=6)
    height, width = stats[0].shape[:2]
    main = managed = 0
    for _, (ly, lx), slabs in tile_batches(cfg, *padded(cfg, *stats, dev)):
        masks, cv = _distance_masks(cfg, slabs[2], slabs[1][..., 0], ly, lx,
                                    ly, lx, height, width, height, width, thr)
        main += int(((masks.sum(1) >= cfg.d + 1) & cv).sum())
        managed += int(cv.sum())
    need(managed > 0, "no managed pixels at r = 2")
    return main / managed


def rel_rms(got, ref) -> float:
    import torch

    return float(torch.sqrt(torch.mean((got.double() - ref.double()) ** 2))
                 / torch.sqrt(torch.mean(ref.double() ** 2)))


def compare_solve_synthetic(dev):
    """solve_filter at d = 75 and the lane solve_matrices at d = 27 and 75
    against their twins (and against solve_filter) on synthetic stacks,
    within JAX's own kernel-vs-reference bound. Returns the max abs err."""
    from bcd_tpu_torch.ops import solve_filter as ts

    err = 0.0
    for O, d in ((49, 27), (169, 75)):
        x = stack_inputs(np.random.default_rng(d), O, d, 1024, dev)
        npx = d // 3
        args = [x[k] for k in ("C", "mask", "noise", "n", "m")]
        field = ts.solve_filter(*args, 1e-8, npx=npx, sweeps=SOLVE_SWEEPS)
        ref = ts.solve_filter_plain(*args, 1e-8, npx=npx)
        e_f = rmse(field.cpu(), ref.cpu())
        lane = ts.solve_matrices(*lane_moments(x), 1e-8, npx=npx,
                                 sweeps=SOLVE_SWEEPS)
        lane_p = ts.solve_matrices_plain(*lane_moments(x), 1e-8, npx=npx)
        e_l = max(rmse(g.cpu(), r.cpu()) for g, r in zip(lane, lane_p))
        e_c = rmse(field.cpu(), lane_field(lane, x).cpu())
        model = ts.solve_filter_pm_schedule(
            *(v for v in pm_of(x)), 1e-8, npx, SOLVE_SWEEPS).permute(1, 2, 0)
        lane_m = ts.solve_matrices_schedule(*lane_moments(x), 1e-8, npx,
                                            SOLVE_SWEEPS)
        e_m = max(rmse(field.cpu(), model.cpu()),
                  max(rmse(g.cpu(), r.cpu()) for g, r in zip(lane, lane_m)))
        print(f"[2] synthetic d={d} (O={O}, 1024 pixels, sweeps "
              f"{SOLVE_SWEEPS}): solve_filter vs twin rms {e_f:.3e}; lane "
              f"solve_matrices vs twin rms {e_l:.3e}; lane filter vs "
              f"solve_filter rms {e_c:.3e} (limit {SYNTH_RMS:g}); both vs "
              f"their fp32 schedule model rms {e_m:.3e} (limit "
              f"{SOLVE_MODEL_RMS:g})", flush=True)
        need(max(e_f, e_l, e_c) < SYNTH_RMS, f"synthetic d={d} solve rms")
        need(e_m < SOLVE_MODEL_RMS, f"synthetic d={d} solves vs their model")
        err = max(err, float((field - ref).abs().max()),
                  max(float((g - r).abs().max())
                      for g, r in zip(lane, lane_p)))
    return err


def lane_field(lane, x):
    """field = mask (A2 c + b2) from the lane solve_matrices' (a2t, b2)."""
    import torch

    a2t, b2 = lane
    return x["mask"][:, None, :] * (
        torch.einsum("kjp,okp->ojp", a2t, x["C"]) + b2)


def compare_solve_batch(label, x, main, reps):
    """solve_filter and the lane solve_matrices on one real r = 2 batch of
    pixel-major stacks: the kernel must be finite on every center (main
    path, fallback, invalid); on the main-path centers, which the engine
    solves, both are held to their float64 twins through the filtered
    field, and the engine's entry (``rows``, in place) must give the same
    bits as the compact stack. Returns {name: (max_abs_err, ms, plain_ms,
    bound)}."""
    import torch
    from bcd_tpu_torch.ops import bounds
    from bcd_tpu_torch.ops import solve_filter as ts

    p_all, n_off, d = x["cand"].shape
    npx = d // 3
    args = [x[k] for k in PM_KEYS]
    every = ts.solve_filter_pm(*args, 1e-8, npx=npx, sweeps=SOLVE_SWEEPS)
    need(bool(torch.isfinite(every).all()),
         f"{label} solve_filter: non-finite output")
    idx = main.nonzero()[:, 0]
    need(idx.numel() > 0, f"{label}: no main-path center")
    xm = {k: v[idx].contiguous() for k, v in x.items()}
    args_m = [xm[k] for k in PM_KEYS]
    sf = lambda: ts.solve_filter_pm(  # noqa: E731
        *args_m, 1e-8, npx=npx, sweeps=SOLVE_SWEEPS)
    sf_plain = lambda: ts.solve_filter_pm_plain(  # noqa: E731
        *args_m, 1e-8, npx=npx)
    field = sf()
    in_place = ts.solve_filter_pm(*args, 1e-8, npx=npx, sweeps=SOLVE_SWEEPS,
                                  rows=idx)
    rest = torch.ones(p_all, dtype=torch.bool, device=idx.device)
    rest[idx] = False
    need(torch.equal(in_place[idx], field)
         and not bool(in_place[rest].any()),
         f"{label} solve_filter_pm: rows in place differ from the compact "
         "stack")
    ref, plain_ms = timed_once(sf_plain)
    rel = rel_rms(field, ref)
    res = {"solve_filter": (float((field - ref).abs().max()),
                            cuda_ms(sf, reps), plain_ms, bounds.solve_filter(
                                idx.numel(), n_off, d, SOLVE_SWEEPS))}
    print(f"[2] {label} solve_filter: {idx.numel()} main-path centers of "
          f"{main.numel()} (O={n_off}, d={d}), finite on all; field vs "
          f"float64 twin rel rms {rel:.3e} (limit {BATCH_REL_RMS:g}), max "
          f"abs err {res['solve_filter'][0]:.3e}; the engine's in-place rows "
          f"bitwise equal; kernel {res['solve_filter'][1]:.3f} ms, twin "
          f"{res['solve_filter'][2]:.3f} ms, bound "
          f"{res['solve_filter'][3][0]:.3f} ms", flush=True)
    need(rel < BATCH_REL_RMS, f"{label} solve_filter vs twin")
    model = ts.solve_filter_pm_schedule(
        *(v[:MODEL_CENTERS] for v in args_m), 1e-8, npx, SOLVE_SWEEPS)
    rel_m = rel_rms(field[:MODEL_CENTERS], model)
    print(f"[2] {label} solve_filter vs its fp32 schedule model on the first "
          f"{model.shape[0]} main-path centers: field rel rms {rel_m:.3e} "
          f"(limit {SOLVE_MODEL_BATCH_REL_RMS:g})", flush=True)
    need(rel_m < SOLVE_MODEL_BATCH_REL_RMS,
         f"{label} solve_filter vs its schedule model")

    # the lane form on the first LANE_CENTERS of those centers
    xl = lanes_of({k: v[:LANE_CENTERS] for k, v in xm.items()})
    field = field[:LANE_CENTERS].permute(1, 2, 0)
    moments = lane_moments(xl)
    sm = lambda: ts.solve_matrices(  # noqa: E731
        *moments, 1e-8, npx=npx, sweeps=SOLVE_SWEEPS)
    sm_plain = lambda: ts.solve_matrices_plain(  # noqa: E731
        *moments, 1e-8, npx=npx)
    lane = sm()
    lane_p, plain_ms = timed_once(sm_plain)
    want = lane_field(lane_p, xl)
    got = lane_field(lane, xl)
    rel_l = rel_rms(got, want)
    rel_c = rel_rms(got, field)
    res["solve_matrices"] = (float((got - want).abs().max()),
                             cuda_ms(sm, reps), plain_ms, bounds.solve_matrices(
                                 xl["n"].shape[1], d, SOLVE_SWEEPS))
    print(f"[2] {label} lane solve_matrices on the moments of the first "
          f"{xl['n'].shape[1]} of those centers: "
          f"filtered field vs float64 twin rel rms {rel_l:.3e}, vs "
          f"solve_filter's kernel {rel_c:.3e} (limit {BATCH_REL_RMS:g}); "
          f"raw a2t rms {rmse(lane[0].cpu(), lane_p[0].cpu()):.3e}; kernel "
          f"{res['solve_matrices'][1]:.3f} ms, twin "
          f"{res['solve_matrices'][2]:.3f} ms, bound "
          f"{res['solve_matrices'][3][0]:.3f} ms", flush=True)
    need(max(rel_l, rel_c) < BATCH_REL_RMS, f"{label} solve_matrices")
    return res


def device_time_table(label, run) -> None:
    """One traced ``run()``: wall, device busy and idle share, and the top
    device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(ev):
        return (getattr(ev, "self_device_time_total", None)
                or getattr(ev, "self_cuda_time_total", 0) or 0)

    rows = sorted(((device_us(ev), ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"{label} traced run: wall {wall:.4f} s, device busy {busy:.4f} s "
          f"(idle share {max(0.0, 1 - busy / wall):.3f}); top device time "
          "by kernel:", flush=True)
    for us, calls, key in rows[:12]:
        print(f"    {us / 1e3:10.3f} ms  {calls:6d} calls  {key[:90]}",
              flush=True)


def run_quiet(fn, *args, **kwargs):
    """(fn(...), its standard output): a CLI's prints, for parsing."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args, **kwargs)
    return rc, buf.getvalue()


def check_against_standin(label, nb, mean, cov, histo, ref):
    """The accumulator's statistics (numpy) against the float64 stand-in's
    (color, nb, histo, cov), within the ACC_* limits."""
    r_mean, r_nb, r_histo, r_cov = ref
    need(np.array_equal(nb, r_nb), f"{label}: nb not exact")
    e_mean = float(np.max(np.abs(mean - r_mean)
                          / (np.abs(r_mean) + 1e-30)))
    m0, m1, m2 = (r_mean[..., i] for i in range(3))
    scale = np.abs(r_cov) + np.abs(np.stack(
        [m0 * m0, m1 * m1, m2 * m2, m1 * m2, m0 * m2, m0 * m1], axis=-1))
    e_cov = float(np.max(np.abs(cov - r_cov) / (scale + 1e-30)))
    e_histo = float(np.max(np.abs(histo - r_histo)))
    print(f"[6] {label} vs the float64 stand-in: nb exact; mean max rel err "
          f"{e_mean:.3e} (limit {ACC_MEAN_RTOL:g}); cov max err over "
          f"|cov| + |mean_i mean_j| {e_cov:.3e} (limit {ACC_COV_REL:g}), max "
          f"abs {float(np.max(np.abs(cov - r_cov))):.3e}; histo max abs err "
          f"{e_histo:.3e} (limit {ACC_HISTO_ATOL:g})", flush=True)
    need(e_mean <= ACC_MEAN_RTOL and e_cov <= ACC_COV_REL
         and e_histo <= ACC_HISTO_ATOL, f"{label} against the stand-in")


def ingest_phase(dev, card, clean) -> None:
    """Phase 6: raw dump -> raw2bcd on the card -> bcd --stats, the API and
    the batch CLI, at 1088x1920, INGEST_SPP spp, RGBA."""
    import shutil

    import torch
    from bcd_tpu_torch import batch_cli, cli, raw2bcd_cli
    from bcd_tpu_torch.chrono import PhaseStats
    from bcd_tpu_torch.convert import to_numpy
    from bcd_tpu_torch.core.api import DenoiserInputs, MultiscaleDenoiser
    from bcd_tpu_torch.core.multiscale import denoise_multiscale
    from bcd_tpu_torch.core.pipeline import denoise_pipeline
    from bcd_tpu_torch.io import image_io, raw
    from bcd_tpu_torch.ops import _build, bounds
    from bcd_tpu_torch.ops.accumulator import SamplesAccumulator
    from bcd_tpu_torch.params import DenoiserParameters, PipelineParameters
    from make_test_scene import sample_noisy

    height, width = clean.shape[:2]
    mpix = height * width / 1e6
    work = os.path.join(WORK, "ingest")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    rgb = sample_noisy(clean, INGEST_SPP, 0)
    samples = np.concatenate(
        [rgb, np.ones(rgb.shape[:3] + (1,), np.float32)], axis=-1)
    dump = os.path.join(work, "scene.raw")
    raw.write_raw(dump, samples)
    dump_gb = os.path.getsize(dump) / 1e9
    print(f"[6] {width}x{height}, {INGEST_SPP} spp RGBA: samples and a "
          f"{dump_gb:.3f} GB raw dump in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    ref = accumulate_statistics(rgb)
    print(f"[6] float64 stand-in statistics in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # raw2bcd through its entry point, in process, on the card
    prefix = os.path.join(work, "frame")
    SamplesAccumulator(1, 1, device=dev).add_samples(samples[:1, :1])
    torch.cuda.synchronize()
    st = PhaseStats()
    t0 = time.perf_counter()
    rc, log = run_quiet(raw2bcd_cli.main, [dump, prefix], stats=st)
    wall = time.perf_counter() - t0
    need(rc == 0, f"raw2bcd: rc {rc}\n{log}")
    tm = st.timers
    print(f"[6] python -m bcd_tpu_torch.raw2bcd_cli (in process) on {card}: "
          f"{wall:.3f} s wall = dump read {tm['dump read']:.3f} s + "
          f"accumulate {tm['accumulate']:.3f} s (device, by CUDA events, "
          f"{tm['accumulate, device']:.4f} s, uploads included) + EXR write "
          f"{tm['EXR write']:.3f} s; {mpix / wall:.3f} MPix/s, "
          f"{dump_gb / wall:.3f} GB/s of dump", flush=True)
    histo_f, nb_f = image_io.separate_nb_of_samples_from_histogram(
        image_io.load_multi_channels_exr(prefix + "_hist.exr"))
    cov_f = image_io.load_multi_channels_exr(prefix + "_cov.exr")
    color_f = image_io.load_exr(prefix + ".exr")
    half = float(np.max(np.abs(color_f - ref[0]) / (np.abs(ref[0]) + 1e-30)))
    need(half <= 2 ** -10, "raw2bcd color file beyond half precision")

    # the accumulator twice on the card (row blocks of 64 already on the
    # device, so the events time the device work alone), against the
    # stand-in and the raw2bcd files
    dev_samples = torch.as_tensor(samples, device=dev)
    runs, ms = [], []
    for _ in range(2):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        acc = SamplesAccumulator(height, width, device=dev)
        for row0 in range(0, height, raw2bcd_cli.ROWS_PER_BLOCK):
            acc.add_samples(
                dev_samples[row0 : row0 + raw2bcd_cli.ROWS_PER_BLOCK],
                row0=row0)
        runs.append(acc.extract_samples_statistics())
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    del dev_samples
    need(all(torch.equal(a, b) for a, b in zip(*runs)),
         "accumulator not bitwise repeatable on the card")
    nb, mean, cov, histo = (to_numpy(x) for x in runs[0])
    bound = bounds.accumulate(height * width, INGEST_SPP, 20)
    print(f"[6] accumulator on device-resident row blocks: {ms[0]:.3f} / "
          f"{ms[1]:.3f} ms (CUDA events), bitwise repeatable; bound "
          f"{bound[0]:.3f} ms ({bound[1]})", flush=True)
    check_against_standin("accumulator", nb, mean, cov, histo, ref)
    need(np.array_equal(nb_f, nb) and np.array_equal(histo_f, histo)
         and np.array_equal(cov_f, cov),
         "raw2bcd's files differ from the accumulator on device blocks")
    print(f"[6] raw2bcd's hist and cov files bitwise the accumulator's; color "
          f"file within half precision (max rel err {half:.3e})", flush=True)
    del samples, rgb

    # bcd --stats on the EXRs, against a plain run
    out_plain, out_stats = prefix + "_out.exr", prefix + "_out_stats.exr"
    argv = ["-i", prefix + ".exr", "-p", "1", "-s", "3"]
    launches, walls, logs = [], [], []
    for out, extra in ((out_plain, []), (out_stats, ["--stats"])):
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, log = run_quiet(cli.main, argv + ["-o", out] + extra)
        walls.append(time.perf_counter() - t0)
        launches.append(dict(_build.LAUNCHES))
        logs.append(log)
        need(rc == 0, f"bcd {' '.join(extra)}: rc {rc}\n{log}")
    for name in R1_KERNELS:
        need(launches[1][name] > 0, f"bcd --stats did not launch {name}")
    need(launches[0] == launches[1], "--stats changed the launches")
    plain, with_stats = (image_io.load_exr(p) for p in (out_plain, out_stats))
    need(np.array_equal(plain, with_stats), "--stats changed the output")
    counters = dict(line.rsplit(": ", 1) for line in logs[1].splitlines()
                    if line.startswith("pixels: "))
    main_n, fb_n, managed = (int(counters[f"pixels: {k}"]) for k in (
        "main-path solves", "fallback (mean patch)", "managed"))
    interior = sum((height // 2 ** s - 2) * (width // 2 ** s - 2)
                   for s in range(3))
    print(f"[6] bcd --stats (-p 1 -s 3): {walls[1]:.3f} s wall (plain "
          f"{walls[0]:.3f} s), launches {launches[1]} as the plain run's, "
          f"output bitwise the plain run's; pixels: main-path {main_n}, "
          f"fallback {fb_n}, managed {managed} (interior of the 3 scales "
          f"{interior}); main-path share {main_n / managed:.4f}", flush=True)
    print("\n".join("    " + line for line in logs[1].splitlines()
                    if line.startswith(("pixels", "Chronometers", "  "))),
          flush=True)
    need(main_n + fb_n == managed == interior, "--stats counters")
    e_out, e_in = rmse(plain, clean), rmse(color_f, clean)
    print(f"[6] rmse vs clean: output {e_out:.5f}, noisy input {e_in:.5f}",
          flush=True)
    need(e_out < e_in, "the 16 spp output is not closer to the clean image")

    # the stats overhead in memory: plain, stats, stats, plain
    stats_dev = [torch.as_tensor(x, device=dev) for x in (mean, nb, histo,
                                                          cov)]
    pipeline = PipelineParameters()
    times = {"plain": [], "stats": []}
    for kind in ("plain", "stats", "stats", "plain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        denoise_pipeline(*stats_dev, dev, pipeline,
                         stats=PhaseStats() if kind == "stats" else None)
        torch.cuda.synchronize()
        times[kind].append(time.perf_counter() - t0)
    print(f"[6] denoise_pipeline 1088x1920 in memory, in turns plain, "
          f"stats, stats, plain: plain {['%.4f' % x for x in times['plain']]}"
          f" s, with stats {['%.4f' % x for x in times['stats']]} s",
          flush=True)

    # the in-memory API on the accumulator's statistics
    mean_t, nb_t, histo_t, cov_t = (runs[0][1], runs[0][0], runs[0][3],
                                    runs[0][2])
    ref_api = to_numpy(denoise_multiscale(mean_t, nb_t, histo_t, cov_t,
                                          DenoiserParameters(), dev,
                                          nb_of_scales=3))
    den = MultiscaleDenoiser(nb_of_scales=3, device=dev)
    den.set_inputs(DenoiserInputs(mean_t, nb_t, histo_t, cov_t))
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    need(den.denoise(), "MultiscaleDenoiser.denoise refused its inputs")
    api_s = time.perf_counter() - t0
    api_launches = dict(_build.LAUNCHES)
    got = den.get_outputs().denoised_colors
    need(got.dtype == np.float32 and np.array_equal(got, ref_api),
         "MultiscaleDenoiser differs from denoise_multiscale")
    for name in R1_KERNELS:
        need(api_launches[name] > 0, f"the API did not launch {name}")
    print(f"[6] MultiscaleDenoiser(3) on the accumulator's tensors: "
          f"{api_s:.4f} s a frame (download included), bitwise "
          f"denoise_multiscale's; launches {api_launches}", flush=True)
    del runs, stats_dev, mean_t, nb_t, histo_t, cov_t

    # the batch CLI: two copies of the frame and one without its _cov file
    frames = []
    for name, suffixes in (("a", ("", "_hist", "_cov")),
                           ("b", ("", "_hist", "_cov")),
                           ("broken", ("", "_hist"))):
        for suffix in suffixes:
            os.link(prefix + suffix + ".exr",
                    os.path.join(work, name + suffix + ".exr"))
        frames.append(os.path.join(work, name + ".exr"))
    preset = os.path.join(work, "preset.bcd.json")
    with open(preset, "w") as f:
        json.dump({"nbOfScales": 3, "performSpikeRemovalPrefiltering": True,
                   "searchWindowRadius": 6, "patchRadius": 1}, f)
    outdir = os.path.join(work, "batch")
    argv = frames + ["-a", preset, "-o", outdir]
    t0 = time.perf_counter()
    rc, log = run_quiet(batch_cli.main, argv)
    batch_s = time.perf_counter() - t0
    need(rc == 1 and "2/3 frames" in log,
         f"batch CLI: rc {rc}, expected 1 with 2/3 frames\n{log}")
    for name in ("a", "b"):
        out = image_io.load_exr(os.path.join(outdir,
                                             name + "_BCDfiltered.exr"))
        need(np.array_equal(out, plain),
             f"batch frame {name} differs from the CLI run")
    rc, log2 = run_quiet(batch_cli.main, argv + ["--resume"])
    need(rc == 1 and "resume: skipping 2 already-denoised frames" in log2
         and "0/1 frames" in log2, f"batch --resume\n{log2}")
    print(f"[6] batch CLI, 2 frames + 1 broken: rc 1, "
          f"{log.strip().splitlines()[-1]!r} ({batch_s / 2:.3f} s a frame "
          f"with EXR I/O), outputs bitwise the CLI's; --resume skipped both",
          flush=True)
    shutil.rmtree(work)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")
    need(os.path.isdir(os.path.join(HERE, "bcd_tpu_torch")),
         "bcd_tpu_torch/ is not beside this script: run it from a checkout "
         "of the repo")
    sys.path.insert(0, HERE)
    from bcd_tpu_torch import cli
    from bcd_tpu_torch.io import image_io
    from bcd_tpu_torch.params import DenoiserParameters, PipelineParameters
    from bcd_tpu_torch.core.monoscale import MonoscaleConfig, denoise_monoscale
    from bcd_tpu_torch.core.multiscale import denoise_multiscale
    from bcd_tpu_torch.core.pipeline import denoise_pipeline
    from bcd_tpu_torch.ops import _build
    from bcd_tpu_torch.ops.spike_removal import spike_removal
    from bcd_tpu_torch.ops.solve_filter import (
        D, solve_matrices_pm, solve_matrices_pm_plain,
        solve_matrices_pm_schedule)

    params = DenoiserParameters(search_window_radius=6)
    cfg = MonoscaleConfig()

    # --- 1. the card and the build --------------------------------------
    dev = torch.device("cuda", 0)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[1] device: {kind}, count {count}; card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    log = _build.build_log()
    print(f"[1] kernels built for sm_90a in {time.perf_counter() - t0:.1f} s "
          "(nvcc -Xptxas -v):", flush=True)
    entry, k2_spill = "", None
    for line in log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("    " + line.strip(), flush=True)
        if "Compiling entry" in line:
            entry = line
        elif "spill stores" in line and "solve_matrices_pm_kernel" in entry:
            k2_spill = [int(w) for w in line.replace(",", " ").split()
                        if w.isdigit()]
    need(k2_spill is not None, "no -Xptxas -v report for K2's kernel")
    print(f"[1] K2 solve_matrices_pm_kernel: stack frame, spill stores, "
          f"spill loads = {k2_spill} bytes", flush=True)
    need(k2_spill[1:] == [0, 0], "K2's kernel spills registers")

    kernels = {}

    # --- 2. kernels vs twins ---------------------------------------------
    rng = np.random.default_rng(99)
    m2, misc = (x.to(dev) for x in synthetic_moments(rng))
    a2t, small = solve_matrices_pm(m2, misc, 1e-8, sweeps=6)
    a2t_p, small_p = solve_matrices_pm_plain(m2, misc, 1e-8)
    e = max(rmse(a2t.cpu(), a2t_p.cpu()),
            rmse(small[:, :D].cpu(), small_p[:, :D].cpu()))
    print(f"[2] K2 sweeps=6 on synthetic moments vs float64 twin: rms "
          f"{e:.3e} (limit 2e-4)", flush=True)
    need(e < 2e-4, "K2 synthetic rms")
    a2t, small = solve_matrices_pm(m2, misc, 1e-8, sweeps=cfg.solve_sweeps)
    a2t_m, small_m = solve_matrices_pm_schedule(m2, misc, 1e-8,
                                                cfg.solve_sweeps)
    e = max(rmse(a2t.cpu(), a2t_m.cpu()), rmse(small.cpu(), small_m.cpu()))
    print(f"[2] K2 sweeps={cfg.solve_sweeps} on synthetic moments vs the fp32 "
          f"model of its schedule: rms {e:.3e} (limit {K2_MODEL_RMS:g})",
          flush=True)
    need(e < K2_MODEL_RMS and torch.equal(small[:, D], small_m[:, D]),
         "K2 against its schedule model")

    color, nb, histo, cov, gold_mono, gold_multi = load_golden()
    res_g = compare_kernels(
        "golden", tile_batch_inputs(cfg, color, nb, histo, cov, dev),
        params, cfg, reps=10)
    t0 = time.perf_counter()
    clean, stats = full_scene()
    print(f"[4] 1088x1920 scene, 4 spp, statistics in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    res_f = compare_kernels(
        "full-size", tile_batch_inputs(cfg, *stats, dev, batch=8),
        params, cfg, reps=5)
    for k in ("K1", "K2", "K4"):
        kernels[k] = (max(res_g[k][0], res_f[k][0]),) + res_f[k][1:]

    # solve_filter and the lane solve_matrices: synthetic, then one real
    # 16-tile batch of the -w 2 run's finest scale (after the prefilter)
    e_syn = compare_solve_synthetic(dev)
    thr = params.histogram_distance_threshold
    pre = spike_removal(*(torch.as_tensor(a, device=dev) for a in stats),
                        PipelineParameters().prefiltering
                        .spike_removal_threshold_stdev_factor)
    frac2 = r2_main_fraction(pre, dev, thr)
    print(f"[2] 1088x1920 finest scale at r=2, b=6, threshold {thr:g}: "
          f"main-path fraction {frac2:.4f}", flush=True)
    res_s = compare_solve_batch("full-size r=2 batch 8", *r2_batch(
        pre, dev, thr), reps=3)
    if frac2 < 0.1:  # too few main-path centers: also where there are more
        res_hi = compare_solve_batch("full-size r=2 batch 8 at threshold 4",
                                     *r2_batch(pre, dev, 4.0), reps=3)
        res_s = {k: (max(res_s[k][0], res_hi[k][0]),) + res_s[k][1:]
                 for k in res_s}
    for k in res_s:
        kernels[k] = (max(res_s[k][0], e_syn),) + res_s[k][1:]
    del pre  # 585 MB of r = 2 inputs: not part of the -w 1 peak below

    # --- 3. goldens on the card ------------------------------------------
    for tile in (16, 32):
        out = denoise_monoscale(color, nb, histo, cov, params, dev, tile=tile)
        e_mono = rmse(out.cpu(), gold_mono)
        out = denoise_multiscale(color, nb, histo, cov, params, dev,
                                 nb_of_scales=2, tile=tile)
        e_multi = rmse(out.cpu(), gold_multi)
        print(f"[3] goldens (tile {tile}): out_mono_b6 rmse {e_mono:.3e}, "
              f"out_multi2_b6 rmse {e_multi:.3e} (limit 1e-4)", flush=True)
        need(e_mono < 1e-4 and e_multi < 1e-4, "golden rmse")
    frac = main_path_fraction(cfg, color, nb, histo, cov, params, dev)
    print(f"[3] golden main-path fraction (gate sum / managed pixels): "
          f"{frac:.4f}", flush=True)
    need(frac > 0.1, "the golden scene barely reaches the main path")

    # --- 4. the default bcd run through the CLI entry point --------------
    os.makedirs(WORK, exist_ok=True)
    paths = {k: os.path.join(WORK, f"scene{k}.exr")
             for k in ("", "_hist", "_cov", "_out")}
    s_color, s_nb, s_histo, s_cov = stats
    t0 = time.perf_counter()
    image_io.write_exr(s_color, paths[""])
    image_io.write_multi_channels_exr(
        image_io.merge_histogram_and_nb_of_samples(s_histo, s_nb),
        paths["_hist"])
    image_io.write_multi_channels_exr(s_cov, paths["_cov"])
    print(f"[4] wrote the scene's EXRs in {time.perf_counter() - t0:.1f} s",
          flush=True)
    argv = ["-i", paths[""], "-o", paths["_out"]]
    need(cli.main(argv) == 0, "warm-up CLI run")
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    cli_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    need(rc == 0, "CLI run")
    print(f"[4] python -m bcd_tpu_torch.cli {' '.join(argv)}: rc {rc}, "
          f"{cli_s:.3f} s wall with EXR I/O; launches {launches}", flush=True)
    for name in R1_KERNELS:
        need(launches[name] > 0,
             f"kernel {name} was not launched by the -w 1 path")
    out = image_io.load_exr(paths["_out"])
    need(out.shape == clean.shape and np.isfinite(out).all(),
         "CLI output shape / finiteness")
    e_out, e_in = rmse(out, clean), rmse(s_color, clean)
    print(f"[4] rmse vs clean: output {e_out:.5f}, noisy input {e_in:.5f}",
          flush=True)
    need(e_out < e_in, "the denoised output is not closer to the clean image")

    pipeline = PipelineParameters()
    dev_stats = [torch.as_tensor(x, device=dev) for x in stats]
    denoise_pipeline(*dev_stats, dev, pipeline)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        denoise_pipeline(*dev_stats, dev, pipeline)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    mpix = clean.shape[0] * clean.shape[1] / 1e6
    frac = main_path_fraction(cfg, *stats, params, dev)
    print(f"[4] denoise_pipeline 1088x1920 -p 1 -s 3 b=6 r=1 on {card}: "
          f"times {['%.4f' % x for x in times]} s, median "
          f"{sorted(times)[1]:.4f} s = {mpix / sorted(times)[1]:.4f} MPix/s; "
          f"peak memory {peak / 2**20:.1f} MiB; finest-scale main-path "
          f"fraction {frac:.4f}", flush=True)

    # the 4-sweep K2 end to end: the same pipeline with K2's float64 twin
    # in its place, held to the goldens' bound
    from bcd_tpu_torch.core import fused as core_fused

    out_k2 = denoise_pipeline(*dev_stats, dev, pipeline)
    core_fused.solve_matrices_pm = (
        lambda m2, misc, eps, sweeps: solve_matrices_pm_plain(m2, misc, eps))
    try:
        out_twin = denoise_pipeline(*dev_stats, dev, pipeline)
    finally:
        core_fused.solve_matrices_pm = solve_matrices_pm
    gap = rmse(out_k2.cpu(), out_twin.cpu())
    print(f"[4] denoise_pipeline 1088x1920 with K2 vs with its float64 twin: "
          f"rmse {gap:.3e} (limit {E2E_K2_RMSE:g}), max abs "
          f"{float((out_k2 - out_twin).abs().max()):.3e}; rmse vs clean "
          f"{rmse(out_k2.cpu(), clean):.6f} (K2) and "
          f"{rmse(out_twin.cpu(), clean):.6f} (twin)", flush=True)
    need(gap < E2E_K2_RMSE, "K2 against its twin end to end")

    device_time_table("[4]", lambda: denoise_pipeline(*dev_stats, dev,
                                                      pipeline))

    # --- 5. the -w 2 path ---------------------------------------------------
    argv2 = argv[:2] + [paths["_out"].replace("_out", "_out_w2"), "-w", "2"]
    argv2[2:2] = ["-o"]
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv2)
    cli2_s = time.perf_counter() - t0
    launches2 = dict(_build.LAUNCHES)
    need(rc == 0, "-w 2 CLI run")
    print(f"[5] python -m bcd_tpu_torch.cli {' '.join(argv2)}: rc {rc}, "
          f"{cli2_s:.3f} s wall with EXR I/O; launches {launches2}",
          flush=True)
    for name in R2_KERNELS:
        need(launches2[name] > 0,
             f"kernel {name} was not launched by the -w 2 path")
    out2 = image_io.load_exr(argv2[3])
    need(out2.shape == clean.shape and np.isfinite(out2).all(),
         "-w 2 CLI output shape / finiteness")
    e_out2 = rmse(out2, clean)
    print(f"[5] rmse vs clean: -w 2 output {e_out2:.5f}, -w 1 output "
          f"{e_out:.5f}, noisy input {e_in:.5f}; finest-scale main-path "
          f"fraction {frac2:.4f}", flush=True)
    need(e_out2 < e_in, "the -w 2 output is not closer to the clean image")

    p2 = PipelineParameters()
    p2.denoiser.monoscale.patch_radius = 2
    crop = [x[:64, :64].contiguous() for x in dev_stats]
    denoise_pipeline(*crop, dev, p2)  # warm-up on a small crop
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, outs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        outs.append(denoise_pipeline(*dev_stats, dev, p2))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak2 = torch.cuda.max_memory_allocated()
    need(torch.equal(outs[0], outs[1]), "-w 2 pipeline not bitwise repeatable")
    print(f"[5] denoise_pipeline 1088x1920 -p 1 -s 3 b=6 r=2 on {card}: "
          f"times {['%.4f' % x for x in times]} s, "
          f"{mpix / min(times):.4f} MPix/s at the faster; peak memory "
          f"{peak2 / 2**20:.1f} MiB; bitwise repeatable", flush=True)

    got = denoise_pipeline(*crop, dev, p2)
    need(torch.equal(got, denoise_pipeline(*crop, dev, p2)),
         "-w 2 crop not bitwise repeatable")
    t0 = time.perf_counter()
    ref = denoise_pipeline(*(x.cpu() for x in crop), torch.device("cpu"), p2)
    cpu_s = time.perf_counter() - t0
    gap = rmse(got.cpu(), ref)
    print(f"[5] -w 2 pipeline on a 64x64 crop (b=6): card vs the port's CPU "
          f"pipeline (float64 twins, {cpu_s:.1f} s) rmse {gap:.3e} (limit "
          f"{R2_CPU_RMSE:g}), max abs "
          f"{float((got.cpu() - ref).abs().max()):.3e}; bitwise repeatable "
          "on the card", flush=True)
    need(gap < R2_CPU_RMSE, "-w 2 on the card against the CPU pipeline")
    device_time_table("[5]", lambda: denoise_pipeline(*dev_stats, dev, p2))
    del dev_stats, crop, outs, got

    # --- 6. ingest and the renderer surface --------------------------------
    t0 = time.perf_counter()
    ingest_phase(dev, card, clean)
    print(f"[6] phase 6 in {time.perf_counter() - t0:.1f} s", flush=True)

    # --- 7. results --------------------------------------------------------
    meta = {
        "K1": ("masks_moments", "bcd_tpu_torch/csrc/masks_moments.cu",
               "bcd_tpu/ops/fused_pallas.py:429"),
        "K2": ("solve_matrices_pm", "bcd_tpu_torch/csrc/solve_matrices_pm.cu",
               "bcd_tpu/ops/solve_filter_pallas.py:751"),
        "K4": ("apply_scatter", "bcd_tpu_torch/csrc/apply_scatter.cu",
               "bcd_tpu/ops/fused_pallas.py:694"),
        "solve_filter": ("solve_filter", "bcd_tpu_torch/csrc/solve_filter.cu",
                         "bcd_tpu/ops/solve_filter_pallas.py:441"),
        # the lane form is on no path of the engine (JAX's neither); its
        # launch count is that of the -w 2 run, 0
        "solve_matrices": ("solve_matrices",
                           "bcd_tpu_torch/csrc/solve_filter.cu",
                           "bcd_tpu/ops/solve_filter_pallas.py:594"),
    }
    runs = {**launches, "solve_filter": launches2["solve_filter"],
            "solve_matrices": launches2["solve_matrices"]}
    print(json.dumps({"kernels": [
        {"name": k if k == meta[k][0] else f"{k} {meta[k][0]}",
         "route": "cuda", "source": meta[k][1], "replaces": meta[k][2],
         "launches": runs[meta[k][0]], "max_abs_err": kernels[k][0],
         "ms": kernels[k][1], "plain_ms": kernels[k][2],
         "bound_ms": kernels[k][3][0], "bound_by": kernels[k][3][1],
         # no single PyTorch call computes any of these functions (PERF.md)
         "library_ms": None} for k in meta]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
