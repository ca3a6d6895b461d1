#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bcd_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero before
the final line:

1. The card (name, count, power limit) and the kernel build: nvcc's
   register, shared-memory and spill report for every kernel.
2. Each kernel (K1 masks_moments, K2 solve_matrices, K4 apply_scatter)
   against its plain PyTorch twin at the main path's shapes (b=6, r=1,
   60 bins, tile 32): one tile batch of the golden scene and one of the
   full-size scene. K2 is also held to its twin through K4, on every
   pixel the batch's filters reach. Kernel and twin are timed with CUDA
   events.
3. The golden scene (tests/golden) through the port: monoscale and 2-scale
   outputs within rmse 1e-4 of the committed goldens, and the main-path
   fraction (gate sum over managed pixels).
4. The default ``bcd`` run through ``python -m bcd_tpu_torch.cli``'s entry
   point on a 1088x1920, 4 spp scene (-p 1 -s 3, b=6, r=1): the output must
   beat the noisy input against the clean render, and K1, K2 and K4 must
   each have launched. Wall time, MPix/s, peak memory; the same pipeline
   with K2's float64 twin in K2's place, within the goldens' rmse bound;
   device time by kernel from one traced run.
5. One JSON line of kernel results, the card line, and the final line
   ``{"ok": true, "device": {...}}``.

Inputs are generated from fixed seeds; nothing is downloaded. No JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "chip_smoke")
GOLDEN = os.path.join(HERE, "tests", "golden")

# K2 (4 sweeps) against its float64 twin, through K4 on every covered pixel
# of a tile batch (relative rms of the tile estimates): K2's rms bound in
# the tests, about 4x the largest reading on an H100 (5.2e-5, 1088x1920)
K2_CANDIDATE_REL_RMS = 2e-4
# the whole pipeline with K2 against it with the twin: the goldens' rmse bound
E2E_K2_RMSE = 1e-4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def need(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def rmse(a, b) -> float:
    return float(np.sqrt(np.mean(
        (np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


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
    from bcd_tpu_torch.ops.solve_filter import D, solve_matrices

    t, h, b = cfg.tile, cfg.halo, cfg.search_radius
    main = fb = 0.0
    for inputs in k1_batches(cfg, color, nb, histo, cov, device):
        _, m2, misc = masks_moments(
            *inputs, params.histogram_distance_threshold, t=t, h=h, b=b)
        _, small = solve_matrices(m2.reshape(-1, m2.shape[-1]),
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
    kernel -> (max_abs_err, ms, plain_ms)."""
    import torch
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
    res["K1"] = (err, cuda_ms(k1, reps), cuda_ms(k1_plain, 1))
    print(f"[2] {label} K1 masks_moments ({n_tiles} tiles): "
          f"{int(diff.sum())} mask mismatches of {diff.numel()} (all at the "
          f"threshold), moments max abs err {err:.3e}; kernel "
          f"{res['K1'][1]:.3f} ms, twin {res['K1'][2]:.3f} ms", flush=True)

    # K2 on the real moments (the engine's 4 sweeps) vs the float64 twin
    m2f, miscf = m2.reshape(-1, ts.DTRI), misc.reshape(-1, ts.MISC_CH)
    k2 = lambda: ts.solve_matrices(  # noqa: E731
        m2f, miscf, eps, sweeps=cfg.solve_sweeps)
    k2_plain = lambda: ts.solve_matrices_plain(m2f, miscf, eps)  # noqa: E731
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
    k2_6 = ts.solve_matrices(m2f, miscf, eps, sweeps=6)
    rel6 = rms(filtered(*k2_6) - f_p) / rms(f_p)
    res["K2"] = (err, cuda_ms(k2, reps), cuda_ms(k2_plain, 1))
    print(f"[2] {label} K2 solve_matrices ({m2f.shape[0]} pixels, "
          f"{int(main.sum())} on the main path, real K1 moments) vs float64 "
          f"twin: filtered self-candidate rel rms {rel:.3e} at "
          f"sweeps={cfg.solve_sweeps} ({rel6:.3e} at sweeps=6), max abs "
          f"err {err:.3e}; raw a2t rms {rms(a2t - a2t_p):.3e}; gates exact; "
          f"kernel {res['K2'][1]:.3f} ms, twin {res['K2'][2]:.3f} ms",
          flush=True)
    need(rel < 1e-3, f"{label} K2: filtered candidates beyond rel rms 1e-3")

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
    res["K4"] = (err, cuda_ms(k4, reps), cuda_ms(k4_plain, 1))
    print(f"[2] {label} K4 apply_scatter ({n_tiles} tiles): max abs err "
          f"{err:.3e}, counts exact, bitwise repeatable; kernel "
          f"{res['K4'][1]:.3f} ms, twin {res['K4'][2]:.3f} ms", flush=True)
    return res


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
    from bcd_tpu_torch.ops.solve_filter import (
        D, solve_matrices, solve_matrices_plain)

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
    for line in log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("    " + line.strip(), flush=True)

    params = DenoiserParameters(search_window_radius=6)
    cfg = MonoscaleConfig()
    kernels = {}

    # --- 2. kernels vs twins ---------------------------------------------
    rng = np.random.default_rng(99)
    m2, misc = (x.to(dev) for x in synthetic_moments(rng))
    a2t, small = solve_matrices(m2, misc, 1e-8, sweeps=6)
    a2t_p, small_p = solve_matrices_plain(m2, misc, 1e-8)
    e = max(rmse(a2t.cpu(), a2t_p.cpu()),
            rmse(small[:, :D].cpu(), small_p[:, :D].cpu()))
    print(f"[2] K2 sweeps=6 on synthetic moments vs float64 twin: rms "
          f"{e:.3e} (limit 2e-4)", flush=True)
    need(e < 2e-4, "K2 synthetic rms")

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
    for name, n in launches.items():
        need(n > 0, f"kernel {name} was not launched by the main path")
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
    core_fused.solve_matrices = (
        lambda m2, misc, eps, sweeps: solve_matrices_plain(m2, misc, eps))
    try:
        out_twin = denoise_pipeline(*dev_stats, dev, pipeline)
    finally:
        core_fused.solve_matrices = solve_matrices
    gap = rmse(out_k2.cpu(), out_twin.cpu())
    print(f"[4] denoise_pipeline 1088x1920 with K2 vs with its float64 twin: "
          f"rmse {gap:.3e} (limit {E2E_K2_RMSE:g}), max abs "
          f"{float((out_k2 - out_twin).abs().max()):.3e}; rmse vs clean "
          f"{rmse(out_k2.cpu(), clean):.6f} (K2) and "
          f"{rmse(out_twin.cpu(), clean):.6f} (twin)", flush=True)
    need(gap < E2E_K2_RMSE, "K2 against its twin end to end")

    # where the device time goes: one traced run, device time by kernel
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        denoise_pipeline(*dev_stats, dev, pipeline)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(ev):
        return (getattr(ev, "self_device_time_total", None)
                or getattr(ev, "self_cuda_time_total", 0) or 0)

    from torch.autograd import DeviceType

    rows = sorted(((device_us(ev), ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"[4] traced run: wall {wall:.4f} s, device busy {busy:.4f} s "
          f"(idle share {max(0.0, 1 - busy / wall):.3f}); top device time "
          "by kernel:", flush=True)
    for us, calls, key in rows[:12]:
        print(f"    {us / 1e3:10.3f} ms  {calls:6d} calls  {key[:90]}",
              flush=True)

    # --- 5. results --------------------------------------------------------
    meta = {
        "K1": ("masks_moments", "bcd_tpu_torch/csrc/masks_moments.cu",
               "bcd_tpu/ops/fused_pallas.py:429"),
        "K2": ("solve_matrices", "bcd_tpu_torch/csrc/solve_matrices.cu",
               "bcd_tpu/ops/solve_filter_pallas.py:751"),
        "K4": ("apply_scatter", "bcd_tpu_torch/csrc/apply_scatter.cu",
               "bcd_tpu/ops/fused_pallas.py:694"),
    }
    print(json.dumps({"kernels": [
        {"name": f"{k} {meta[k][0]}", "route": "cuda", "source": meta[k][1],
         "replaces": meta[k][2], "launches": launches[meta[k][0]],
         "max_abs_err": kernels[k][0], "ms": kernels[k][1],
         "plain_ms": kernels[k][2]} for k in ("K1", "K2", "K4")]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
