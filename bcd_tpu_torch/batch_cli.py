"""Renderfarm batch mode: denoise many frames driven by .bcd.json presets
(port of ``bcd_tpu/batch_cli.py``).

The reference's renderfarm story is one bcd_cli process per frame sharing a
JSON preset (reference README). Here one process takes a whole frame set.
With ``--batch``, frames of identical geometry are grouped and denoised
over the devices (``bcd_tpu_torch.parallel.frames``); otherwise each frame
runs the full pipeline. Per-frame job isolation: a failing frame is
reported and skipped, not fatal (the reference exits), and the exit code is
then 1.

Usage:
  python -m bcd_tpu_torch.batch_cli -a preset.bcd.json -o OUTDIR frame1.exr ...
  python -m bcd_tpu_torch.batch_cli -o OUTDIR --suffix _den --device cpu frames/*.exr

Each input color EXR must have its `_hist.exr` / `_cov.exr` siblings
(raw2bcd layout). Preset denoiser parameters apply to every frame.
``--device`` (default ``cuda``: every card; ``cuda:N`` one of them) picks
where; with no CUDA device the run fails unless it says ``--device cpu``.
As JAX's, the ``--batch`` path runs monoscale presets only and skips the
preset's spike-removal prefilter (``denoise_frames`` takes the statistics
as they are).
"""

from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict
from typing import List

import numpy as np
import torch

from bcd_tpu_torch import params as P
from bcd_tpu_torch.convert import resolve_device, to_numpy
from bcd_tpu_torch.core.pipeline import denoise_pipeline, sanitize_output
from bcd_tpu_torch.io import image_io


def load_frame(color_path: str):
    stem = color_path[:-4] if color_path.endswith(".exr") else color_path
    color = image_io.load_exr(color_path)
    if color.shape[-1] == 1:
        color = np.repeat(color, 3, axis=-1)
    # the covariances before the histograms: a frame without one of its
    # files fails before its 3 * bins + 1 FLOAT channels are inflated
    cov = image_io.load_multi_channels_exr(stem + "_cov.exr")
    hist_and_count = image_io.load_multi_channels_exr(stem + "_hist.exr")
    histo, nb = image_io.separate_nb_of_samples_from_histogram(hist_and_count)
    return color, nb, histo, cov


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Batch-denoise frames with a shared .bcd.json preset")
    ap.add_argument("frames", nargs="+", help="input color EXRs")
    ap.add_argument("-a", "--preset", help=".bcd.json preset")
    ap.add_argument("-o", "--outdir", required=True)
    ap.add_argument("--suffix", default="_BCDfiltered")
    ap.add_argument("--tile", type=int, default=None)
    ap.add_argument("--batch", action="store_true",
                    help="batch same-geometry frames across devices "
                         "(monoscale only)")
    ap.add_argument("--resume", action="store_true",
                    help="skip frames whose output already exists "
                         "(preemption-safe renderfarm runs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default, every card), "
                         "cuda:N or cpu")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except ValueError as e:
        print(f"ERROR: {e}")
        return 1
    pipeline = P.PipelineParameters()
    if args.preset:
        P.load_pipeline_json(args.preset, pipeline)
    os.makedirs(args.outdir, exist_ok=True)

    def out_path(frame):
        base = os.path.basename(frame)
        stem = base[:-4] if base.endswith(".exr") else base
        return os.path.join(args.outdir, stem + args.suffix + ".exr")

    start = time.perf_counter()
    failures = 0

    if args.resume:
        skipped = [f for f in args.frames if os.path.exists(out_path(f))]
        if skipped:
            print(f"resume: skipping {len(skipped)} already-denoised frames")
        args.frames = [f for f in args.frames if not os.path.exists(out_path(f))]

    if args.batch and pipeline.denoiser.nb_of_scales == 1:
        from bcd_tpu_torch.parallel.frames import denoise_frames

        groups = defaultdict(list)
        loaded = {}
        for frame in args.frames:
            try:
                loaded[frame] = load_frame(frame)
                groups[loaded[frame][0].shape].append(frame)
            except Exception as e:
                print(f"ERROR loading {frame}: {e}")
                failures += 1
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if device.type == "cuda" and device.index is None
                   else [device])
        for shape, frames in groups.items():
            n_dev = max(1, min(len(devices), len(frames)))
            # pad the batch to a multiple of the device count
            pad = (-len(frames)) % n_dev
            batch = frames + frames[:pad] if pad else frames
            data = [loaded[f] for f in batch]
            colors, nbs, histos, covs = (np.stack(x) for x in zip(*data))
            out = denoise_frames(colors, nbs, histos, covs,
                                 pipeline.denoiser.monoscale,
                                 devices[:n_dev], tile=args.tile)
            for i, frame in enumerate(frames):
                image_io.write_exr(to_numpy(sanitize_output(out[i])),
                                   out_path(frame))
                print(f"wrote {out_path(frame)}")
    else:
        for frame in args.frames:
            try:
                color, nb, histo, cov = load_frame(frame)
                out = denoise_pipeline(color, nb, histo, cov, device,
                                       pipeline, tile=args.tile)
                image_io.write_exr(to_numpy(out), out_path(frame))
                print(f"wrote {out_path(frame)}")
            except Exception as e:  # per-frame isolation
                print(f"ERROR denoising {frame}: {e}")
                failures += 1

    n_frames = len(args.frames)
    elapsed = time.perf_counter() - start
    print(f"{n_frames - failures}/{n_frames} frames in {elapsed:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
