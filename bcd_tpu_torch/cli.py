"""Batch denoise CLI of the PyTorch port (port of ``bcd_tpu/cli.py``;
reference src/cli/main.cpp).

    python -m bcd_tpu_torch.cli -i in.exr -o out.exr [--device cuda|cpu]

Flags ``-i -o -h -c -a -d -b -w -r -p --p-factor -m -s -e --tile
--skip-stride --stats`` keep the JAX CLI's meaning, including the
``<input>_hist.exr`` / ``<input>_cov.exr`` inference when -h/-c are omitted
(main.cpp:344-370) and its exit codes. ``--device`` (default ``cuda``)
picks where the denoise runs; with no CUDA device the run fails unless it
says ``--device cpu``. On CUDA a patch radius of 3 or more fails with exit
code 1 (the solve kernel is built for radius 1 and 2).
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np

from bcd_tpu_torch import params as P
from bcd_tpu_torch.chrono import PhaseStats
from bcd_tpu_torch.io import image_io
from bcd_tpu_torch.convert import resolve_device, to_numpy


def print_usage(prog: str) -> None:
    d = P.PipelineParameters()
    mono = d.denoiser.monoscale
    print("Bayesian Collaborative Denoising (PyTorch / CUDA)\n")
    print(f"Usage: {prog} <arguments list>")
    print("Only EXR images are supported.\n")
    print("Required arguments list (unless a pipeline file is provided and contains this data):")
    print("    -o <output>          The file path to the output image")
    print("    -i <input>           The file path to the input image")
    print("    -h <hist>            The file path to the input histograms buffer")
    print("    -c <cov>             The file path to the input covariance matrices buffer")
    print("Optional arguments list:")
    print("    -a <file>            The file path to the .bcd.json file containing arguments for the program")
    print(f"    -d <float>           Histogram patch distance threshold (default: {mono.histogram_distance_threshold})")
    print(f"    -b <int>             Radius of search windows (default: {mono.search_window_radius})")
    print(f"    -w <int>             Radius of patches; on CUDA 1 or 2 (default: {mono.patch_radius})")
    print(f"    -r <0/1>             1 for random pixel order; accepted for compatibility, the engine is deterministic (default: {int(mono.use_random_pixel_order)})")
    print(f"    -p <0/1>             1 for a spike removal prefiltering (default: {int(d.prefiltering.perform_spike_removal)})")
    print(f"    --p-factor <float>   Spike prefilter threshold = factor * stddev (default: {d.prefiltering.spike_removal_threshold_stdev_factor})")
    print(f"    -m <float in [0,1]>  Probability of skipping marked patch centers; accepted for compatibility (default: {mono.marked_pixels_skipping_probability})")
    print(f"    -s <int>             Number of Scales for Multi-Scaling (default: {d.denoiser.nb_of_scales})")
    print(f"    -e <float>           Minimum eigen value for matrix inversion (default: {mono.min_eigen_value})")
    print("    --tile <int>         Processing tile size (default 32)")
    print("    --skip-stride <int>  Solve only every Nth patch center (deterministic analog of the reference's skip-marking heuristic); 1 = exact, at most 2r+1 (default: 1)")
    print("    --stats              Print a per-phase time/pixel-count report after the run (the reference's COMPUTE_DENOISING_STATS build option, always available here)")
    print("    --device <name>      Torch device: cuda (default) or cpu")


class _Args:
    def __init__(self):
        self.output_path = ""
        self.input_color_path = ""
        self.hist_path: Optional[str] = None
        self.cov_path: Optional[str] = None
        self.pipeline = P.PipelineParameters()
        self.tile: Optional[int] = None
        self.skip_stride = 1
        self.device = "cuda"
        self.stats = False


def _expect_value(argv: List[str], i: int, flag: str, msg: str) -> str:
    if i + 1 >= len(argv):
        print(f"ERROR in program arguments: expecting {msg} after '{flag}'")
        raise SystemExit(1)
    return argv[i + 1]


def parse_args(argv: List[str]) -> Optional[_Args]:
    args = _Args()
    mono = args.pipeline.denoiser.monoscale
    pre = args.pipeline.prefiltering
    i = 0
    while i < len(argv):
        flag = argv[i]
        if flag == "-a":
            path = _expect_value(argv, i, flag, "file path to the pipeline file")
            P.load_pipeline_json(path, args.pipeline)
            mono = args.pipeline.denoiser.monoscale
            pre = args.pipeline.prefiltering
            fn = args.pipeline.input_file_names
            args.input_color_path = fn.colors or args.input_color_path
            args.hist_path = fn.histograms or args.hist_path
            args.cov_path = fn.covariances or args.cov_path
        elif flag == "-o":
            args.output_path = _expect_value(argv, i, flag, "file path to the output image")
        elif flag == "-i":
            args.input_color_path = _expect_value(argv, i, flag, "file path to the input color image")
        elif flag == "-h":
            args.hist_path = _expect_value(argv, i, flag, "file path to the input histogram image")
        elif flag == "-c":
            args.cov_path = _expect_value(argv, i, flag, "file path to the input covariance matrix image")
        elif flag == "-d":
            mono.histogram_distance_threshold = float(_expect_value(argv, i, flag, "histogram patch distance threshold"))
        elif flag == "-b":
            mono.search_window_radius = int(_expect_value(argv, i, flag, "radius of search window"))
        elif flag == "-w":
            mono.patch_radius = int(_expect_value(argv, i, flag, "radius of patch"))
        elif flag == "-e":
            mono.min_eigen_value = float(_expect_value(argv, i, flag, "minimum eigen value"))
        elif flag in ("-r", "-p"):
            v = _expect_value(argv, i, flag, "0 or 1")
            if v not in ("0", "1"):
                print(f"ERROR in program arguments: expecting 0 or 1 after '{flag}'")
                return None
            if flag == "-r":
                mono.use_random_pixel_order = v == "1"
            else:
                pre.perform_spike_removal = v == "1"
        elif flag == "--p-factor":
            pre.spike_removal_threshold_stdev_factor = float(
                _expect_value(argv, i, flag, "standard deviation factor"))
        elif flag == "-m":
            v = float(_expect_value(argv, i, flag, "float in [0,1]"))
            if not 0.0 <= v <= 1.0:
                print("ERROR in program arguments: expecting float in [0,1] after '-m'")
                return None
            mono.marked_pixels_skipping_probability = v
        elif flag == "-s":
            args.pipeline.denoiser.nb_of_scales = int(
                _expect_value(argv, i, flag, "number of scales"))
        elif flag == "--tile":
            args.tile = int(_expect_value(argv, i, flag, "tile size"))
        elif flag == "--device":
            args.device = _expect_value(argv, i, flag, "a torch device name")
        elif flag == "--skip-stride":
            args.skip_stride = int(_expect_value(argv, i, flag, "stride"))
        elif flag == "--stats":
            args.stats = True
            i += 1
            continue
        else:
            i += 1  # unknown tokens skipped, like the reference parser
            continue
        i += 2

    # validated after the loop so it can't depend on -w argument order
    if mono.patch_radius < 1:
        print(f"ERROR in program arguments: patch radius {mono.patch_radius} "
              "must be >= 1")
        return None
    if not 1 <= args.skip_stride <= 2 * mono.patch_radius + 1:
        print("ERROR in program arguments: --skip-stride must be in "
              f"[1, {2 * mono.patch_radius + 1}] (= patch diameter, so the "
              "patch aggregation still covers every pixel)")
        return None

    # infer _hist/_cov from the color path when omitted (main.cpp:344-370)
    if args.input_color_path:
        stem = args.input_color_path[:-4] if args.input_color_path.endswith(".exr") else args.input_color_path
        if not args.hist_path:
            args.hist_path = stem + "_hist.exr"
            print(f"Warning: input histogram file not provided by -h argument: assuming '{args.hist_path}'")
        if not args.cov_path:
            args.cov_path = stem + "_cov.exr"
            print(f"Warning: input covariance file not provided by -c argument: assuming '{args.cov_path}'")

    missing = [flag for flag, value in (
        ("-i", args.input_color_path), ("-h", args.hist_path),
        ("-c", args.cov_path), ("-o", args.output_path)) if not value]
    if missing:
        print("ERROR: Missing required program argument(s): " + " ".join(missing))
        print()
        print_usage("python -m bcd_tpu_torch.cli")
        return None
    return args


def launch(argv: List[str]) -> int:
    args = parse_args(argv)
    if args is None:
        return 1
    try:
        device = resolve_device(args.device)
    except ValueError as e:
        print(f"ERROR: {e}")
        return 1
    if device.type == "cuda":
        from bcd_tpu_torch.ops.solve_filter import check_kernel_dim

        try:
            check_kernel_dim(3 * (2 * args.pipeline.denoiser.monoscale
                                  .patch_radius + 1) ** 2)
        except NotImplementedError as e:
            print(f"ERROR: {e}")
            return 1

    try:
        color = image_io.load_exr(args.input_color_path)
        if color.shape[-1] == 1:
            color = np.repeat(color, 3, axis=-1)
        histo, nb = image_io.separate_nb_of_samples_from_histogram(
            image_io.load_multi_channels_exr(args.hist_path))
        cov = image_io.load_multi_channels_exr(args.cov_path)
    except Exception as e:  # missing file, truncated/invalid EXR, ...
        print(f"ERROR: couldn't load input images: {e}")
        return 1

    last_pct = [-1]

    def progress(p: float) -> None:
        # print on integer-percent changes only (reference Denoiser.cpp:189)
        pct = int(p * 100)
        if pct != last_pct[0]:
            last_pct[0] = pct
            print(f"\r{pct} %", end="", flush=True)

    from bcd_tpu_torch.core.pipeline import denoise_pipeline

    stats = PhaseStats() if args.stats else None
    out = denoise_pipeline(color, nb, histo, cov, device, args.pipeline,
                           tile=args.tile, skip_stride=args.skip_stride,
                           progress_callback=progress, stats=stats)
    print()
    image_io.write_exr(to_numpy(out), args.output_path)
    print(f"Written denoised output in file {args.output_path}")
    if stats is not None:
        # the reference prints its DenoisingStatistics tree after the run
        # (DenoisingUnit.cpp:71-94 printChronometers + counters)
        print(stats.report())
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    start = time.perf_counter()
    rc = launch(sys.argv[1:] if argv is None else argv)
    print(f"Program total time: {time.perf_counter() - start:.3f} s")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
