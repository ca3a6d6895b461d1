"""raw2bcd: convert a raw all-samples dump to the three BCD input EXRs (port
of ``bcd_tpu/raw2bcd_cli.py``; reference src/raw_converter/main.cpp).

    python -m bcd_tpu_torch.raw2bcd_cli <input> <outputPrefix> [--device D]

Writes ``<prefix>.exr`` (mean color), ``<prefix>_hist.exr`` (histograms +
trailing sample-count channel) and ``<prefix>_cov.exr`` (covariances).
Histogram parameters are fixed at the converter defaults (20 bins, gamma
2.2, max 2.5 — main.cpp:49-52). The dump is streamed in blocks of 64 rows
into the on-device accumulator (``ops/accumulator.py``). ``--device``
(default ``cuda``) picks where; with no CUDA device the run fails unless it
says ``--device cpu``.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import torch

from bcd_tpu_torch.chrono import PhaseStats
from bcd_tpu_torch.convert import resolve_device, to_numpy
from bcd_tpu_torch.io import image_io, raw
from bcd_tpu_torch.ops.accumulator import SamplesAccumulator
from bcd_tpu_torch.params import HistogramParameters

COLOR_SUFFIX = ""
HISTOGRAM_SUFFIX = "_hist"
COVARIANCE_SUFFIX = "_cov"
EXTENSION = ".exr"
ROWS_PER_BLOCK = 64


def print_usage() -> None:
    print("raw2bcd (PyTorch / CUDA)\n")
    print("Usage: raw2bcd <input> <outputPrefix> [--device <name>]")
    print("Converts a raw file with all samples into the inputs for the "
          "BayesianCollaborativeDenoiser program")
    print("Required arguments list:")
    print("    <input>           The file path to the input image")
    print("    <outputPrefix>    The file path to the output image, without .exr extension")
    print("Optional arguments list:")
    print("    --device <name>   Torch device: cuda (default) or cpu")


def convert(input_path: str, output_prefix: str, device,
            stats: Optional[PhaseStats] = None) -> int:
    """Convert one dump on ``device``. With ``stats``, times the phases
    ``dump read`` (host clock), ``accumulate`` (host clock, each block's
    upload and device work waited for), on CUDA ``accumulate, device``
    (the same spans by CUDA events) and ``EXR write`` (the finalize and
    the download included)."""
    header = raw.read_header(input_path)
    print(f"Version: {header.version}")
    print(f"Resolution: {header.width}x{header.height}")
    print(f"Nb of samples: {header.nb_of_samples}")
    print(f"Nb of channels: {header.nb_of_channels}")

    acc = SamplesAccumulator(header.height, header.width,
                             HistogramParameters(), device=device)
    events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
              if stats is not None and device.type == "cuda" else None)
    t0 = time.perf_counter()
    for row0, block in raw.iter_raw_row_blocks(input_path, ROWS_PER_BLOCK):
        t1 = time.perf_counter()
        if events:
            events[0].record()
        acc.add_samples(block, row0=row0)
        if events:
            events[1].record()
            events[1].synchronize()
            stats.timers["accumulate, device"] += \
                events[0].elapsed_time(events[1]) / 1e3
        if stats is not None:
            stats.timers["dump read"] += t1 - t0
            stats.timers["accumulate"] += time.perf_counter() - t1
        t0 = time.perf_counter()
    nb, mean, cov, histo = (to_numpy(x) for x in
                            acc.extract_samples_statistics())
    hist_and_count = image_io.merge_histogram_and_nb_of_samples(histo, nb)
    image_io.write_exr(mean, output_prefix + COLOR_SUFFIX + EXTENSION)
    image_io.write_multi_channels_exr(
        cov, output_prefix + COVARIANCE_SUFFIX + EXTENSION)
    image_io.write_multi_channels_exr(
        hist_and_count, output_prefix + HISTOGRAM_SUFFIX + EXTENSION)
    if stats is not None:
        stats.timers["EXR write"] += time.perf_counter() - t0
    return 0


def main(argv: List[str] | None = None,
         stats: Optional[PhaseStats] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device_name = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print_usage()
            return 1
        device_name = argv[i + 1]
        del argv[i : i + 2]
    if len(argv) != 2:
        print_usage()
        return 1
    try:
        device = resolve_device(device_name)
    except ValueError as e:
        print(f"ERROR: {e}")
        return 1
    return convert(argv[0], argv[1], device, stats=stats)


if __name__ == "__main__":
    raise SystemExit(main())
