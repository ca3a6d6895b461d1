"""Raw all-samples dump format (port of ``bcd_tpu/io/raw.py``, numpy only;
reference src/raw_converter/main.cpp:65-72 and README.md:126-137).

Binary layout, little-endian:
  header: int32 version, int32 width, int32 height,
          int32 nbOfSamples (per pixel), int32 nbOfChannels (3 or 4)
  data:   width*height*nbOfSamples*nbOfChannels float32, pixel-major
          (all samples of pixel (0,0) first, channel innermost; a 4th
          channel, alpha, is ignored by the converter)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator

import numpy as np

HEADER_STRUCT = struct.Struct("<iiiii")


@dataclass
class RawFileHeader:
    version: int
    width: int
    height: int
    nb_of_samples: int
    nb_of_channels: int


def read_header(path: str) -> RawFileHeader:
    with open(path, "rb") as f:
        return RawFileHeader(*HEADER_STRUCT.unpack(f.read(HEADER_STRUCT.size)))


def read_raw(path: str) -> tuple[RawFileHeader, np.ndarray]:
    """Load the full dump as (header, samples (H, W, S, C) float32)."""
    header = read_header(path)
    count = header.width * header.height * header.nb_of_samples * header.nb_of_channels
    data = np.fromfile(path, dtype="<f4", count=count, offset=HEADER_STRUCT.size)
    samples = data.reshape(
        header.height, header.width, header.nb_of_samples, header.nb_of_channels
    )
    return header, samples


def iter_raw_row_blocks(
    path: str, rows_per_block: int
) -> Iterator[tuple[int, np.ndarray]]:
    """Stream the dump in blocks of image rows: yields ``(row0, samples)``
    with samples shaped (rows, W, S, C). Bounded host memory regardless of
    spp — the streaming analog of the reference's per-sample loop
    (raw_converter/main.cpp:157-171)."""
    header = read_header(path)
    floats_per_row = header.width * header.nb_of_samples * header.nb_of_channels
    with open(path, "rb") as f:
        f.seek(HEADER_STRUCT.size)
        for row0 in range(0, header.height, rows_per_block):
            rows = min(rows_per_block, header.height - row0)
            data = np.fromfile(f, dtype="<f4", count=rows * floats_per_row)
            yield row0, data.reshape(
                rows, header.width, header.nb_of_samples, header.nb_of_channels
            )


def write_raw(path: str, samples: np.ndarray, version: int = 1) -> None:
    """Write a dump from samples shaped (H, W, S, C)."""
    h, w, s, c = samples.shape
    with open(path, "wb") as f:
        f.write(HEADER_STRUCT.pack(version, w, h, s, c))
        np.ascontiguousarray(samples, dtype="<f4").tofile(f)
