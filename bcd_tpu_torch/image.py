"""Image conventions and small helpers (port of ``bcd_tpu/image.py``, numpy
only; reference DeepImage container, include/bcd/core/DeepImage.h).

The reference's ``DeepImage<T>`` is a W x H x D scalar buffer, row-major
with the channel innermost (index = line*width*depth + column*depth +
channel, DeepImage.hpp:386-396). In the port the same object is simply a
numpy array or tensor of shape (H, W, D) in C order — identical memory
layout — so the "container" reduces to these conventions plus a few
helpers that replace the reference's index arithmetic and window
iterators:

- channel orders:   color (R, G, B); covariance (xx, yy, zz, yz, xz, xy,
  CovarianceMatrix.h:18-28); histograms channel-major (3 * nbOfBins, the
  bins of R first); on-disk histogram EXR appends one sample-count channel.
- ``glue_indices`` / ``split_index``: flat-index mapping (DeepImage.hpp).
- ``clamp_position``: border clamping (DeepImage<T>::clamp).
- window arithmetic: the reference's PixelWindow truncates at the image
  border minus an optional inner border (DeepImage.hpp:112-120); batched
  equivalents of those bounds live here for reuse and testing.

The engine itself never iterates windows — it uses shifted-slice stacks —
but integrators porting per-pixel host code can use these.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# covariance channel order (ESymmetricMatrix3x3Data)
COV_XX, COV_YY, COV_ZZ, COV_YZ, COV_XZ, COV_XY = range(6)


def glue_indices(width: int, depth: int, line: int, column: int,
                 channel: int) -> int:
    """Flat buffer index of (line, column, channel)."""
    return (line * width + column) * depth + channel


def split_index(width: int, depth: int, index: int) -> Tuple[int, int, int]:
    """Inverse of :func:`glue_indices`."""
    channel = index % depth
    pix = index // depth
    return pix // width, pix % width, channel


def clamp_position(height: int, width: int, line: int, column: int):
    """Clamp a pixel position into the image (DeepImage<T>::clamp)."""
    return (min(max(line, 0), height - 1), min(max(column, 0), width - 1))


def window_bounds(height: int, width: int, line: int, column: int,
                  radius: int, border: int = 0):
    """Truncated window corners around a center: ((l0, c0), (l1, c1))
    inclusive, restricted to [border, size-1-border] (reference
    PixelWindow::reset, DeepImage.hpp:112-120)."""
    l0 = max(border, line - radius)
    c0 = max(border, column - radius)
    l1 = min(height - 1 - border, line + radius)
    c1 = min(width - 1 - border, column + radius)
    return (l0, c0), (l1, c1)


def planar_to_interleaved(planes: np.ndarray) -> np.ndarray:
    """(D, H, W) channel-planar (the EXR wire layout) -> (H, W, D)."""
    return np.moveaxis(planes, 0, -1)


def interleaved_to_planar(image: np.ndarray) -> np.ndarray:
    """(H, W, D) -> (D, H, W) (reference ImageIO::reorderDataForWritingEXR)."""
    return np.moveaxis(image, -1, 0)
