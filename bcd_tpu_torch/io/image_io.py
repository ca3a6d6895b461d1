"""The denoiser's EXR files as (H, W, C) float32 numpy arrays (port of
``bcd_tpu/io/image_io.py``; reference src/io/ImageIO.cpp).

Color images are R/G/B(/A) channels; the statistics buffers are
``Bin_%04d`` FLOAT channels, and the histogram file carries the sample
count as one channel after the 3 * bins histogram channels.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from bcd_tpu_torch.io import exr


def load_exr(path: str) -> np.ndarray:
    """An RGB EXR as (H, W, 3) float32, or (H, W, 1) when the three planes
    are equal (reference ImageIO.cpp:42-51). Missing G/B read as 0."""
    channels, info = exr.read_exr(path)
    zero = np.zeros((info["height"], info["width"]), np.float32)
    r, g, b = (channels.get(c, zero) for c in "RGB")
    if np.array_equal(r, g) and np.array_equal(r, b):
        return r[..., None].copy()
    return np.stack([r, g, b], axis=-1)


def load_multi_channels_exr(path: str) -> np.ndarray:
    """The ``Bin_0000``, ``Bin_0001``, ... channels, up to the first
    missing name, as (H, W, D) float32."""
    channels, _ = exr.read_exr(path)
    planes = []
    while f"Bin_{len(planes):04d}" in channels:
        planes.append(channels[f"Bin_{len(planes):04d}"])
    if not planes:
        raise exr.ExrError(f"no Bin_%04d channels found in {path}")
    return np.stack(planes, axis=-1)


def write_exr(image: np.ndarray, path: str) -> None:
    """An (H, W, 3) or (H, W, 1) image as an RGBA HALF EXR, as the
    reference writes its output; one channel is replicated to RGB."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[..., None]
    if image.shape[-1] == 1:
        image = np.repeat(image, 3, axis=-1)
    if image.shape[-1] != 3:
        raise ValueError(f"write_exr expects 1 or 3 channels, got {image.shape}")
    planes = {c: image[..., i] for i, c in enumerate("RGB")}
    planes["A"] = np.ones(image.shape[:2], np.float32)
    exr.write_exr(path, planes, pixel_types=dict.fromkeys("RGBA", exr.HALF))


def write_multi_channels_exr(image: np.ndarray, path: str) -> None:
    """An (H, W, D) buffer as D FLOAT channels named ``Bin_%04d``."""
    image = np.asarray(image, np.float32)
    if image.ndim != 3:
        raise ValueError(f"expected (H, W, D), got {image.shape}")
    exr.write_exr(path, {f"Bin_{z:04d}": image[..., z]
                         for z in range(image.shape[-1])})


def separate_nb_of_samples_from_histogram(
        histo_and_count: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(histogram (H, W, 3 * bins), nb_of_samples (H, W, 1)) of the
    histogram file's buffer (reference Utils.cpp:21-46)."""
    return histo_and_count[..., :-1], histo_and_count[..., -1:]


def merge_histogram_and_nb_of_samples(histogram: np.ndarray,
                                      nb_of_samples: np.ndarray) -> np.ndarray:
    """Inverse of :func:`separate_nb_of_samples_from_histogram`."""
    if nb_of_samples.ndim == 2:
        nb_of_samples = nb_of_samples[..., None]
    return np.concatenate([histogram, nb_of_samples], axis=-1)
