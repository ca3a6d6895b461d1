"""Renderer-facing in-memory denoiser API (port of ``bcd_tpu/core/api.py``;
reference include/bcd/core/IDenoiser.h).

The zero-file integration path (reference README: "post samples, then
denoise arrays in memory"): a host renderer builds :class:`DenoiserInputs`
from a :class:`bcd_tpu_torch.ops.accumulator.SamplesAccumulator` (or its
own numpy arrays or tensors) and calls :class:`Denoiser` /
:class:`MultiscaleDenoiser`, which run on their device (default: the card).
As in JAX's API there is no prefilter and no output sanitizing; the output
is a float32 numpy array.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from bcd_tpu_torch.convert import resolve_device, to_numpy
from bcd_tpu_torch.core.monoscale import denoise_monoscale
from bcd_tpu_torch.core.multiscale import denoise_multiscale
from bcd_tpu_torch.params import DenoiserParameters


@dataclass
class DenoiserInputs:
    """The four statistics images (reference IDenoiser.h:46-59), numpy
    arrays or tensors.

    colors:             (H, W, 3) pixel mean color
    nb_of_samples:      (H, W, 1) per-pixel sample count (weight sum)
    histograms:         (H, W, 3*nbOfBins) per-channel luminance histograms
    sample_covariances: (H, W, 6) RGB sample covariance, order
                        xx, yy, zz, yz, xz, xy
    """

    colors: Any
    nb_of_samples: Any
    histograms: Any
    sample_covariances: Any

    def validate(self) -> None:
        """Shape/consistency checks (reference Denoiser::inputsOutputsAreOk,
        Denoiser.cpp:238-348); raises ValueError instead of printing."""
        for name in ("colors", "nb_of_samples", "histograms",
                     "sample_covariances"):
            arr = getattr(self, name)
            if arr is None:
                raise ValueError(f"input image '{name}' is missing")
            # the element count from the shape: a tensor's ``size`` is a
            # method, so JAX's ``arr.size == 0`` would never hold for one
            if math.prod(arr.shape) == 0:
                raise ValueError(f"input image '{name}' is empty")
        h, w = self.colors.shape[:2]
        for name in ("nb_of_samples", "histograms", "sample_covariances"):
            arr = getattr(self, name)
            if tuple(arr.shape[:2]) != (h, w):
                raise ValueError(
                    f"input image '{name}' is {arr.shape[1]}x{arr.shape[0]} "
                    f"but the color image is {w}x{h}"
                )
        if self.sample_covariances.shape[-1] != 6:
            raise ValueError("sample covariance image must have 6 channels")


@dataclass
class DenoiserOutputs:
    """(reference IDenoiser.h:61-70)"""

    denoised_colors: Optional[np.ndarray] = None


class IDenoiser:
    """Abstract denoiser (reference IDenoiser.h:73-97)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._inputs: Optional[DenoiserInputs] = None
        self._outputs = DenoiserOutputs()
        self._parameters = DenoiserParameters()
        self._progress_callback: Callable[[float], None] = lambda p: None

    # reference setter/getter surface
    def set_inputs(self, inputs: DenoiserInputs) -> None:
        self._inputs = inputs

    def set_outputs(self, outputs: DenoiserOutputs) -> None:
        self._outputs = outputs

    def set_parameters(self, parameters: DenoiserParameters) -> None:
        self._parameters = parameters

    def set_progress_callback(self, cb: Callable[[float], None]) -> None:
        self._progress_callback = cb

    def get_inputs(self) -> Optional[DenoiserInputs]:
        return self._inputs

    def get_outputs(self) -> DenoiserOutputs:
        return self._outputs

    def get_parameters(self) -> DenoiserParameters:
        return self._parameters

    def denoise(self) -> bool:
        raise NotImplementedError


class Denoiser(IDenoiser):
    """Monoscale driver (reference Denoiser.h:25-69)."""

    def __init__(self, tile: Optional[int] = None, device="cuda"):
        super().__init__(device)
        self._tile = tile

    def denoise(self) -> bool:
        try:
            self._inputs.validate()
        except ValueError:
            return False
        self._progress_callback(0.0)
        out = denoise_monoscale(
            self._inputs.colors,
            self._inputs.nb_of_samples,
            self._inputs.histograms,
            self._inputs.sample_covariances,
            self._parameters,
            self.device,
            tile=self._tile,
        )
        self._outputs.denoised_colors = to_numpy(out)
        self._progress_callback(1.0)
        return True


class MultiscaleDenoiser(IDenoiser):
    """Multiscale driver (reference MultiscaleDenoiser.h:23-101)."""

    def __init__(self, nb_of_scales: int = 3, tile: Optional[int] = None,
                 device="cuda"):
        super().__init__(device)
        self.nb_of_scales = nb_of_scales
        self._tile = tile

    def denoise(self) -> bool:
        try:
            self._inputs.validate()
        except ValueError:
            return False
        out = denoise_multiscale(
            self._inputs.colors,
            self._inputs.nb_of_samples,
            self._inputs.histograms,
            self._inputs.sample_covariances,
            self._parameters,
            self.device,
            nb_of_scales=self.nb_of_scales,
            tile=self._tile,
            progress_callback=self._progress_callback,
        )
        self._outputs.denoised_colors = to_numpy(out)
        return True
