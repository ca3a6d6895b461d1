"""Parameter dataclasses and the ``.bcd.json`` preset loader of the port.

The same fields, defaults and JSON keys as ``bcd_tpu/params.py`` (the
CLI's effective defaults; preset keys of reference
src/io/ParametersIO.cpp:95-160), kept in the port so that it runs where
the JAX package is not installed. ``tests/test_torch_cli.py`` holds the
two against each other.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class HistogramParameters:
    """Histogram binning parameters (reference SamplesAccumulator.h:20-30)."""

    nb_of_bins: int = 20
    gamma: float = 2.2
    max_value: float = 2.5


@dataclass
class DenoiserParameters:
    """Monoscale denoiser parameters (reference IDenoiser.h:20-44).

    ``use_random_pixel_order``, ``marked_pixels_skipping_probability``,
    ``nb_of_cores`` and ``use_cuda`` are accepted for preset compatibility
    and have no effect: the engine denoises every pixel, deterministically.
    """

    histogram_distance_threshold: float = 1.0
    patch_radius: int = 1
    search_window_radius: int = 6
    min_eigen_value: float = 1e-8
    use_random_pixel_order: bool = True
    marked_pixels_skipping_probability: float = 1.0
    nb_of_cores: int = 0
    use_cuda: bool = True


@dataclass
class PrefilteringParameters:
    """Spike-removal prefilter parameters (reference ParametersIO.h:27-32)."""

    perform_spike_removal: bool = True
    spike_removal_threshold_stdev_factor: float = 2.0


@dataclass
class MultiscaleDenoiserParameters:
    nb_of_scales: int = 3
    monoscale: DenoiserParameters = field(default_factory=DenoiserParameters)


@dataclass
class InputFileNames:
    colors: str = ""
    histograms: str = ""
    covariances: str = ""


@dataclass
class PipelineParameters:
    """Full pipeline preset (reference ParametersIO.h:19-46)."""

    input_file_names: InputFileNames = field(default_factory=InputFileNames)
    prefiltering: PrefilteringParameters = field(
        default_factory=PrefilteringParameters)
    denoiser: MultiscaleDenoiserParameters = field(
        default_factory=MultiscaleDenoiserParameters)


# JSON key -> (section, attribute, type) of PipelineParameters
_JSON_KEYS = {
    "performSpikeRemovalPrefiltering":
        ("prefiltering", "perform_spike_removal", bool),
    "spikeRemovalThresholdStDevFactor":
        ("prefiltering", "spike_removal_threshold_stdev_factor", float),
    "nbOfScales": ("denoiser", "nb_of_scales", int),
    "histoDistanceThreshold":
        ("monoscale", "histogram_distance_threshold", float),
    "useCuda": ("monoscale", "use_cuda", bool),
    "nbOfCores": ("monoscale", "nb_of_cores", int),
    "patchRadius": ("monoscale", "patch_radius", int),
    "searchWindowRadius": ("monoscale", "search_window_radius", int),
    "randomPixelOrder": ("monoscale", "use_random_pixel_order", bool),
    "markedPixelsSkippingProbability":
        ("monoscale", "marked_pixels_skipping_probability", float),
    "minEigenValue": ("monoscale", "min_eigen_value", float),
}
_FILE_KEYS = {"inputColorFile": "colors", "inputHistoFile": "histograms",
              "inputCovarFile": "covariances"}


def load_pipeline_json(path: str, params: Optional[PipelineParameters] = None
                       ) -> PipelineParameters:
    """Load a ``.bcd.json`` preset into ``params``, overwriting only the
    keys present in the file (reference ParametersIO.cpp:36-117). Input
    paths are relative to the JSON file's folder."""
    params = params if params is not None else PipelineParameters()
    with open(path, "r") as f:
        obj = json.load(f)
    folder = os.path.dirname(path)
    folder = folder + os.sep if folder else ""
    sections = {"prefiltering": params.prefiltering,
                "denoiser": params.denoiser,
                "monoscale": params.denoiser.monoscale}
    for key, attr in _FILE_KEYS.items():
        if key in obj:
            setattr(params.input_file_names, attr, folder + obj[key])
    for key, (section, attr, kind) in _JSON_KEYS.items():
        if key in obj:
            setattr(sections[section], attr, kind(obj[key]))
    return params
