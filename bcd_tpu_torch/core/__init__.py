"""Engine of the PyTorch port: fused tile pipeline, monoscale, multiscale,
pipeline, and the in-memory denoiser API."""

from bcd_tpu_torch.core.api import (
    Denoiser,
    DenoiserInputs,
    DenoiserOutputs,
    IDenoiser,
    MultiscaleDenoiser,
)
from bcd_tpu_torch.core.monoscale import denoise_monoscale
from bcd_tpu_torch.core.multiscale import denoise_multiscale
from bcd_tpu_torch.core.pipeline import denoise_pipeline, sanitize_output

__all__ = [
    "Denoiser",
    "DenoiserInputs",
    "DenoiserOutputs",
    "IDenoiser",
    "MultiscaleDenoiser",
    "denoise_monoscale",
    "denoise_multiscale",
    "denoise_pipeline",
    "sanitize_output",
]
