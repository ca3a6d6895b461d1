"""State carried from the JAX package to the port.

BCD has no learned weights. Its parameters are the dataclasses of
``bcd_tpu_torch.params``, field for field those of ``bcd_tpu.params``; its
data are the four statistics images the JAX package consumes as numpy
arrays:
color (H, W, 3), sample count (H, W, 1), histograms (H, W, 3 * bins) and
sample covariances (H, W, 6) in channel order xx, yy, zz, yz, xz, xy.

Devices are explicit: every entry point takes one, defaults to the card,
and ``resolve_device`` refuses a CUDA device that is not there instead of
falling back to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` (a name or a ``torch.device``) as a ``torch.device``;
    ValueError for a bad name, or for CUDA on a host without a CUDA
    device."""
    try:
        resolved = torch.device(device)
    except RuntimeError as e:
        raise ValueError(f"bad device '{device}': {e}") from e
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(f"device '{device}' asked for, but no CUDA device "
                         "is available; pass the device cpu (--device cpu) "
                         "to run on the host")
    return resolved


def to_device(color, nb, histo, cov, device):
    """The four statistics images (numpy arrays or tensors) as float32
    tensors on ``device``."""
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                 for x in (color, nb, histo, cov))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor of the port as the numpy array the JAX package returns."""
    return t.detach().to("cpu", torch.float32).numpy()
