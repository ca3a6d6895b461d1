"""State carried from the JAX package to the port.

BCD has no learned weights. Its parameters are the dataclasses of
``bcd_tpu_torch.params``, field for field those of ``bcd_tpu.params``; its
data are the four statistics images the JAX package consumes as numpy
arrays:
color (H, W, 3), sample count (H, W, 1), histograms (H, W, 3 * bins) and
sample covariances (H, W, 6) in channel order xx, yy, zz, yz, xz, xy.
"""

from __future__ import annotations

import numpy as np
import torch


def to_device(color, nb, histo, cov, device):
    """The four statistics images (numpy arrays or tensors) as float32
    tensors on ``device``."""
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                 for x in (color, nb, histo, cov))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor of the port as the numpy array the JAX package returns."""
    return t.detach().to("cpu", torch.float32).numpy()
