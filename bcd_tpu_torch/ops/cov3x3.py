"""Symmetric 3x3 covariance utilities (port of ``bcd_tpu/ops/cov3x3.py``).

Covariances are stored as 6 floats in channel order xx, yy, zz, yz, xz, xy
(reference ``ESymmetricMatrix3x3Data``, CovarianceMatrix.h:18-28). The
per-patch block-diagonal noise covariance is (..., npx, 3, 3).
"""

from __future__ import annotations

import torch


def cov6_to_mat3(c: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) symmetric matrix."""
    xx, yy, zz, yz, xz, xy = c.unbind(-1)
    row0 = torch.stack([xx, xy, xz], dim=-1)
    row1 = torch.stack([xy, yy, yz], dim=-1)
    row2 = torch.stack([xz, yz, zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def blockdiag_expand(blocks: torch.Tensor) -> torch.Tensor:
    """(..., npx, 3, 3) blocks -> dense (..., d, d) block-diagonal matrix."""
    npx = blocks.shape[-3]
    eye = torch.eye(npx, dtype=blocks.dtype, device=blocks.device)
    full = torch.einsum("qp,...qij->...qipj", eye, blocks)
    return full.reshape(blocks.shape[:-3] + (3 * npx, 3 * npx))
