"""Firefly (spike) removal prefilter (port of
``bcd_tpu/ops/spike_removal.py``; reference SpikeRemovalFilter).

For every pixel, over the 3x3 window around its *clamped* center (border
pixels reuse the nearest fully-interior window, not an edge-replicated one,
SpikeRemovalFilter.cpp:45-48): per-channel mean and standard deviation; if
any channel deviates by more than ``threshold_factor * sigma``, the pixel's
color, sample count, histogram and covariance are replaced by those of the
window's 3D median, the neighbor minimizing the total L1 distance in RGB
over the window, first minimum winning (SpikeRemovalFilter.cpp:94-116).
Reads come from copies, so the filter is order-independent (.cpp:29-32).
"""

from __future__ import annotations

import torch


def spike_removal(color, nb, histo, cov, threshold_factor: float):
    """Returns filtered (color, nb, histo, cov); each (H, W, C), H, W >= 3."""
    color = color.float()
    h, w = color.shape[:2]
    dev = color.device
    # window slot k = 3 * ky + kx around the clamped center
    center_r = torch.arange(h, device=dev).clamp(1, h - 2)
    center_c = torch.arange(w, device=dev).clamp(1, w - 2)
    ky = torch.arange(3, device=dev).repeat_interleave(3)
    kx = torch.arange(3, device=dev).repeat(3)
    win_r = center_r[:, None] - 1 + ky[None, :]  # (H, 9)
    win_c = center_c[:, None] - 1 + kx[None, :]  # (W, 9)
    win = color[win_r[:, None, :], win_c[None, :, :]]  # (H, W, 9, 3)

    n = 9
    mean = win.mean(dim=2)
    var = ((win - mean[:, :, None, :]) ** 2).sum(dim=2) / (n - 1)
    std = torch.sqrt(var)
    is_spike = ((color - mean).abs() > threshold_factor * std).any(dim=-1)

    # 3D median by total L1 distance; argmin returns the first minimum
    pair_l1 = (win[:, :, :, None, :] - win[:, :, None, :, :]).abs().sum(
        dim=(2, 4))  # (H, W, 9)
    median_idx = pair_l1.argmin(dim=-1)
    med_r = center_r[:, None] - 1 + median_idx // 3
    med_c = center_c[None, :] - 1 + median_idx % 3

    def replace(img):
        img = img.float()
        return torch.where(is_spike[..., None], img[med_r, med_c], img)

    return replace(color), replace(nb), replace(histo), replace(cov)
