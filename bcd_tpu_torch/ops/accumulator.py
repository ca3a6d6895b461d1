"""On-device sample statistics (port of ``bcd_tpu/ops/accumulator.py``, plain
PyTorch as JAX's is plain JAX; reference SamplesAccumulator).

The reference streams one path sample at a time through ``addSample``
(SamplesAccumulator.cpp:44-107). Here a whole (H, W, S, C) sample tensor,
or a stream of row-block chunks, is reduced on the device: the two-bin
histogram splat, gamma companding, saturation handling and the
bias-corrected finalize are the reference's.

The sums are deterministic: each is a reduction over the sample axis, and
the histogram splat is one masked select-and-sum per bin, as JAX's. No
float-atomic scatter (``index_add_``, ``scatter_add_``, ``bincount`` on
CUDA), whose summation order changes from run to run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from bcd_tpu_torch.convert import resolve_device
from bcd_tpu_torch.params import HistogramParameters

SATURE_LEVEL_GAMMA = 2.0  # reference SamplesAccumulator.cpp:52


@dataclass
class AccumulatorState:
    """Running sums; image-shaped, so chunks can be added in any order.

    nb:    (H, W)      sum of weights           (nbOfSamplesImage)
    w2:    (H, W)      sum of squared weights   (squaredWeightSumsImage)
    wc:    (H, W, 3)   weighted color sum       (meanImage before finalize)
    cov:   (H, W, 6)   weighted second moments  (covarImage before finalize)
    histo: (H, W, 3, nbins) histogram weights   (histoImage)
    """

    nb: torch.Tensor
    w2: torch.Tensor
    wc: torch.Tensor
    cov: torch.Tensor
    histo: torch.Tensor


def init_state(height: int, width: int, nb_of_bins: int = 20,
               device="cuda") -> AccumulatorState:
    def zeros(*shape):
        return torch.zeros((height, width) + shape, dtype=torch.float32,
                           device=device)

    return AccumulatorState(nb=zeros(), w2=zeros(), wc=zeros(3),
                            cov=zeros(6), histo=zeros(3, nb_of_bins))


def _chunk_sums(samples: torch.Tensor, weights: torch.Tensor, nb_of_bins: int,
                gamma: float, max_value: float):
    """Reduce a (rows, W, S, 3) chunk to image-shaped partial sums
    (nb, w2, wc, cov, histo), as JAX's ``_chunk_sums``."""
    samples = samples.float()
    w = weights.float()

    nb = w.sum(2)
    w2 = (w * w).sum(2)
    wc = (w[..., None] * samples).sum(2)

    r, g, b = samples.unbind(-1)
    cov = torch.stack([(w * r * r).sum(2), (w * g * g).sum(2),
                       (w * b * b).sum(2), (w * g * b).sum(2),
                       (w * r * b).sum(2), (w * r * g).sum(2)], dim=-1)

    # two-bin histogram splat (reference SamplesAccumulator.cpp:77-105);
    # the scalars in float32, as JAX's
    v = samples.clamp(min=0.0)
    if gamma > 1.0:
        v = v ** float(np.float32(1.0) / np.float32(gamma))
    if max_value > 0.0:
        v = v / float(np.float32(max_value))
    v = v.clamp(max=SATURE_LEVEL_GAMMA)
    bin_float = v * (nb_of_bins - 2)
    floor_bin = bin_float.floor().to(torch.int32)
    in_bounds = floor_bin < nb_of_bins - 2
    floor_bin = torch.where(in_bounds, floor_bin, nb_of_bins - 2)
    ceil_w = torch.where(in_bounds, bin_float - floor_bin,
                         (v - 1.0) / (SATURE_LEVEL_GAMMA - 1.0))
    floor_w = 1.0 - ceil_w

    # histo[..., b] = sum_s (w floor_w)[fb == b] + sum_s (w ceil_w)[fb == b-1]:
    # one select-and-sum over the sample axis per bin, no one-hot tensor
    wf = w[..., None] * floor_w
    wcl = w[..., None] * ceil_w
    zero = wf.new_zeros(())
    cols = []
    for bin_ in range(nb_of_bins):
        contrib = torch.where(floor_bin == bin_, wf, zero)
        if bin_ >= 1:  # the ceil weight lands one bin above its floor bin
            contrib = contrib + torch.where(floor_bin == bin_ - 1, wcl, zero)
        cols.append(contrib.sum(2))
    return nb, w2, wc, cov, torch.stack(cols, dim=-1)


def _finalize(state: AccumulatorState):
    """Normalize and bias-correct (computeSampleStatistics, reference
    SamplesAccumulator.cpp:110-141). Returns (nb (H, W, 1), mean (H, W, 3),
    cov (H, W, 6), histo (H, W, 3 nbins), channel-major)."""
    inv = 1.0 / state.nb
    mean = state.wc * inv[..., None]
    cov = state.cov * inv[..., None]
    m0, m1, m2 = mean.unbind(-1)
    cov = cov - torch.stack([m0 * m0, m1 * m1, m2 * m2, m1 * m2, m0 * m2,
                             m0 * m1], dim=-1)
    bias = 1.0 / (1.0 - state.w2 / (state.nb * state.nb))
    cov = cov * bias[..., None]
    h, w = state.histo.shape[:2]
    return state.nb[..., None], mean, cov, state.histo.reshape(h, w, -1)


class SamplesAccumulator:
    """Streaming renderer-facing accumulator (reference SamplesAccumulator.h).

    Usage::

        acc = SamplesAccumulator(height, width, HistogramParameters())
        acc.add_samples(samples_chunk, row0=0)   # (rows, W, S, 3[;4]) chunks
        nb, mean, cov, histo = acc.extract_samples_statistics()

    ``add_samples`` replaces per-sample ``addSample`` calls; a chunk may
    cover any row range and chunks may repeat rows (sums commute). The
    state and the statistics live on ``device`` (default: the card).
    """

    def __init__(self, height: int, width: int,
                 histogram_params: Optional[HistogramParameters] = None,
                 device="cuda"):
        self.height = height
        self.width = width
        self.params = histogram_params or HistogramParameters()
        self.device = resolve_device(device)
        self._state = init_state(height, width, self.params.nb_of_bins,
                                 self.device)

    def add_samples(self, samples, row0: int = 0, weights=None) -> None:
        """Accumulate a chunk of samples shaped (rows, W, S, C>=3) (numpy
        or a tensor; a numpy chunk is uploaded once) into rows
        [row0, row0 + rows); a 4th (alpha) channel is ignored like the
        reference raw converter (raw_converter/main.cpp:159-169)."""
        if self._state is None:
            raise RuntimeError("accumulator was extracted (move semantics)")
        samples = torch.as_tensor(samples, device=self.device)[..., :3]
        rows = samples.shape[0]
        if samples.shape[1] != self.width or not (
                0 <= row0 and row0 + rows <= self.height):
            raise ValueError(
                f"a chunk of {rows}x{samples.shape[1]} at row {row0} does not "
                f"fit a {self.width}x{self.height} accumulator")
        if weights is None:
            weights = torch.ones(samples.shape[:3], device=self.device)
        else:
            weights = torch.as_tensor(weights, device=self.device)
        sums = _chunk_sums(samples, weights, self.params.nb_of_bins,
                           self.params.gamma, self.params.max_value)
        # the rows this chunk covers, in place: what JAX's add of the
        # zero-padded full-height sums adds
        st = self._state
        for acc, part in zip((st.nb, st.w2, st.wc, st.cov, st.histo), sums):
            acc[row0 : row0 + rows] += part

    def get_samples_statistics(self):
        """Copy semantics (reference getSamplesStatistics): (nb, mean, cov,
        histo) tensors on the accumulator's device."""
        if self._state is None:
            raise RuntimeError("accumulator was extracted (move semantics)")
        nb, mean, cov, histo = _finalize(self._state)
        return nb.clone(), mean, cov, histo.clone()  # not views of the state

    def extract_samples_statistics(self):
        """Move semantics: invalidates the accumulator (reference
        extractSamplesStatistics, SamplesAccumulator.cpp:150-154)."""
        if self._state is None:
            raise RuntimeError("accumulator was extracted (move semantics)")
        stats = _finalize(self._state)
        self._state = None
        return stats


def accumulate_samples(samples, histogram_params: Optional[
        HistogramParameters] = None, weights=None, device="cuda"):
    """One-shot accumulation of a full (H, W, S, C) sample array on
    ``device``. Returns (nb_of_samples (H, W, 1), mean (H, W, 3),
    cov (H, W, 6), histo (H, W, 3 bins)) tensors there."""
    params = histogram_params or HistogramParameters()
    device = resolve_device(device)
    samples = torch.as_tensor(samples, device=device)[..., :3]
    if weights is None:
        weights = torch.ones(samples.shape[:3], device=device)
    sums = _chunk_sums(samples, torch.as_tensor(weights, device=device),
                       params.nb_of_bins, params.gamma, params.max_value)
    return _finalize(AccumulatorState(*sums))
