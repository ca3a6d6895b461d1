"""The least time an H100 could take for each kernel's work, reckoned from
its shapes: the larger of the operations over the fp32 rate outside the
tensor cores and the bytes (each input read once, each output written
once) over the memory rate (NVIDIA's data sheet, SXM part, at its 700 W
limit). Where the work depends on the data (the similar sets K1 sums and
K4 applies), the caller passes this run's counts.

Operations count a multiply-add as two and a division or square root as
one; the counts are those of the cheapest known algorithm for each
function (for the eigen-decomposition, the one-sided fast-Givens Jacobi
that every solve kernel runs), whatever a kernel actually computes (K4
sums each source's filter before applying it, the solve_filter kernel
computes the full M2), leaving out terms of lower order (rotation angles
and the rank-k clamp update, which depends on how many eigenvalues are
negative)."""

from __future__ import annotations

FP32_FLOPS = 67e12  # per second, fp32 outside the tensor cores
HBM_BYTES = 3.35e12  # per second

D = 27
NPX = 9
DTRI = D * (D + 1) // 2
MISC_CH = D + 6 * NPX + 2
SMALL_CH = 2 * D + 2


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """(bound in ms, "operations" or "bytes": which of the two sets it)."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _solves(d: int) -> float:
    """The two-step solve after the clamp: Cemp, two Cholesky
    factorizations, four triangular solves with d right-hand sides, the
    two step-2 products and b2."""
    return 3 * d * d + 2 * d ** 3 / 3 + 4 * d ** 3 + 4 * d ** 3 + 2 * d * d


def _jacobi(d: int, sweeps: int) -> float:
    """The cheapest known form of the eigen-decomposition every solve
    runs, the TPU kernels' one-sided fast-Givens Jacobi
    (``_jacobi_clamp_psd``): per round, the dp/2 pivot inner products and
    the rows of W and Q (one FMA an element), then the final eigenvalue
    inner products."""
    dp = d + d % 2
    per_round = (dp // 2) * (2 * dp + 2 * 2 * dp * 2)
    return sweeps * (dp - 1) * per_round + 2 * dp * dp


def k1(n_tiles: int, t: int, h: int, b: int, nbins: int, n_selected: int):
    """K1 for ``n_tiles`` tiles: the chi^2 term of each pixel pair once
    (the mirror), about 8 flops a bin, and 2 flops a moment channel for
    each of the ``n_selected`` (center, offset) pairs of the masks."""
    n_off, tp = (2 * b + 1) ** 2, t + 2 * h
    chi = n_tiles * (n_off - 1) // 2 * (t + 2) ** 2 * nbins * 8
    moments = n_selected * 2 * (DTRI + D + 6 * NPX + 1)
    nbytes = 4 * n_tiles * tp * tp * (nbins + 1 + 3 + 6 + 2) \
        + n_tiles * t * t * (n_off + 4 * (DTRI + MISC_CH))
    return bound_ms(chi + moments, nbytes)


def k2(n_pixels: int, sweeps: int):
    """K2 for ``n_pixels`` pixels at ``sweeps`` Jacobi sweeps."""
    flops = n_pixels * (_jacobi(D, sweeps) + _solves(D))
    nbytes = 4 * n_pixels * (DTRI + MISC_CH + D * D + SMALL_CH)
    return bound_ms(flops, nbytes)


def k4(n_tiles: int, t: int, h: int, b: int, n_applied: int):
    """K4 for ``n_tiles`` tiles: A2 c + b2 and its scatter for each of the
    ``n_applied`` (main-path center, selected offset) pairs."""
    n_off, tp = (2 * b + 1) ** 2, t + 2 * h
    flops = n_applied * (2 * D * D + 2 * D)
    nbytes = n_tiles * t * t * (n_off + 4 * (D * D + SMALL_CH)) \
        + 4 * n_tiles * tp * tp * (3 + 4)
    return bound_ms(flops, nbytes)


def solve_filter(n_pixels: int, n_off: int, d: int, sweeps: int):
    """solve_filter for ``n_pixels`` centers of ``n_off`` candidates: the
    masked moments, the Jacobi, the solves and the filtered field."""
    flops = n_pixels * (n_off * d * (d + 1) + _jacobi(d, sweeps)
                        + _solves(d) + 2 * n_off * d * d)
    nbytes = 4 * n_pixels * (2 * n_off * d + n_off + 6 * d // 3 + 1 + d)
    return bound_ms(flops, nbytes)


def solve_matrices(n_pixels: int, d: int, sweeps: int):
    """The lane solve_matrices for ``n_pixels`` centers."""
    flops = n_pixels * (_jacobi(d, sweeps) + _solves(d))
    nbytes = 4 * n_pixels * (d * d + d + 6 * d // 3 + 1 + d * d + d)
    return bound_ms(flops, nbytes)


def accumulate(n_pixels: int, spp: int, nbins: int):
    """The sample accumulator (plain PyTorch, no kernel of its own) for
    ``n_pixels`` pixels of ``spp`` samples: the three color channels it
    uses read once, the statistics (nb, mean, cov, histo) written once,
    and about 60 operations a sample (its weight sums, color and
    second-moment products, and each channel's companding and two-bin
    splat)."""
    return bound_ms(n_pixels * spp * 60,
                    4 * n_pixels * (3 * spp + 1 + 3 + 6 + 3 * nbins))


def probes() -> dict[str, tuple[float, str]]:
    """The four TPU-compiler probes in scripts/ (not ported; ROADMAP Queue
    2) at the shapes their scripts run."""
    tri_in = 4 * (2304 * DTRI + D * D * DTRI)
    return {
        # expand and transpose 2304 pixel rows of K1's moments: a data move
        "probe_transpose": bound_ms(0, tri_in + 4 * 2 * D * D * 2304),
        # 13 shifted row reads of a (2896, 729) slab summed into (2208, 729)
        "probe_mosaic": bound_ms(13 * 2208 * 729, 4 * (2896 + 2208) * 729),
        # (60, 64, 64) 13-wide banded masks times (60, 64, 768) slabs
        "probe_banded_dot": bound_ms(60 * 64 * 13 * 768 * 2,
                                     4 * 60 * 64 * (64 + 2 * 768)),
        # a staged solve_filter: 128 pixels, 169 candidates, d = 27, 1 sweep
        "bisect_kernel": solve_filter(128, 169, D, 1),
    }


if __name__ == "__main__":
    for name, (ms, by) in probes().items():
        print(f"{name}: bound {ms:.6f} ms ({by})")
