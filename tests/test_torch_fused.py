"""The port's K1 and K4 plain twins (bcd_tpu_torch/ops/fused.py) against the
JAX kernels masks_moments2 / apply_scatter2 run in interpret mode, on the
scene of tests/test_fused_pallas.py (T=16, B=2, 30 bins)."""

import numpy as np
import pytest
import torch

from bcd_tpu_torch.ops import fused as tfused
from bcd_tpu_torch.ops.solve_filter import SMALL_CH
from tests.test_fused_pallas import (
    B, D, H, ND, T, TP, _flat_inputs, _scene, _validity)


@pytest.fixture(scope="module")
def k1():
    """The scene, its validity maps and the JAX K1 outputs (run once)."""
    from bcd_tpu.ops.fused_pallas import masks_moments2

    rng = np.random.default_rng(1234)
    histo, nb, color, pixcov = _scene(rng)
    center_valid, interior = _validity()
    valid = np.stack([center_valid, interior], -1).astype(np.float32)
    masks, m2, misc = masks_moments2(
        *_flat_inputs(histo, nb, color, pixcov), 0.25,
        t=T, r=1, b=B, interpret=True)
    return dict(rng=rng, histo=histo, nb=nb, color=color, pixcov=pixcov,
                valid=valid, masks=np.asarray(masks), m2=np.asarray(m2),
                misc=np.asarray(misc))


def _torch_k1(s):
    def slab(a):
        return torch.from_numpy(a[None].copy())

    return tfused.masks_moments(
        slab(s["histo"]), slab(s["nb"]), slab(s["color"]), slab(s["pixcov"]),
        slab(s["valid"]), 0.25, t=T, h=H, b=B)


def _jax_masks_core(masks):
    """JAX (nd, tp^2, nd) [dyi, z, dxi] -> (t*t, O) over the core centers."""
    m = masks.reshape(ND, TP, TP, ND)[:, H : H + T, H : H + T]
    return np.moveaxis(m, 0, 2).reshape(T * T, ND * ND)


def test_k1_twin_masks_equal_jax(k1):
    masks, _, _ = _torch_k1(k1)
    ref = _jax_masks_core(k1["masks"])
    got = masks[0].numpy().astype(np.float32)
    assert 1.5 < ref.sum() / ref[:, ND * ND // 2].sum() < 20
    np.testing.assert_array_equal(got, ref)


def test_k1_twin_moments_match_jax(k1):
    _, m2, misc = _torch_k1(k1)
    np.testing.assert_allclose(m2[0].numpy(), k1["m2"], rtol=2e-5, atol=1e-5)
    misc, ref = misc[0].numpy(), k1["misc"]
    np.testing.assert_allclose(misc[:, : D + 54], ref[:, : D + 54],
                               rtol=2e-5, atol=1e-5)
    # set size and center flag exact
    np.testing.assert_array_equal(misc[:, D + 54 : D + 56],
                                  ref[:, D + 54 : D + 56])


def test_k4_twin_matches_jax(k1):
    import jax.numpy as jnp
    from bcd_tpu.ops.fused_pallas import apply_scatter2

    rng = np.random.default_rng(77)
    n_map = k1["misc"][:, D + 54].reshape(T, T)
    cv = k1["misc"][:, D + 55].reshape(T, T) > 0
    a2 = rng.standard_normal((T, T, D, D)).astype(np.float32) * 0.1
    b2 = rng.standard_normal((T, T, D)).astype(np.float32)
    mvec = rng.standard_normal((T, T, D)).astype(np.float32)
    is_main = (n_map >= 12) & cv  # b=2 has 25 offsets: a test-local gate
    is_fb = cv & ~is_main
    assert is_main.any() and is_fb.any()
    a2t = np.swapaxes(a2, -1, -2).reshape(T * T, D * D)
    small = np.zeros((T * T, SMALL_CH), np.float32)
    small[:, 0:D] = b2.reshape(-1, D)
    small[:, D] = is_main.reshape(-1)
    small[:, D + 1 : 2 * D + 1] = (is_fb[..., None] * mvec).reshape(-1, D)
    small[:, 2 * D + 1] = is_fb.reshape(-1)

    small_jax = np.zeros((T * T, 64), np.float32)
    small_jax[:, :SMALL_CH] = small
    ref = np.asarray(apply_scatter2(
        jnp.asarray(k1["masks"]), jnp.asarray(a2t), jnp.asarray(small_jax),
        jnp.asarray(k1["color"].reshape(TP * TP, 3)),
        t=T, r=1, b=B, interpret=True)).reshape(TP, TP, 4)

    masks = torch.from_numpy(
        _jax_masks_core(k1["masks"]).astype(np.uint8)[None])
    got = tfused.apply_scatter(
        masks, torch.from_numpy(a2t[None]), torch.from_numpy(small[None]),
        torch.from_numpy(k1["color"][None].copy()), t=T, h=H, b=B)[0].numpy()
    np.testing.assert_allclose(got[..., :3], ref[..., :3], rtol=3e-5,
                               atol=3e-5)
    np.testing.assert_array_equal(got[..., 3], ref[..., 3])


def test_tri_geometry_matches_jax():
    from bcd_tpu.ops.fused_pallas import tri_geometry as jax_tri

    for got, ref in zip(tfused.tri_geometry(D), jax_tri(D)):
        np.testing.assert_array_equal(got, ref)
    full = np.arange(D * D).reshape(D, D)
    full = np.minimum(full, full.T)  # any symmetric matrix
    packed = full.reshape(-1)[tfused._tri_pack(D)]
    _, expand, _ = tfused.tri_geometry(D)
    np.testing.assert_array_equal(packed[expand], full.reshape(-1))


# ---------------------------------------------------------------------------
# K1's chi^2 geometry on the card (csrc/masks_moments.cu::chi2_masks_kernel)
# ---------------------------------------------------------------------------


def _slabs(s):
    return (torch.from_numpy(s["histo"][None].copy()),
            torch.from_numpy(s["nb"][None].copy()))


def test_chi2_mirror_identity_bitwise(k1):
    """term_-o(z) = term_o(z - o): the per-pixel chi^2 term of a pixel pair
    does not depend on which pixel is the center, bit for bit, so K1's
    kernel evaluates each pair once and uses it for o and -o."""
    histo, nb = _slabs(k1)
    num, cnt = tfused.chi2_pixels_plain(histo, nb, T, H, B)
    n_off, e1 = ND * ND, T + 2
    for o in range(n_off // 2 + 1, n_off):
        dy, dx = o // ND - B, o % ND - B
        neg = n_off - 1 - o
        # term_-o at ext pixel (y, x) against term_o at (y - dy, x - dx)
        ys, xs = slice(dy, e1), slice(max(dx, 0), e1 + min(dx, 0))
        ym, xm = slice(0, e1 - dy), slice(max(-dx, 0), e1 - max(dx, 0))
        for a in (num, cnt):
            assert torch.equal(a[:, neg, ys, xs], a[:, o, ym, xm]), (o, dy, dx)


def _banded_distances(histo, nb, t, h, b, bh, bw):
    """The kernel's chi^2 geometry in numpy: per band of bh x bw centers,
    the staged region with a (b+1) halo, the terms of each offset after the
    self offset over the bounding box of the band's patch pixels and their
    images under -o, and box sums into the distances of o and -o."""
    nd = 2 * b + 1
    n_off = nd * nd
    dist = np.full((t, t, n_off), np.nan, np.float64)
    for y0 in range(0, t, bh):
        for x0 in range(0, t, bw):
            nh, nwd = min(bh, t - y0), min(bw, t - x0)
            rows, cols = nh + 2, nwd + 2
            gy0, gx0 = h + y0 - 1 - b, h + x0 - 1 - b
            hs = histo[gy0 : gy0 + rows + 2 * b, gx0 : gx0 + cols + 2 * b]
            ns = nb[gy0 : gy0 + rows + 2 * b, gx0 : gx0 + cols + 2 * b, 0]
            for o in range(n_off // 2 + 1, n_off):
                dy, dx = o // nd - b, o % nd - b
                br0, bc0 = b - dy, b - max(dx, 0)
                b_r, b_c = rows + dy, cols + abs(dx)
                hc = hs[br0 : br0 + b_r, bc0 : bc0 + b_c]
                hn = hs[br0 + dy : br0 + dy + b_r, bc0 + dx : bc0 + dx + b_c]
                nc = ns[br0 : br0 + b_r, bc0 : bc0 + b_c, None]
                nn = ns[br0 + dy : br0 + dy + b_r, bc0 + dx : bc0 + dx + b_c,
                        None]
                hsum = hc + hn
                keep = hsum > 1.0
                den = np.where(keep, nc * nn * hsum, 1.0)
                den = np.where(den == 0.0, 1.0, den)
                term = np.where(keep, (nn * hc - nc * hn) ** 2 / den, 0.0)
                num, cnt = term.sum(-1), keep.sum(-1).astype(np.float64)
                for oo, r0, c0 in ((o, dy, max(dx, 0)),
                                   (n_off - 1 - o, 0, max(-dx, 0))):
                    bn = sum(num[r0 + qy : r0 + qy + nh, c0 + qx : c0 + qx + nwd]
                             for qy in range(3) for qx in range(3))
                    bc = sum(cnt[r0 + qy : r0 + qy + nh, c0 + qx : c0 + qx + nwd]
                             for qy in range(3) for qx in range(3))
                    dist[y0 : y0 + nh, x0 : x0 + nwd, oo] = np.where(
                        bc > 0, bn / np.maximum(bc, 1.0), np.inf)
    return dist


@pytest.mark.parametrize("band", [None, (5, 7)])
def test_banded_mirror_geometry_matches_distances(k1, band):
    """The bands (None: the whole tile, the kernel's band at T = 16, B = 2,
    30 bins; and 5 x 7, which divides neither side), the staging offsets,
    the bounding boxes and the mirror map every center and non-self offset
    onto the distance distances_plain computes."""
    histo, nb = _slabs(k1)
    want = tfused.distances_plain(histo, nb, T, H, B)[0].numpy()
    bh, bw = band or (T, T)
    got = _banded_distances(k1["histo"].astype(np.float64),
                            k1["nb"].astype(np.float64), T, H, B, bh, bw)
    self_o = ND * ND // 2
    got, want = np.delete(got, self_o, -1), np.delete(want, self_o, -1)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)


def test_kernel_bounds_reckoning():
    """ops/bounds.py at the engine's 128-tile batch: K1 (every offset
    selected) and K2 are bound by fp32 operations, at the least times the
    kernels are reported against. Every solve counts the one-sided
    fast-Givens Jacobi, 10 dp flops a row pair a round: at the -w 2 batch
    (16,384 centers, 169 candidates, d = 75, 6 sweeps) solve_filter's bound
    is about 4.8 ms, the lane solve_matrices' on 2,048 centers 0.51 ms."""
    from bcd_tpu_torch.ops import bounds

    n_sel = 128 * 32 * 32 * 169
    ms, by = bounds.k1(128, 32, 7, 6, 60, n_sel)
    assert by == "operations" and 0.3 < ms < 0.5
    ms, by = bounds.k2(128 * 32 * 32, 4)
    assert by == "operations" and 1.0 < ms < 1.4
    assert bounds.k2(1000, 6)[0] > bounds.k2(1000, 4)[0]
    for ms, by in bounds.probes().values():
        assert ms > 0 and by in ("operations", "bytes")
    dp = 76
    assert bounds._jacobi(75, 6) == 6 * (dp - 1) * (dp // 2) * 10 * dp \
        + 2 * dp * dp
    ms, by = bounds.solve_filter(16384, 169, 75, 6)
    assert by == "operations" and 4.7 < ms < 4.9
    ms, by = bounds.solve_matrices(2048, 75, 6)
    assert by == "operations" and 0.50 < ms < 0.52

