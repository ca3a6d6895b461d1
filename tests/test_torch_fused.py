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
