"""The plain versions of the port's probe microbenchmarks
(bcd_tpu_torch/ops/probes.py) against the TPU-compiler probes they stand
for: the scripts' own Pallas kernel bodies (scripts/probe_transpose.py,
scripts/probe_mosaic.py) run with the scripts' block specs in interpret
mode, and, for scripts/probe_banded_dot.py (which runs its work when
imported), the float64 einsum the script holds its kernels to. The CUDA
kernels themselves are held to these plain versions on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bcd_tpu_torch.ops import _build, bounds, probe_library
from bcd_tpu_torch.ops import probes as tp
from tests.torch_workers import share_cores

share_cores()

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
# the scripts' settings that importing them changes
_CONFIG = ("jax_compilation_cache_dir",
           "jax_persistent_cache_min_compile_time_secs")


def _script(name):
    """Import scripts/<name>.py, then put back the JAX settings its import
    changed (its compile cache), so that later tests in this worker run as
    before."""
    saved = {k: getattr(jax.config, k) for k in _CONFIG}
    spec = importlib.util.spec_from_file_location(f"_probe_{name}",
                                                  SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return module


@pytest.fixture(scope="module")
def transpose_script():
    return _script("probe_transpose")


@pytest.fixture(scope="module")
def mosaic_script():
    return _script("probe_mosaic")


def _transpose_jax(script, kernel, m2_pm):
    """The script's ``run`` call of ``kernel`` (its grid and block specs),
    in interpret mode, on m2_pm (P, DTRI): (out (729, P), small (P, 729))."""
    p_total = m2_pm.shape[0]
    d, lanes = script.D, script.LANES
    expand = np.zeros((d * d, script.DTRI), np.float32)
    expand[np.arange(d * d), script.TRI_EXPAND] = 1.0
    out, small = pl.pallas_call(
        kernel,
        grid=(p_total // lanes,),
        in_specs=[pl.BlockSpec((d * d, script.DTRI), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((lanes, script.DTRI), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=[pl.BlockSpec((d * d, lanes), lambda i: (0, i),
                                memory_space=pltpu.VMEM),
                   pl.BlockSpec((lanes, d * d), lambda i: (i, 0),
                                memory_space=pltpu.VMEM)],
        out_shape=[jax.ShapeDtypeStruct((d * d, p_total), jnp.float32),
                   jax.ShapeDtypeStruct((p_total, d * d), jnp.float32)],
        interpret=True,
    )(jnp.asarray(expand), jnp.asarray(m2_pm))
    return np.asarray(out), np.asarray(small)


# 256 of the script's 2304 pixel rows (two of its 128-row blocks)
TRANSPOSE_ROWS = 256


def _transpose_inputs():
    m2, expand, index = probe_library.transpose_inputs(torch.device("cpu"))
    return m2[:TRANSPOSE_ROWS].contiguous(), expand, index


@pytest.mark.parametrize("variant,kernel", [("a", "_kernel_mxu"),
                                            ("b", "_kernel_swap"),
                                            ("d", "_kernel_fwd_only")])
def test_transpose_plain_is_the_script_kernel_bit_for_bit(transpose_script,
                                                          variant, kernel):
    """Transpose variants A, B and D: the port's plain version (the gather
    and ``.T.contiguous()``, what each wrapper returns on the CPU) gives the
    script's kernel's outputs bit for bit: the expansion to lane-major
    (729, P), and for A and B its transpose back to pixel rows (the
    script's D writes zeros there)."""
    m2, expand, index = _transpose_inputs()
    assert np.array_equal(m2.numpy(), np.asarray(
        np.random.default_rng(0).standard_normal(
            (2304, transpose_script.DTRI)), np.float32)[:TRANSPOSE_ROWS])
    out, small = _transpose_jax(transpose_script,
                                getattr(transpose_script, kernel), m2.numpy())
    got = {"a": lambda: tp.transpose_mma(m2, expand),
           "b": lambda: tp.transpose_gather(m2, index),
           "d": lambda: tp.transpose_mma(m2, expand, back=False)}[variant]()
    assert np.array_equal(got[0].numpy(), out)
    if variant == "d":
        assert len(got) == 1 and not small.any()
    else:
        assert np.array_equal(got[1].numpy(), small)
    assert all(torch.equal(g, p) for g, p in zip(
        got, tp.transpose_plain(m2, index)))


def test_transpose_copy_plain_moves_the_bytes():
    """Transpose variant C, the I/O baseline: both outputs hold m2's floats
    in order, repeated, at the expansion's shapes."""
    m2, _, _ = _transpose_inputs()
    lanes, back = tp.transpose_copy(m2, 729)
    assert lanes.shape == (729, TRANSPOSE_ROWS)
    assert back.shape == (TRANSPOSE_ROWS, 729)
    flat = m2.reshape(-1)
    for out in (lanes, back):
        o = out.reshape(-1)
        assert torch.equal(o[:flat.numel()], flat)
        assert torch.equal(o[flat.numel():], flat[:o.numel() - flat.numel()])


def _mosaic_jax(script, kernel, shifts, g):
    """The script's ``run`` call of ``kernel`` in interpret mode: the
    (NPIX, C) sum, where the script returns only its total."""
    return np.asarray(pl.pallas_call(
        kernel,
        grid=(len(shifts),),
        in_specs=[pl.BlockSpec((len(shifts), 1), lambda o: (0, 0),
                               memory_space=pltpu.SMEM),
                  pl.BlockSpec((script.ROWS, script.C), lambda o: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((script.NPIX, script.C), lambda o: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((script.NPIX, script.C), jnp.float32),
        scratch_shapes=[pltpu.VMEM((script.NPIX, script.C), jnp.float32)],
        interpret=True,
    )(jnp.asarray(np.asarray(shifts), jnp.int32).reshape(-1, 1),
      jnp.asarray(g)))


@pytest.mark.parametrize("aligned", [True, False])
def test_mosaic_plain_matches_the_script_kernel(mosaic_script, aligned):
    """Both mosaic variants on the script's full (2896, 729) slab from
    ``default_rng(0)``, the script's shifts (-6..6, and 48 s + 3 for the
    unaligned kernel): the plain version within 3e-5 absolute of the
    script's kernel (sums of 39 and 13 float32 terms, rounded in other
    places), and within that of the float64 sum."""
    g = probe_library.mosaic_inputs(torch.device("cpu"))
    assert (mosaic_script.ROWS, mosaic_script.C, mosaic_script.NPIX,
            mosaic_script.R0) == (probe_library.ROWS, probe_library.C,
                                  tp.NPIX, tp.R0)
    assert np.array_equal(g.numpy(), np.asarray(
        np.random.default_rng(0).random((mosaic_script.ROWS,
                                         mosaic_script.C)), np.float32))
    shifts = tp.ALIGNED_SHIFTS if aligned else tp.UNALIGNED_SHIFTS
    kernel = (mosaic_script._kernel_aligned if aligned
              else mosaic_script._kernel_unaligned)
    want = _mosaic_jax(mosaic_script, kernel, shifts, g.numpy())
    got = tp.mosaic(g, shifts, aligned)
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) < 3e-5
    rows, weights = tp.mosaic_windows(shifts, aligned)
    g64 = g.double()
    ref = sum(g64[r:r + tp.NPIX] * w for r, w in zip(rows, weights))
    assert float((got.double() - ref).abs().max()) < 3e-5


def test_mosaic_windows_and_their_alignment():
    """The aligned kernel's 39 windows start 8 + dx rows past bases that are
    multiples of 8; a 729-float row is 2,916 bytes, so only rows = 0 mod 4
    start on 16 bytes: 13 of the aligned windows (dx = 0), none of the
    unaligned ones (rows 3 mod 4). Every window lies within the slab."""
    rows, weights = tp.mosaic_windows(tp.ALIGNED_SHIFTS, True)
    assert len(rows) == 39 and weights[:3] == list(tp.WEIGHTS)
    assert [(r - 8 - dx) % 8 for r, dx in zip(rows, tp.DX * 13)] == [0] * 39
    assert tp.window_alignment(True) == (13, 39, [0, 1])
    assert tp.window_alignment(False) == (0, 13, [3])
    for aligned in (True, False):
        rows, _ = tp.mosaic_windows(
            tp.ALIGNED_SHIFTS if aligned else tp.UNALIGNED_SHIFTS, aligned)
        assert min(rows) >= 0
        assert max(rows) + tp.NPIX <= probe_library.ROWS
    with pytest.raises(ValueError, match="leaves the slab"):
        tp.mosaic(torch.zeros(100, 8), (0,), False, npix=99 + 2)


@pytest.mark.parametrize("batched", [True, False])
def test_banded_plain_matches_the_scripts_float64_reference(batched):
    """The banded dot's plain version (``torch.bmm`` in float32) against the
    float64 einsum the script holds its kernels to
    (probe_banded_dot.py:79-81), on its first 4 of 60 rows, drawn from
    ``default_rng(0)`` as the script draws them: within 1e-5 (sums of up to
    13 terms below 1)."""
    b, s = probe_library.banded_inputs(torch.device("cpu"))
    rng = np.random.default_rng(0)
    ri, ci = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    band = (rng.random((60, 64, 64)) < 0.5) & (np.abs(ri - ci) <= 6)
    assert np.array_equal(b.numpy(), band.astype(np.float32))
    b, s = b[:4].contiguous(), s[:4].contiguous()
    got = tp.banded_dot(b, s, batched)
    ref64 = np.einsum("yik,ykc->yic", b.numpy().astype(np.float64),
                      s.numpy().astype(np.float64))
    assert got.shape == (4, 64, 768)
    assert float(np.abs(got.numpy() - ref64).max()) < 1e-5
    assert torch.equal(got, tp.banded_plain(b, s))


def test_every_variant_has_a_counter_a_bound_and_a_plain_version():
    """Each variant's name is its launch counter and has a bound; on the
    CPU its wrapper returns its plain version (no launch), which holds as
    the card's check holds it."""
    vs = tp.variants(torch.device("cpu"))
    names = [v.name for v in vs]
    assert names == [k for k in _build.LAUNCHES if k.startswith("probe_")]
    assert set(names) == set(bounds.probe_variants())
    cases = {name for name, _, _ in probe_library.cases(torch.device("cpu"))}
    assert {v.library for v in vs} - {None} <= cases
    _build.reset_launches()
    for v in vs:
        got = v.run()
        ok, err, _ = tp.held(v, got, v.plain())
        assert ok and err == 0.0, v.name
    assert not any(_build.LAUNCHES.values())
    for name, (ms, by) in bounds.probe_variants().items():
        assert ms > 0 and by == "bytes", name


def test_library_aligned_mosaic_sums_the_aligned_windows():
    """``probe_library``'s one call for the aligned mosaic, an einsum of the
    (13, 9) weights with the strided (13, 9, npix, 729) view, is the
    aligned kernel's function: the plain version's 39 weighted windows
    (on the first 16 rows of each window, to keep the view small)."""
    g = probe_library.mosaic_inputs(torch.device("cpu"))
    w, view = probe_library.aligned_windows(g, npix=16)
    assert w.shape == (13, 9) and int((w != 0).sum()) == 39
    got = torch.einsum("kj,kjnc->nc", w, view)
    want = tp.mosaic_plain(g, tp.ALIGNED_SHIFTS, True, npix=16)
    assert got.shape == want.shape == (16, probe_library.C)
    assert float((got - want).abs().max()) < 3e-5
    w64, view64 = probe_library.aligned_windows(g.double(), npix=16)
    ref = torch.einsum("kj,kjnc->nc", w64, view64)
    assert float((got.double() - ref).abs().max()) < 3e-5


def test_probe_bounds_count_only_what_the_function_needs():
    """The transpose's bounds read the expansion's 729 gather indices, not
    its 0/1 matrix, whatever a variant multiplies by (A's bytes are B's, D's
    one lane-major output fewer); the mosaic's read the rows its windows
    span, not the whole slab."""
    v = bounds.probe_variants()
    lanes_ms = 1e3 * 4 * 729 * 2304 / bounds.HBM_BYTES
    assert v["probe_transpose_a"] == v["probe_transpose_b"]
    assert v["probe_transpose_a"] == bounds.probes()["probe_transpose"]
    assert v["probe_transpose_d"][0] == pytest.approx(
        v["probe_transpose_a"][0] - lanes_ms)
    assert v["probe_transpose_c"][0] == pytest.approx(
        v["probe_transpose_a"][0] - 1e3 * 4 * 729 / bounds.HBM_BYTES)
    for aligned, shifts in ((True, tp.ALIGNED_SHIFTS),
                            (False, tp.UNALIGNED_SHIFTS)):
        rows, _ = tp.mosaic_windows(shifts, aligned)
        assert bounds.mosaic_span(aligned) == max(rows) + tp.NPIX - min(rows)
        name = f"probe_mosaic_{'aligned' if aligned else 'unaligned'}"
        want = 4 * (max(rows) + 2 * tp.NPIX - min(rows)) * tp.C
        assert v[name][0] == pytest.approx(1e3 * want / bounds.HBM_BYTES)
    assert v["probe_mosaic_unaligned"] == bounds.probes()["probe_mosaic"]


def test_probe_wrappers_refuse_bad_inputs():
    m2, expand, index = _transpose_inputs()
    with pytest.raises(ValueError, match="int32"):
        tp.transpose_gather(m2, index.long())
    with pytest.raises(ValueError, match="expected"):
        tp.transpose_mma(m2, expand[:, :10])
    with pytest.raises(ValueError, match="expected"):
        tp.banded_dot(torch.zeros(2, 8, 8), torch.zeros(2, 4, 16), True)
    with pytest.raises(ValueError, match="float32"):
        tp.mosaic(torch.zeros(100, 8, dtype=torch.float64), (0,), False,
                  npix=8)
