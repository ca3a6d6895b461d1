"""What transpose A's and D's tensor-core kernel (csrc/probes.cu's
transpose_wgmma_kernel) relies on for its exactness, on the host: the
plain model of its TF32 rounding (``probes.tf32_rna``, cvt.rna.tf32.f32)
against an exact rounding in fractions, the three-part split of m2
(``probes.split3``) summed back in the kernel's order, the expansion
matrix exact in TF32, and the three products summed as the kernel sums
them (``transpose_mma_model``) giving the plain version's lanes bit for
bit. Then the batched banded dot's (csrc/probes.cu's banded_mma_kernel)
order of sums, ``probes.banded_mma_model``: S's three parts, each k-step's
products with a 0/1 B, one accumulator, held to the plain version and to
float64. The kernels themselves are held to their plain versions on the
card (tests/test_torch_kernels_gpu.py, chip_smoke.py phase 18)."""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from bcd_tpu_torch.ops import bounds, probe_library
from bcd_tpu_torch.ops import probes as tp
from tests.torch_workers import share_cores

share_cores()


def _tf32_exact(x: float) -> float:
    """x rounded to 11 significant bits, to nearest with ties away from
    zero, in exact arithmetic."""
    if x == 0 or not math.isfinite(x):
        return x
    m, e = math.frexp(abs(x))  # |x| = m 2^e, 0.5 <= m < 1
    scaled = Fraction(m) * 2 ** 11
    down = math.floor(scaled)
    up = down + (1 if scaled - down >= Fraction(1, 2) else 0)
    return math.copysign(float(Fraction(up, 2 ** 11) * Fraction(2) ** e), x)


def _wide(n: int, seed: int):
    """float32 values of both signs over exponents -60 .. 60, and the ties
    and their neighbours of TF32's rounding."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp2(rng.integers(-60, 60, n))
    one = np.float32(1.0)
    tie = np.float32(1 + 2.0 ** -11)
    near = [one, tie, np.nextafter(tie, one), np.nextafter(tie, np.float32(2)),
            np.float32(1.5 + 2.0 ** -11), np.float32(2 - 2.0 ** -11)]
    return torch.tensor(np.concatenate([x.astype(np.float32), near,
                                        np.negative(near)]))


def transpose_mma_model(m2, expand):
    """lanes (M, P) as the kernel sums it: the three products expand lo^T,
    expand mid^T, expand hi^T of m2's parts (``probes.split3``) added in
    that order to one float32 accumulator, each product formed in float64
    (exact where ``expand``'s rows are one-hot and exact in TF32) and each
    sum rounded to float32, so that no BLAS reorders it."""
    acc = torch.zeros((expand.shape[0], m2.shape[0]), dtype=torch.float32)
    e64 = expand.double()
    for part in reversed(tp.split3(m2)):
        acc = (acc.double() + e64 @ part.double().T).float()
    return acc


def test_tf32_rna_rounds_to_nearest_with_ties_away():
    """``tf32_rna`` against exact rounding to 11 significant bits, ties
    away from zero, on values of both signs over 120 binades and at the
    ties; its 13 low mantissa bits are zero; infinities and NaN stay."""
    x = _wide(2000, 1)
    got = tp.tf32_rna(x)
    want = torch.tensor([_tf32_exact(float(v)) for v in x],
                        dtype=torch.float32)
    assert torch.equal(got, want)
    assert not bool((got.view(torch.int32) & 0x1FFF).any())
    assert float(tp.tf32_rna(torch.tensor([1 + 2.0 ** -11]))) == 1 + 2.0 ** -10
    assert float(tp.tf32_rna(torch.tensor([-(1 + 2.0 ** -11)]))) \
        == -(1 + 2.0 ** -10)
    special = torch.tensor([float("inf"), float("-inf"), float("nan")])
    out = tp.tf32_rna(special)
    assert torch.equal(out[:2], special[:2]) and bool(out[2].isnan())


@pytest.mark.parametrize("data", ["script", "wide"])
def test_split3_parts_sum_back_in_the_kernels_order(data):
    """(a) m2's three TF32 parts, added as the kernel's accumulator adds
    them (lo, then mid, then hi), give m2 bit for bit in float32: each part
    is a TF32 value, and each remainder is exact (x - hi - mid is lo). On
    ``probe_library.transpose_inputs``' m2 and on values over 120
    binades."""
    if data == "script":
        m2, _, _ = probe_library.transpose_inputs(torch.device("cpu"))
    else:
        m2 = _wide(4096, 2)
    hi, mid, lo = tp.split3(m2)
    for part in (hi, mid, lo):
        assert torch.equal(part, tp.tf32_rna(part))
    assert torch.equal((lo + mid) + hi, m2)
    assert torch.equal((m2 - hi) - mid, lo)


def test_expand_is_exact_in_tf32_with_one_one_a_row():
    """(b) The expansion matrix the kernel takes as the B operand in one
    TF32 part: its entries are TF32 values (0 and 1), one 1 a row, at the
    gather index's column."""
    _, expand, index = probe_library.transpose_inputs(torch.device("cpu"))
    assert torch.equal(expand, tp.tf32_rna(expand))
    assert torch.equal(expand.sum(1), torch.ones(expand.shape[0]))
    assert torch.equal(expand.argmax(1), index.long())


@pytest.mark.parametrize("p", [2304, 96])
def test_three_product_model_is_the_plain_lanes(p):
    """(c) The kernel's three products, expand lo^T + expand mid^T + expand
    hi^T summed in float32 in that order (each product in float64, each sum
    rounded to float32, so no BLAS reorders it), are the plain version's
    lanes bit for bit, and their transpose its back, at the script's P and
    at a P that the kernel's 128-pixel tile does not divide."""
    m2, expand, index = probe_library.transpose_inputs(torch.device("cpu"))
    m2 = m2[:p].contiguous()
    lanes = transpose_mma_model(m2, expand)
    plain = tp.transpose_plain(m2, index)
    assert lanes.dtype == torch.float32 and lanes.shape == (729, p)
    assert torch.equal(lanes, plain[0])
    assert torch.equal(lanes.T.contiguous(), plain[1])


def test_transpose_mma_floor_is_three_tf32_products():
    """The design's floor: three TF32 products of the (729, 378) expansion
    and (P, 378) parts at the dense TF32 rate, about 7.7 us at P = 2304,
    above the bytes bound of a gather (A 0.0051 ms is below it, D 0.0030)."""
    floor = bounds.transpose_mma_floor()
    assert floor == pytest.approx(1e3 * 3 * 2 * 729 * 378 * 2304 / 495e12)
    assert 0.0076 < floor < 0.0078
    variants = bounds.probe_variants()
    assert floor > variants["probe_transpose_a"][0]
    assert floor > variants["probe_transpose_d"][0]
    assert bounds.transpose_mma_floor(96) == pytest.approx(floor / 24)


def _banded(shape, seed: int = 4):
    """0/1 B (Y, T, T), a 13-wide band as the script's, and S (Y, T, C)."""
    n_y, t, c = shape
    rng = np.random.default_rng(seed)
    ri, ci = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    band = (rng.random((n_y, t, t)) < 0.5) & (np.abs(ri - ci) <= 6)
    return (torch.tensor(band, dtype=torch.float32),
            torch.tensor(rng.random((n_y, t, c)), dtype=torch.float32))


@pytest.mark.parametrize("shape", ["script", (3, 32, 96), (2, 40, 90),
                                   (2, 30, 96)])
def test_banded_mma_model_holds_to_plain_and_float64(shape):
    """(d) The batched banded kernel's order of sums
    (``probes.banded_mma_model``: S split into three TF32 parts, each
    k-step of 8 adding its lo, mid and hi products to one float32
    accumulator) on the script's inputs and at ragged shapes: within
    ``FP32_REL`` of the plain version's largest magnitude from the plain
    version and from float64, and its B exact in TF32 (0/1), so that every
    product is exact."""
    if shape == "script":
        b, s = probe_library.banded_inputs(torch.device("cpu"))
    else:
        b, s = _banded(shape)
    assert torch.equal(b, tp.tf32_rna(b))
    got = tp.banded_mma_model(b, s)
    plain = tp.banded_plain(b, s)
    assert got.dtype == torch.float32 and got.shape == plain.shape
    limit = probe_library.FP32_REL * float(plain.abs().max())
    ref64 = torch.bmm(b.double(), s.double())
    assert float((got.double() - plain.double()).abs().max()) <= limit
    assert float((got.double() - ref64).abs().max()) <= limit


def test_banded_mma_model_one_step_is_exact():
    """(e) Where T is one k-step (8), the model's lo, mid and hi products
    summed in that order into one accumulator give float64's sum to within
    one float32 rounding of each addition: the three parts are S exactly
    (``split3``), so only the accumulator's roundings part the two."""
    b, s = _banded((2, 8, 64), seed=9)
    got = tp.banded_mma_model(b, s).double()
    ref64 = torch.bmm(b.double(), s.double())
    ulp = torch.finfo(torch.float32).eps * ref64.abs().clamp(min=1e-30)
    assert bool(((got - ref64).abs() <= 2 * ulp).all())
