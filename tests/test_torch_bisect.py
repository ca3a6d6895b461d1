"""The port's staged d = 27 solve (bcd_tpu_torch/ops/bisect.py) against
scripts/bisect_kernel.py, the TPU kernel it stands for: the script's own
Pallas kernel body, rebuilt with its block specs in interpret mode. The
script runs its kernel on the chip when imported, so it is never imported
here: its source up to its timed call runs in a namespace of its own, with
the stage as its argument. The CUDA kernel itself is held to the plain
version on the card (tests/test_torch_kernels_gpu.py, chip_smoke.py)."""

import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bcd_tpu_torch.ops import _build, bounds
from bcd_tpu_torch.ops import bisect as tb
from tests.torch_workers import share_cores

share_cores()

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "bisect_kernel.py"
# the script's source before its timed call of the compiled kernel
HEAD = SCRIPT.read_text().split("t0 = time.perf_counter()")[0]
CPU = torch.device("cpu")
# a stage name the script does not know: it runs every stage
UNKNOWN = "solve"


def _script(stage: str) -> dict:
    """The script's globals after its source up to the timed call, run with
    ``stage`` as its argument; sys.argv and sys.path are put back."""
    argv, path = sys.argv, list(sys.path)
    sys.argv = [str(SCRIPT), stage]
    ns = {"__name__": "_bisect_kernel", "__file__": str(SCRIPT)}
    try:
        exec(compile(HEAD, str(SCRIPT), "exec"), ns)
    finally:
        sys.argv = argv
        sys.path[:] = path
    return ns


def _interpret(ns) -> np.ndarray:
    """The script's ``fn`` rebuilt from its ``kernel`` and its block specs
    (scripts/bisect_kernel.py:142-154) with interpret=True, on its inputs."""
    O, d, P, npx = ns["O"], ns["d"], ns["P"], ns["npx"]

    def whole(*shape):
        return pl.BlockSpec(shape, lambda i: (0,) * len(shape),
                            memory_space=pltpu.VMEM)

    fn = pl.pallas_call(
        ns["kernel"], grid=(1,),
        in_specs=[whole(O, d, P), whole(O, P), whole(6 * npx, P),
                  whole(1, P), whole(d, P)],
        out_specs=whole(d, P),
        out_shape=jax.ShapeDtypeStruct((d, P), jnp.float32),
        interpret=True)
    return np.asarray(fn(ns["C"], ns["mask"], ns["noise"], ns["n"], ns["m"]))


def _inputs(ns):
    return tuple(torch.from_numpy(np.array(ns[k]))
                 for k in ("C", "mask", "noise", "n", "m"))


def test_inputs_are_the_scripts_draws():
    """C, mask, noise and n bit for bit the script's; m within float32
    rounding of it (the script sums it in JAX, in another order)."""
    ns = _script("m2")
    assert (ns["P"], ns["O"], ns["d"], ns["npx"]) == (tb.P, tb.O, tb.D,
                                                      tb.NPX)
    assert (ns["dp"], ns["half"]) == (tb.DP, tb.HALF)
    got = tb.bisect_inputs(CPU)
    want = _inputs(ns)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    assert got[4].shape == want[4].shape
    assert float((got[4] - want[4]).abs().max()) <= 4e-7 * float(
        want[4].abs().max())


@pytest.mark.parametrize("stage", [*tb.STAGES, UNKNOWN])
def test_plain_matches_the_script_kernel(stage):
    """Each stage, and a name the script does not know (every stage, the
    factor's row), on the script's inputs at its full shapes: the plain
    version against the script's kernel in interpret mode, within
    ``TOLERANCE`` of the largest magnitude (1e-6 at m2 and bd, 2e-4 from
    the Jacobi on; float32 rounded in two orders parts by 9.1e-8 at m2 to
    4.5e-5 at jacobi)."""
    ns = _script(stage)
    assert ns["STAGE"] == stage
    want = _interpret(ns)
    got = tb.bisect_plain(*_inputs(ns), stage)
    assert got.shape == want.shape == (tb.D, tb.P)
    assert np.isfinite(want).all()
    limit = tb.TOLERANCE[tb.STAGES[tb.stage_index(stage)]]
    assert tb.rel_err(got, torch.from_numpy(want.copy())) <= limit


@pytest.mark.parametrize("stage", tb.STAGES)
def test_plain_float32_matches_float64(stage):
    """The plain version in float32 against its float64 run on the port's
    inputs, within the same limits (it reads 3.3e-7 at m2, 4.6e-7 at bd,
    4.0e-5 at jacobi, 1.1e-5 at recon, 4.1e-6 at chol)."""
    x = tb.bisect_inputs(CPU)
    got = tb.bisect_plain(*x, stage)
    ref = tb.bisect_plain(*(t.double() for t in x), stage)
    assert got.dtype == torch.float32 and ref.dtype == torch.float64
    assert tb.rel_err(got, ref) <= tb.TOLERANCE[stage]


def test_stage_names_and_the_round_robin_order():
    """The stage index: a name outside STAGES runs the last; the Jacobi's
    round-robin order is [0, 14, 1..12, 15..27, 13] and comes back to the
    identity after its 27 rounds."""
    assert [tb.stage_index(s) for s in tb.STAGES] == list(range(5))
    assert tb.stage_index(UNKNOWN) == tb.stage_index("") == 4
    order = tb._permute(torch.arange(tb.DP), 0).tolist()
    assert order == [0, 14, *range(1, 13), *range(15, 28), 13]
    x, back = torch.arange(tb.DP), []
    for _ in range(tb.DP - 1):
        x = tb._permute(x, 0)
        back.append(torch.equal(x, torch.arange(tb.DP)))
    assert back == [False] * (tb.DP - 2) + [True]


def test_wrapper_on_the_cpu_is_the_plain_version():
    """On CPU tensors the wrapper returns the plain version and launches
    nothing; each stage has its launch counter."""
    x = tb.bisect_inputs(CPU)
    _build.reset_launches()
    for stage in (*tb.STAGES, UNKNOWN):
        assert torch.equal(tb.bisect(*x, stage), tb.bisect_plain(*x, stage))
    assert not any(_build.LAUNCHES.values())
    assert [k for k in _build.LAUNCHES if k.startswith("bisect_")] == [
        f"bisect_{s}" for s in tb.STAGES]


def test_entry_point_prints_the_scripts_line(capsys):
    """``python -m bcd_tpu_torch.ops.bisect jacobi --device cpu`` prints the
    script's line with the plain version's checksum; the default stage is
    m2; without a card the default device is refused."""
    x = tb.bisect_inputs(CPU)
    for argv, stage in ((["jacobi", "--device", "cpu"], "jacobi"),
                        (["--device", "cpu"], "m2")):
        assert tb.main(argv) == 0
        line = capsys.readouterr().out.strip()
        match = re.fullmatch(
            rf"STAGE={stage} OK, checksum=(-?\d+\.\d{{4}}), \d+\.\ds", line)
        assert match, line
        total = float(tb.bisect_plain(*x, stage).sum())
        assert match.group(1) == f"{total:.4f}"
    if not torch.cuda.is_available():
        assert tb.main(["chol"]) == 1
        assert "no CUDA device" in capsys.readouterr().out


def test_wrapper_refuses_bad_inputs():
    x = list(tb.bisect_inputs(CPU))
    with pytest.raises(ValueError, match="float32"):
        tb.bisect(*[t.double() for t in x])
    with pytest.raises(ValueError, match="C"):
        tb.bisect(x[0][:, :26], *x[1:])
    with pytest.raises(ValueError, match="mask"):
        tb.bisect(x[0], x[1][:, :77], *x[2:])
    with pytest.raises(ValueError, match="noise"):
        tb.bisect(*x[:2], x[2][:27], *x[3:])
    with pytest.raises(ValueError, match="unsupported device"):
        tb.bisect(*[t.to("meta") for t in x])


def test_bisect_bounds_are_bytes():
    """Each stage's bound counts the bytes its function needs (C and the
    mask, from bd on the noise, n and m, the row written) over 3.35 TB/s,
    about 0.73 to 0.74 us; the operations of every stage up to it come
    under that."""
    b = bounds.bisect_stages()
    assert list(b) == list(tb.STAGES)
    base = 4 * 128 * (169 * 27 + 169 + 27)
    for k, (stage, (ms, by)) in enumerate(b.items()):
        nbytes = base + (4 * 128 * (54 + 1 + 27) if k else 0)
        assert by == "bytes", stage
        assert ms == pytest.approx(1e3 * nbytes / bounds.HBM_BYTES)
    assert 0.00072 < b["m2"][0] < b["chol"][0] < 0.00075


@pytest.mark.parametrize("p", [128, 77])
def test_m2_library_call_is_the_m2_stage(p):
    """The one PyTorch call that computes the ``m2`` stage (the kernels
    line's library time for ``bisect_m2``), an einsum over the candidates,
    on the script's inputs: row 0 of the masked second moments, within the
    stage's tolerance of the float64 plain version (sums of 169 products
    in its own order)."""
    x = [t[..., :p].contiguous() for t in tb.bisect_inputs(CPU)]
    got = tb.m2_library(*x[:2])
    assert got.shape == (tb.D, p) and got.dtype == torch.float32
    ref64 = tb.bisect_plain(*(t.double() for t in x), "m2")
    assert tb.rel_err(got, ref64) <= tb.TOLERANCE["m2"]


@pytest.mark.parametrize("p", [128, 77])
def test_m2_full_library_call_is_the_whole_m2(p):
    """The one PyTorch call that forms all 729 entries of M2, as every stage
    of the kernel does (``m2_full_library``, an einsum; phase 19 times it
    beside the row-0 call), on the script's inputs: within the ``m2``
    stage's tolerance of the plain version's whole M2 (``m2_plain``, which
    ``bisect_plain`` sums) in float32 and in float64; that M2's row 0 is the
    ``m2`` stage's output."""
    x = [t[..., :p].contiguous() for t in tb.bisect_inputs(CPU)]
    got = tb.m2_full_library(*x[:2])
    assert got.shape == (tb.D, tb.D, p) and got.dtype == torch.float32
    plain = tb.m2_plain(*x[:2])
    assert torch.equal(plain[0], tb.bisect_plain(*x, "m2"))
    assert tb.rel_err(got, plain) <= tb.TOLERANCE["m2"]
    ref64 = tb.m2_plain(*(t.double() for t in x[:2]))
    assert tb.rel_err(got, ref64) <= tb.TOLERANCE["m2"]


def test_kernel_count_follows_the_stages():
    """The entry launches M2's kernel alone at ``m2`` and the later stages'
    after it from ``bd`` on; the wrapper counts both, and a name outside
    the stages counts as ``chol``."""
    assert [tb.kernel_count(i) for i in range(len(tb.STAGES))] == \
        [1, 2, 2, 2, 2]
    assert tb.kernel_count(tb.stage_index("solve")) == 2


def test_split_needs_the_card(capsys):
    """``--split`` times the kernel's copies on the card: asked for the CPU
    it refuses, building nothing."""
    assert tb.main(["--split", "--device", "cpu"]) == 1
    assert "needs the card" in capsys.readouterr().out
    assert tb.CUTS == {"kernel": 0, "no products": 1, "no staging": 2}
