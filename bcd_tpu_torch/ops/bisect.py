"""``scripts/bisect_kernel.py``'s staged d = 27 solve on the card: the
ctypes wrapper of ``csrc/bisect.cu``, its plain PyTorch version, the
script's inputs and an entry point that prints the script's line:

    python -m bcd_tpu_torch.ops.bisect [STAGE] [--device cpu]

or, on a card, where the ``m2`` stage's time goes (``split``):

    python -m bcd_tpu_torch.ops.bisect --split

The script is a staged copy of the d = 27 ``solve_filter`` on one block of
P = 128 pixels of O = 169 candidates, written to find which stage crashed
the TPU compiler. For each pixel it writes row 0 of the matrix left after
the stage it is given (``STAGES``; the default ``m2``): the masked second
moments M2, Cemp - BD, A after one sweep of a two-sided Jacobi, the clamp
V^T max(lambda, 0) V, or the Cholesky factor of clamp + BD + 1e-8 I. A name
outside ``STAGES`` runs every stage and writes the factor's row, as the
script does. Its Jacobi is not the engine's one-sided fast-Givens form, and
one sweep does not converge, so the outputs depend on its schedule, which
both versions here follow.

``bisect`` given CPU tensors returns the plain version; given CUDA tensors
it launches the kernels, adds their number to
``_build.LAUNCHES["bisect_<stage>"]`` (one at ``m2``, two from ``bd`` on;
``bisect_chol`` for a name outside ``STAGES``) and raises if the launch
fails. The entry point runs on the card unless asked for the CPU
(``--device cpu``), and refuses without one; on the card it builds the
kernels before its clock starts. Nothing here builds or launches at
import.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import math
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bcd_tpu_torch.convert import resolve_device
from bcd_tpu_torch.ops import _build, bounds, probe_library

STAGES = ("m2", "bd", "jacobi", "recon", "chol")
# the script's block: pixels, candidates, patch dimension, patch pixels
P, O, D, NPX = 128, 169, 27, 9
# the Jacobi's padded dimension and its pairs (k, k + HALF)
DP, HALF = D + 1, (D + 1) // 2
# between rounds the rows and columns are reordered to these slices, in
# order: [0, 14, 1..12, 15..27, 13], a round-robin that fixes 0
PERM_SLICES = ((0, 1), (HALF, HALF + 1), (1, HALF - 1), (HALF + 1, DP),
               (HALF - 1, HALF))
# the noise channel of each entry of a pixel's 3 x 3 block, from the pairs
# (0,0), (1,1), (2,2), (1,2), (0,2), (0,1) in the order of the channels
CHANNEL = ((0, 5, 4), (5, 1, 3), (4, 3, 2))
# the largest gap each stage may show from its plain version on the card
# and from float64, over the reference's largest magnitude: float32
# rounding of sums of 169 products at m2 and bd (3.3e-7 from float64 on
# the CPU); at jacobi and after, the unconverged sweep (4.0e-5 there), its
# clamp and its factor
TOLERANCE = {"m2": 1e-6, "bd": 1e-6, "jacobi": 2e-4, "recon": 2e-4,
             "chol": 2e-4}
# calls of the plain version a timing (about 1,500 launches a call)
PLAIN_REPS = 5


def stage_index(stage: str) -> int:
    """The last stage that ``stage`` runs: its place in ``STAGES``, or the
    last for a name outside them."""
    return STAGES.index(stage) if stage in STAGES else len(STAGES) - 1


def kernel_count(last: int) -> int:
    """The kernels ``csrc/bisect.cu``'s entry launches to run the stages up
    to ``STAGES[last]``: M2's, and from ``bd`` on the later stages'."""
    return 1 if last == 0 else 2


def bisect_inputs(dev):
    """The script's C (O, D, P), mask (O, P), noise (6 NPX, P), n (1, P)
    and m (D, P), float32, drawn from ``default_rng(0)`` in its order, on
    ``dev`` (n and m summed here, in float32)."""
    rng = np.random.default_rng(0)
    c = torch.tensor(rng.standard_normal((O, D, P)), dtype=torch.float32)
    mask = torch.tensor(rng.random((O, P)) < 0.7, dtype=torch.float32)
    noise = torch.tensor(rng.random((6 * NPX, P)) * 0.1, dtype=torch.float32)
    n = mask.sum(0, keepdim=True)
    m = (c * mask[:, None]).sum(0) / n
    return tuple(t.to(dev) for t in (c, mask, noise, n, m))


def _noise_blocks(noise, d: int):
    """BD (d, d, P): each pixel's 3 x 3 noise block on the diagonal, zero
    elsewhere (the script adds each channel once, to zeros)."""
    npx, p = d // 3, noise.shape[1]
    six = noise.view(npx, 6, p)
    blocks = torch.stack([six[:, ch] for row in CHANNEL for ch in row], 1)
    bd = torch.zeros((npx, 3, npx, 3, p), dtype=noise.dtype,
                     device=noise.device)
    bd.diagonal(dim1=0, dim2=2).copy_(
        blocks.view(npx, 3, 3, p).permute(1, 2, 3, 0))
    return bd.view(d, d, p)


def _permute(x, dim: int):
    return torch.cat([x.narrow(dim, a, b - a) for a, b in PERM_SLICES], dim)


def _rotate(x, c, s, dim: int):
    """Rows (dim 0) or columns (dim 1) k and k + HALF of x rotated by the
    angles (c, s) of pair k, as the script writes it."""
    shape = (-1, 1, x.shape[-1]) if dim == 0 else (1, -1, x.shape[-1])
    c, s = c.view(shape), s.view(shape)
    top, bot = x.narrow(dim, 0, HALF), x.narrow(dim, HALF, HALF)
    return torch.cat([c * top - s * bot, s * top + c * bot], dim)


def m2_plain(C, mask):
    """The masked second moments M2 (D, D, P) as the script sums them: over
    o in order, each term (c_o w_o) c_o^T rounded as a product, then a
    sum."""
    o_count, d, p = C.shape
    m2 = torch.zeros((d, d, p), dtype=C.dtype, device=C.device)
    for o in range(o_count):
        c_o = C[o]
        m2 = m2 + (c_o * mask[o])[:, None, :] * c_o[None, :, :]
    return m2


def bisect_plain(C, mask, noise, n, m, stage: str = "m2"):
    """Row 0 (D, P) of the matrix after ``stage``, operation for operation
    the script's schedule (``scripts/bisect_kernel.py:28-138``) at the
    inputs' dtype. Where the script picks a diagonal or a pair's entry as a
    sum of the matrix times a 0/1 mask, this indexes it (the same value).
    Nothing in it copies from the host, so a CUDA graph can capture it."""
    last = stage_index(stage)
    _, d, p = C.shape
    dt, dev = C.dtype, C.device
    m2 = m2_plain(C, mask)
    if last == 0:
        return m2[0]

    nm1 = torch.clamp(n - 1.0, min=1.0)
    cemp = (m2 - n[None] * m[:, None, :] * m[None, :, :]) / nm1[None]
    bd = _noise_blocks(noise, d)
    s_mat = cemp - bd
    if last == 1:
        return s_mat[0]

    a = torch.nn.functional.pad(s_mat, (0, 0, 0, 1, 0, 1))
    vt = torch.eye(DP, dtype=dt, device=dev)[:, :, None].expand(
        DP, DP, p).contiguous()
    for _ in range(DP - 1):
        dall = a.diagonal(dim1=0, dim2=1).T
        apq = a[:HALF, HALF:].diagonal(dim1=0, dim2=1).T
        app, aqq = dall[:HALF], dall[HALF:]
        small = apq.abs() < 1e-30
        denom = torch.where(small, 1.0, 2.0 * apq)
        tau = (aqq - app) / denom
        t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
        t = torch.where(tau == 0.0, 1.0, t)
        t = torch.where(small, 0.0, t)
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = t * c
        a = _rotate(_rotate(a, c, s, 0), c, s, 1)
        vt = _rotate(vt, c, s, 0)
        a, vt = _permute(_permute(a, 0), 1), _permute(vt, 0)
    if last == 2:
        return a[0, :d]

    lam = torch.clamp(a.diagonal(dim1=0, dim2=1).T, min=0.0)
    clamped = torch.zeros((DP, DP, p), dtype=dt, device=dev)
    for k in range(DP):
        row = vt[k]
        clamped = clamped + (row * lam[k][None])[:, None, :] * row[None, :, :]
    clamped = clamped[:d, :d]
    if last == 3:
        return clamped[0]

    work = clamped + bd + 1e-8 * torch.eye(d, dtype=dt, device=dev)[:, :, None]
    rows = torch.arange(d, device=dev)[:, None]
    cols = []
    for j in range(d):
        inv_p = torch.rsqrt(torch.clamp(work[j, j][None], min=1e-30))
        col = work[:, j] * inv_p
        col = col * (rows >= j).to(dt)
        work = work - col[:, None, :] * col[None, :, :]
        cols.append(col)
    return torch.stack(cols, 1)[0]


def bisect(C, mask, noise, n, m, stage: str = "m2"):
    """Row 0 (D, P) of the matrix after ``stage`` (``bisect_plain``'s
    function): on CUDA tensors ``csrc/bisect.cu``'s entry, counted as the
    kernels it launches: M2 summed over the card (eight blocks for 8
    pixels) into a scratch (D * D, P), then, from ``bd`` on, the later
    stages in a second kernel (a block for 8 pixels); on CPU tensors the
    plain version. C (O,
    D, P), mask (O, P), noise (6 NPX, P), n (1, P), m (D, P), float32, for
    any O and P."""
    dev = _build.check_inputs(("C", "mask", "noise", "n", "m"),
                              (C, mask, noise, n, m), (torch.float32,) * 5)
    if C.dim() != 3 or C.shape[1] != D:
        raise ValueError(f"C (O, {D}, P) expected, got {tuple(C.shape)}")
    o_count, _, p = C.shape
    for name, t, shape in (("mask", mask, (o_count, p)),
                           ("noise", noise, (6 * NPX, p)), ("n", n, (1, p)),
                           ("m", m, (D, p))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {shape} expected, got {tuple(t.shape)}")
    if dev.type == "cpu":
        return bisect_plain(C, mask, noise, n, m, stage)
    out = torch.empty((D, p), device=dev)
    if p == 0:
        return out
    last = stage_index(stage)
    m2 = torch.empty((D * D, p), device=dev)
    p_ = _build.ptr
    rc = _build.library().bcd_bisect(
        p_(C), p_(mask), p_(noise), p_(n), p_(m), o_count, p, last, p_(m2),
        p_(out), _build.stream_of(C))
    _build.launched(f"bisect_{STAGES[last]}", rc, kernel_count(last))
    return out


def m2_library(C, mask):
    """The one PyTorch call that computes the ``m2`` stage's function, row 0
    of the masked second moments: ``out[l, p] = sum_o C[o, 0, p] mask[o, p]
    C[o, l, p]``, an einsum (its own order of sums). No call computes the
    later stages (a staged solve). C (O, D, P), mask (O, P)."""
    return torch.einsum("op,op,olp->lp", C[:, 0], mask, C)


def m2_full_library(C, mask):
    """The whole of the masked second moments in one PyTorch call, M2 (D,
    D, P) = ``sum_o C[o, i, p] mask[o, p] C[o, j, p]``, an einsum: what
    forming all 729 entries, as every stage of the kernel does, costs in
    PyTorch (the ``m2`` stage itself is judged against ``m2_library``,
    which computes its function). C (O, D, P), mask (O, P)."""
    return torch.einsum("oip,op,ojp->ijp", C, mask, C)


def rel_err(got, ref) -> float:
    """The largest gap of ``got`` from ``ref`` over ``ref``'s largest
    magnitude, in float64."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max())


@dataclasses.dataclass
class Reading:
    """One stage on the card: ``ok``, whether it held to its plain version
    and to float64 within ``TOLERANCE`` and came out finite (at ``m2`` also
    its library call, held to float64); ``err`` and ``err64``, its relative
    gaps from them; ``max_abs_err``, its largest absolute gap from the
    plain version; the kernel's and the plain version's ms a call, launched
    from Python (``ms``, ``plain_ms``) and replayed from a CUDA graph
    (``graph_ms``, ``plain_graph_ms``); ``library`` (ms launched, ms in a
    graph) of ``m2_library`` at ``m2``, else None; ``full_library`` the same
    of ``m2_full_library`` (the whole M2) at ``m2``; ``bound`` (ms, what
    sets it); ``line``, the report."""

    stage: str
    ok: bool
    err: float
    err64: float
    max_abs_err: float
    ms: float
    graph_ms: float
    plain_ms: float
    plain_graph_ms: float
    library: tuple[float, float] | None
    full_library: tuple[float, float] | None
    bound: tuple[float, str]
    line: str


def measure(dev) -> list[Reading]:
    """Each stage on the script's inputs on ``dev``: the kernel held to its
    plain version there and to the plain version in float64, then timed
    with both timers of ``probe_library`` beside its bound and its plain
    version; at ``m2`` also its library call (``m2_library``) and the whole
    M2's (``m2_full_library``), each held to float64 within the stage's
    tolerance and timed the same way."""
    inputs = bisect_inputs(dev)
    inputs64 = tuple(t.double() for t in inputs)
    limits = bounds.bisect_stages()
    readings = []
    for stage in STAGES:
        run = lambda s=stage: bisect(*inputs, s)  # noqa: E731
        plain_fn = lambda s=stage: bisect_plain(*inputs, s)  # noqa: E731
        got, plain = run(), plain_fn()
        ref64 = bisect_plain(*inputs64, stage)
        err, err64 = rel_err(got, plain), rel_err(got, ref64)
        finite = bool(torch.isfinite(got).all())
        ok = finite and max(err, err64) <= TOLERANCE[stage]
        max_abs = float((got.double() - plain.double()).abs().max())
        ms, graph = probe_library.cuda_ms(run), probe_library.graph_ms(run)
        plain_ms = probe_library.cuda_ms(plain_fn, PLAIN_REPS)
        plain_graph = probe_library.graph_ms(plain_fn, PLAIN_REPS)
        lim, by = limits[stage]
        library, full, lib_text = None, None, (
            "none (no PyTorch call computes a staged solve)")
        if stage == "m2":
            lib = lambda: m2_library(*inputs[:2])  # noqa: E731
            lib_full = lambda: m2_full_library(*inputs[:2])  # noqa: E731
            lib_err = rel_err(lib(), ref64)
            full_err = rel_err(lib_full(), m2_plain(*inputs64[:2]))
            ok = ok and max(lib_err, full_err) <= TOLERANCE[stage]
            library = (probe_library.cuda_ms(lib), probe_library.graph_ms(lib))
            full = (probe_library.cuda_ms(lib_full),
                    probe_library.graph_ms(lib_full))
            lib_text = (f"the einsum {library[1]:.4f} ms in a graph, "
                        f"{library[0]:.4f} ms launched, {lib_err:.3e} from "
                        f"float64; the kernel {graph / library[1]:.2f}x it; "
                        f"the whole M2's einsum {full[1]:.4f} ms in a graph, "
                        f"{full[0]:.4f} ms launched, {full_err:.3e} from "
                        f"float64")
        line = (f"bisect_{stage}: vs its plain version {err:.3e} (max abs "
                f"{max_abs:.3e}), vs float64 {err64:.3e} of the largest "
                f"magnitude (limit {TOLERANCE[stage]:g}"
                f"{'' if finite else '; NOT FINITE'}): "
                f"{'held' if ok else 'NOT HELD'}; {graph:.4f} ms in a CUDA "
                f"graph, {ms:.4f} ms launched from Python; bound {lim:.6f} ms "
                f"({by}), {graph / lim:.1f}x; plain {plain_graph:.4f} ms in a "
                f"graph, {plain_ms:.4f} ms launched; library call {lib_text}")
        readings.append(Reading(stage, ok, err, err64, max_abs, ms, graph,
                                plain_ms, plain_graph, library, full,
                                (lim, by), line))
    return readings


# ``split``'s builds of the kernel, by the value of BCD_BISECT_CUT: as it
# is, its M2 staging alone (no products), its M2 products alone (no staging)
CUTS = {"kernel": 0, "no products": 1, "no staging": 2}
SPLIT_DIR = _build.BUILD_DIR.parent / "bisect_split"


def _build_cut(cut: int):
    """``csrc/bisect.cu`` built with BCD_BISECT_CUT = ``cut``, loaded."""
    lib = SPLIT_DIR / f"bisect_cut{cut}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DBCD_BISECT_CUT={cut}",
           "-shared", "-o", str(lib), str(_build.CSRC / "bisect.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}: rc {proc.returncode}\n"
                           f"{proc.stdout}{proc.stderr}")
    loaded = ctypes.CDLL(str(lib))
    loaded.bcd_bisect.argtypes = _build._SIGNATURES["bcd_bisect"]
    return loaded


def split() -> list[str]:
    """Where the ``m2`` stage's time goes, on one card: ``csrc/bisect.cu``
    built as it is and with its M2 products or its M2 staging left out
    (``CUTS``; the cut builds compute wrong numbers on purpose), each into
    a library of its own under ``build/bisect_split/`` (all at once), and
    stages ``m2`` and ``chol`` of each timed on the script's inputs with
    both of ``probe_library``'s timers, in the order of ``CUTS`` and then
    back. Returns the report's lines."""
    SPLIT_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(CUTS)) as pool:
        built = dict(zip(CUTS, pool.map(_build_cut, CUTS.values())))
    dev = torch.device("cuda")
    inputs = bisect_inputs(dev)
    o_count, _, p = inputs[0].shape
    out = torch.empty((D, p), device=dev)
    m2 = torch.empty((D * D, p), device=dev)
    ptrs = [_build.ptr(t) for t in inputs]
    lines = []
    for name in [*CUTS, *reversed(CUTS)]:
        for stage in ("m2", "chol"):

            def run(lib=built[name], last=STAGES.index(stage)):
                _build.check(lib.bcd_bisect(*ptrs, o_count, p, last,
                                            _build.ptr(m2), _build.ptr(out),
                                            _build.stream_of(out)),
                             "bisect_kernel")

            lines.append(f"{name}, {stage}: {probe_library.graph_ms(run):.4f}"
                         f" ms in a graph, {probe_library.cuda_ms(run):.4f} "
                         f"ms launched")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bcd_tpu_torch.ops.bisect",
        description="Run scripts/bisect_kernel.py's staged d = 27 solve on "
                    "its inputs and print its line: the stage, the checksum "
                    "of the output row, the seconds of the call.")
    ap.add_argument("stage", nargs="?", default="m2",
                    help=f"one of {', '.join(STAGES)} (default m2); any "
                         "other name runs every stage")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain version)")
    ap.add_argument("--split", action="store_true",
                    help="on the card: time stages m2 and chol of the "
                         "kernel as it is, without its M2 products and "
                         "without its M2 staging (``split``)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except ValueError as e:
        print(f"ERROR: {e}")
        return 1
    if args.split:
        if dev.type != "cuda":
            print("ERROR: --split times the kernel: it needs the card")
            return 1
        for line in split():
            print(line, flush=True)
        return 0
    inputs = bisect_inputs(dev)
    if dev.type == "cuda":
        _build.library()
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = bisect(*inputs, args.stage)
    total = float(out.sum())
    secs = time.perf_counter() - t0
    print(f"STAGE={args.stage} OK, checksum={total:.4f}, {secs:.1f}s")
    return 0 if math.isfinite(total) else 1


if __name__ == "__main__":
    raise SystemExit(main())
