"""The three TPU-compiler probes of ``scripts/`` as Hopper microbenchmarks:
ctypes wrappers of ``csrc/probes.cu``'s kernels, the plain PyTorch version
of each function, and an entry point that runs every variant on the card
at its script's shapes, on its script's inputs (``ops/probe_library``'s
``transpose_inputs``, ``mosaic_inputs``, ``banded_inputs``):

    python -m bcd_tpu_torch.ops.probes

For each variant it prints whether it is exact against the float64
reference, or its largest absolute error there; the same against its plain
version; its time (CUDA events, the mean of ``probe_library.REPS`` calls
after a warm-up); its bound (``ops/bounds.probe_variants``) and multiple of
it; and the time of the one PyTorch call that computes its function
(``probe_library.cases``), where there is one. Then which mosaic windows
start on 16 bytes, and last the card's name and power limit.

- transpose (``scripts/probe_transpose.py``): K1's packed moments m2 (P,
  378) expanded to lane-major 27 x 27 matrices, lanes (729, P), and back to
  pixel rows, back (P, 729). A: tensor-core products, the expansion then the
  identity (``transpose_mma``); B: a gather and a shared-memory transpose
  (``transpose_gather``); C: the same reads and writes with no work, the
  I/O baseline (``transpose_copy``); D: A's forward product only. Plain:
  the gather and ``.T.contiguous()``.
- mosaic (``scripts/probe_mosaic.py``): a sum of row windows of a (2896,
  729) slab at runtime offsets, aligned (39 weighted windows from bases
  that are multiples of 8 rows) or unaligned (13 windows) (``mosaic``).
  Plain: the window sums in the script's order.
- banded dot (``scripts/probe_banded_dot.py``): (60, 64, 64) 0/1 band
  matrices times (60, 64, 768) slabs, batched on the tensor cores or as a
  loop of FMAs over the band (``banded_dot``). Plain: ``torch.bmm`` in
  float32 with TF32 off.

A wrapper given CPU tensors returns its plain version; given CUDA tensors
it launches its kernel, adds one to its counter in ``_build.LAUNCHES`` (the
variant's name) and raises if the launch fails. Nothing here builds or
launches at import. Only these microbenchmarks, the tests and
``chip_smoke.py`` use this module.
"""

from __future__ import annotations

import ctypes
import dataclasses
import subprocess
from typing import Callable

import torch

from bcd_tpu_torch.ops import _build, bounds, probe_library
from bcd_tpu_torch.ops.probe_library import (C, DX, FP32_REL, NPIX, R0,
                                            SHIFTS, WEIGHTS)

# the script's shifts: row shifts of 48 (aligned), raw offsets (unaligned)
ALIGNED_SHIFTS = tuple(range(-(SHIFTS // 2), SHIFTS // 2 + 1))
UNALIGNED_SHIFTS = tuple(48 * s + 3 for s in ALIGNED_SHIFTS)
# half-width of the banded dot's band
BAND = probe_library.BAND


def _check(names, tensors, dtypes) -> torch.device:
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, t, dtype in zip(names, tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype or (dev.type == "cuda" and not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype}")
    return dev


def _launched(name: str, rc: int) -> None:
    _build.LAUNCHES[name] += 1
    _build.check(rc, name)


# ---------------------------------------------------------------------------
# transpose
# ---------------------------------------------------------------------------


def transpose_plain(m2, index):
    """(lanes (M, P) = m2[:, index]^T, back (P, M) = lanes^T) of pixel-major
    m2 (P, K) and the expansion's gather index (M,)."""
    lanes = m2[:, index.long()].T.contiguous()
    return lanes, lanes.T.contiguous()


def copy_plain(m2, m: int):
    """Transpose C's outputs: m2's floats in order, repeated to fill (m, P)
    and (P, m)."""
    p_total = m2.shape[0]
    flat = m2.reshape(-1)
    rep = flat.repeat(-(-m * p_total // flat.numel()))[:m * p_total]
    return rep.view(m, p_total), rep.clone().view(p_total, m)


def transpose_mma(m2, expand, back: bool = True):
    """Transpose variant A (``back``) or D: lanes (M, P) = expand m2^T on
    the tensor cores (mma.sync TF32, each fp32 input split into three TF32
    parts), and for A back (P, M) = lanes^T as a product with the identity.
    m2 (P, K) pixel-major, P a multiple of 32 on the card; expand (M, K) a
    0/1 expansion matrix with one 1 a row (``ops/fused.tri_geometry``'s).
    Returns (lanes, back) or (lanes,)."""
    dev = _check(("m2", "expand"), (m2, expand), (torch.float32,) * 2)
    if m2.dim() != 2 or expand.dim() != 2 or expand.shape[1] != m2.shape[1]:
        raise ValueError(f"m2 (P, K) and expand (M, K) expected, got "
                         f"{tuple(m2.shape)} and {tuple(expand.shape)}")
    p_total, k = m2.shape
    m = expand.shape[0]
    if dev.type == "cpu":
        out = transpose_plain(m2, expand.argmax(1))
        return out if back else out[:1]
    if p_total % 32:
        raise ValueError(f"P = {p_total} is not a multiple of 32")
    lanes = torch.empty((m, p_total), device=dev)
    bk = torch.empty((p_total, m), device=dev) if back else None
    rc = _build.library().bcd_probe_transpose_mma(
        _build.ptr(m2), _build.ptr(expand), p_total, k, m, _build.ptr(lanes),
        None if bk is None else _build.ptr(bk), _build.stream_of(m2))
    _launched("probe_transpose_a" if back else "probe_transpose_d", rc)
    return (lanes, bk) if back else (lanes,)


def transpose_gather(m2, index):
    """Transpose variant B: back (P, M) = m2[:, index] gathered, lanes (M,
    P) its transpose through a shared-memory tile. index (M,) int32."""
    dev = _check(("m2", "index"), (m2, index), (torch.float32, torch.int32))
    if m2.dim() != 2 or index.dim() != 1:
        raise ValueError("m2 (P, K) and index (M,) expected")
    if dev.type == "cpu":
        return transpose_plain(m2, index)
    p_total, k = m2.shape
    m = index.shape[0]
    lanes = torch.empty((m, p_total), device=dev)
    bk = torch.empty((p_total, m), device=dev)
    rc = _build.library().bcd_probe_transpose_gather(
        _build.ptr(m2), _build.ptr(index), p_total, k, m, _build.ptr(lanes),
        _build.ptr(bk), _build.stream_of(m2))
    _launched("probe_transpose_b", rc)
    return lanes, bk


def transpose_copy(m2, m: int):
    """Transpose variant C, the I/O baseline: m2 read, lanes (m, P) and
    back (P, m) written with m2's floats in order, repeated (``copy_plain``),
    no work. On the card m2's and the outputs' floats are multiples of 4."""
    dev = _check(("m2",), (m2,), (torch.float32,))
    if dev.type == "cpu":
        return copy_plain(m2, m)
    p_total = m2.shape[0]
    n_in, n_out = m2.numel(), m * p_total
    if n_in % 4 or n_out % 4:
        raise ValueError("m2's and the outputs' floats must be multiples of 4")
    lanes = torch.empty((m, p_total), device=dev)
    bk = torch.empty((p_total, m), device=dev)
    rc = _build.library().bcd_probe_transpose_copy(
        _build.ptr(m2), n_in, n_out, _build.ptr(lanes), _build.ptr(bk),
        _build.stream_of(m2))
    _launched("probe_transpose_c", rc)
    return lanes, bk


# ---------------------------------------------------------------------------
# mosaic
# ---------------------------------------------------------------------------


def mosaic_windows(shifts, aligned: bool, r0: int = R0):
    """(first rows, weights) of the windows the script's kernel sums, in its
    order: aligned, for each row shift dy the base 8 q, q = (r0 - 8) // 8 +
    6 dy, and the rows 8 q + 8 + dx for dx in DX, weighted 1 + 0.1 dx;
    unaligned, the rows r0 + s for each raw offset s, weighted 1."""
    if not aligned:
        return [r0 + int(s) for s in shifts], [1.0] * len(shifts)
    rows, weights = [], []
    for dy in shifts:
        q = (r0 - 8) // 8 + int(dy) * (48 // 8)
        rows += [8 * q + 8 + dx for dx in DX]
        weights += list(WEIGHTS)
    return rows, weights


def mosaic_plain(g, shifts, aligned: bool, npix: int = NPIX):
    """out (npix, cols) = the windows' weighted sum, each term rounded as a
    product and then a sum, window by window in the script's order."""
    rows, weights = mosaic_windows(shifts, aligned)
    w = torch.tensor(weights, dtype=torch.float32, device=g.device)
    acc = torch.zeros((npix, g.shape[1]), dtype=torch.float32, device=g.device)
    for k, row in enumerate(rows):
        acc = acc + g[row:row + npix] * w[k]
    return acc


def mosaic(g, shifts, aligned: bool, npix: int = NPIX):
    """The mosaic probe's sum on the card (``mosaic_plain``'s function): a
    thread sums four consecutive output floats over the windows in
    registers, with 16-byte loads from the windows whose rows start on 16
    bytes and 4-byte loads from the others. g (rows, cols), the shifts as
    the script passes them (``ALIGNED_SHIFTS`` or ``UNALIGNED_SHIFTS``)."""
    dev = _check(("g",), (g,), (torch.float32,))
    rows, weights = mosaic_windows(shifts, aligned)
    n_rows, cols = g.shape
    if min(rows) < 0 or max(rows) + npix > n_rows:
        raise ValueError(f"a window leaves the slab's {n_rows} rows")
    if dev.type == "cpu":
        return mosaic_plain(g, shifts, aligned, npix)
    if npix * cols % 4:
        raise ValueError("the output's floats must be a multiple of 4")
    out = torch.empty((npix, cols), device=dev)
    n = len(rows)
    rows_c, w_c = (ctypes.c_int * n)(*rows), (ctypes.c_float * n)(*weights)
    rc = _build.library().bcd_probe_mosaic(
        _build.ptr(g), n_rows, cols, npix, ctypes.cast(rows_c, ctypes.c_void_p),
        ctypes.cast(w_c, ctypes.c_void_p), n, _build.ptr(out),
        _build.stream_of(g))
    _launched("probe_mosaic_aligned" if aligned else "probe_mosaic_unaligned",
              rc)
    return out


# ---------------------------------------------------------------------------
# banded dot
# ---------------------------------------------------------------------------


def banded_plain(b, s):
    """``torch.bmm(b, s)`` in float32, TF32 off."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.bmm(b, s)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def banded_dot(b, s, batched: bool, band: int = BAND):
    """O[y] = B[y] S[y] for 0/1 band matrices b (Y, T, T), zero outside
    |i - k| <= ``band``, and s (Y, T, C): ``batched`` on the tensor cores
    over the whole T x T matrix (mma.sync TF32, s split into three TF32
    parts; T a multiple of 16 and C of 32 on the card), else a loop of FMAs
    over the band."""
    dev = _check(("b", "s"), (b, s), (torch.float32,) * 2)
    if b.dim() != 3 or s.dim() != 3 or b.shape[0] != s.shape[0] \
            or b.shape[1] != b.shape[2] or s.shape[1] != b.shape[1]:
        raise ValueError(f"b (Y, T, T) and s (Y, T, C) expected, got "
                         f"{tuple(b.shape)} and {tuple(s.shape)}")
    if dev.type == "cpu":
        return banded_plain(b, s)
    n_y, t, c = s.shape
    if batched and (t % 16 or c % 32):
        raise ValueError(f"T = {t} must be a multiple of 16, C = {c} of 32")
    out = torch.empty((n_y, t, c), device=dev)
    lib, p = _build.library(), _build.ptr
    if batched:
        rc = lib.bcd_probe_banded_mma(p(b), p(s), n_y, t, c, p(out),
                                      _build.stream_of(b))
    else:
        rc = lib.bcd_probe_banded_loop(p(b), p(s), n_y, t, c, band, p(out),
                                       _build.stream_of(b))
    _launched("probe_banded_batched" if batched else "probe_banded_loop", rc)
    return out


# ---------------------------------------------------------------------------
# every variant at its script's shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Variant:
    """One microbenchmark variant on its script's inputs. ``name`` is also
    its launch counter; ``run`` calls its wrapper, ``plain`` its plain
    version, ``ref64`` computes its float64 reference on the host (each a
    tuple of outputs); ``exact``: held to its plain version bit for bit;
    ``library``: the ``probe_library.cases`` call that computes its
    function, or None."""

    name: str
    run: Callable[[], tuple]
    plain: Callable[[], tuple]
    ref64: Callable[[], tuple]
    exact: bool
    library: str | None


def variants(dev) -> list[Variant]:
    """Every variant, in order, on its script's inputs on ``dev``."""
    m2, expand, index = probe_library.transpose_inputs(dev)
    g = probe_library.mosaic_inputs(dev)
    b, s = probe_library.banded_inputs(dev)
    m = expand.shape[0]

    def lanes64():
        lanes = m2.double().cpu()[:, index.long().cpu()].T
        return lanes, lanes.T

    def mosaic64(shifts, aligned):
        rows, weights = mosaic_windows(shifts, aligned)
        g64 = g.double().cpu()
        return (sum(g64[r:r + NPIX] * w for r, w in zip(rows, weights)),)

    out = [
        Variant("probe_transpose_a", lambda: transpose_mma(m2, expand),
                lambda: transpose_plain(m2, index), lanes64, False,
                "probe_transpose"),
        Variant("probe_transpose_b", lambda: transpose_gather(m2, index),
                lambda: transpose_plain(m2, index), lanes64, True,
                "probe_transpose"),
        Variant("probe_transpose_c", lambda: transpose_copy(m2, m),
                lambda: copy_plain(m2, m),
                lambda: copy_plain(m2.double().cpu(), m), True, None),
        Variant("probe_transpose_d",
                lambda: transpose_mma(m2, expand, back=False),
                lambda: transpose_plain(m2, index)[:1],
                lambda: lanes64()[:1], True, "probe_transpose_fwd"),
    ]
    for aligned, shifts in ((True, ALIGNED_SHIFTS), (False, UNALIGNED_SHIFTS)):
        out.append(Variant(
            f"probe_mosaic_{'aligned' if aligned else 'unaligned'}",
            lambda a=aligned, sh=shifts: (mosaic(g, sh, a),),
            lambda a=aligned, sh=shifts: (mosaic_plain(g, sh, a),),
            lambda a=aligned, sh=shifts: mosaic64(sh, a), False,
            "probe_mosaic_aligned" if aligned else "probe_mosaic"))
    for batched in (True, False):
        out.append(Variant(
            f"probe_banded_{'batched' if batched else 'loop'}",
            lambda bt=batched: (banded_dot(b, s, bt),),
            lambda: (banded_plain(b, s),),
            lambda: (torch.bmm(b.double().cpu(), s.double().cpu()),), False,
            "probe_banded_dot"))
    return out


def max_err(got, want) -> float:
    """The largest absolute gap over a variant's outputs (on the host, in
    float64)."""
    return max(float((g.double().cpu() - w.double().cpu()).abs().max())
               for g, w in zip(got, want))


def held(v: Variant, got, plain) -> tuple[bool, float, float]:
    """(whether ``got`` holds to the plain version's ``plain`` as ``v``
    must: bit for bit, or within FP32_REL of its largest magnitude; the
    largest gap; the limit)."""
    if v.exact:
        return all(torch.equal(g, p) for g, p in zip(got, plain)), \
            max_err(got, plain), 0.0
    limit = FP32_REL * max(float(p.abs().max()) for p in plain)
    err = max_err(got, plain)
    return err <= limit, err, limit


def exactness(got, ref) -> str:
    """``exact_fwd``/``exact_back`` (the script's words) for a transpose's
    outputs, else ``exact`` or the largest gap, against float64."""
    if len(got) == 2:
        return " ".join(f"exact_{k}={bool(torch.equal(g.double().cpu(), r))}"
                        for k, g, r in zip(("fwd", "back"), got, ref))
    err = max_err(got, ref)
    return "exact" if err == 0 else f"max abs err {err:.3e}"


def window_alignment(aligned: bool) -> tuple[int, int, list[int]]:
    """(windows whose flat offset row C is a multiple of 4 floats, so read
    in 16-byte loads; all windows; the distinct row starts mod 4)."""
    rows, _ = mosaic_windows(ALIGNED_SHIFTS if aligned else UNALIGNED_SHIFTS,
                             aligned)
    return (sum(r * C % 4 == 0 for r in rows), len(rows),
            sorted({r % 4 for r in rows}))


@dataclasses.dataclass
class Reading:
    """One variant measured on the card: ``ok``, whether it held to its
    plain version as it must (``held``); ``err``, the largest gap from it;
    ``ms`` and ``plain_ms``, a call of each; ``bound`` (ms, what sets it);
    ``library_ms``, its library call's, or None; ``line``, the report."""

    name: str
    ok: bool
    err: float
    ms: float
    plain_ms: float
    bound: tuple[float, str]
    library_ms: float | None
    line: str


def measure(dev) -> tuple[list[Reading], list[str]]:
    """Every variant on ``dev`` run, held to its plain version and to
    float64, and timed with ``probe_library.cuda_ms`` beside its plain
    version, its bound and its library call (``probe_library.measure``,
    which raises if a call leaves float64 by more than fp32 rounding).
    Returns the readings, and a line for each library call and each
    mosaic's window alignment."""
    library = probe_library.measure(dev)
    bound = bounds.probe_variants()
    readings = []
    for v in variants(dev):
        got = v.run()
        ok, err, limit = held(v, got, v.plain())
        ms = probe_library.cuda_ms(v.run)
        plain_ms = probe_library.cuda_ms(v.plain)
        lib = library[v.library][0] if v.library else None
        lim, by = bound[v.name]
        line = (f"{v.name}: {exactness(got, v.ref64())} vs float64; vs its "
                f"plain version "
                + ("bit for bit" if v.exact
                   else f"max abs {err:.3e} (limit {limit:.3e})")
                + f": {'held' if ok else 'NOT HELD'}; {ms:.4f} ms, bound "
                f"{lim:.4f} ms ({by}), {ms / lim:.1f}x; plain "
                f"{plain_ms:.4f} ms; library call "
                + (f"{lib:.4f} ms" if lib is not None
                   else "none (no one PyTorch call computes it)"))
        readings.append(Reading(v.name, ok, err, ms, plain_ms, (lim, by), lib,
                                line))
    lines = [f"library call {name}: {ms:.4f} ms, max abs err {err:.3e} vs "
             f"float64 (limit {limit:.3e})"
             for name, (ms, err, limit) in library.items()]
    for aligned in (True, False):
        n16, n, mods = window_alignment(aligned)
        lines.append(
            f"probe_mosaic_{'aligned' if aligned else 'unaligned'}: {n16} of "
            f"{n} windows start on 16 bytes (a {C}-float row is {4 * C} "
            f"bytes: only rows = 0 mod 4 do; these start at rows {mods} mod "
            f"4)")
    return readings, lines


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    readings, lines = measure(torch.device("cuda"))
    for line in [r.line for r in readings] + lines:
        print(line, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0 if all(r.ok for r in readings) else 1


if __name__ == "__main__":
    raise SystemExit(main())
