"""Where transpose A's and D's time goes (``csrc/probes.cu``'s
``transpose_wgmma_kernel``), on one CUDA card:

    python -m bcd_tpu_torch.ops.transpose_ab

Compiles ``csrc/probes.cu`` as it is and in cut-down copies, each alone
into a library of its own under ``build/transpose_ab/`` (all at once), and
times A and D of each on the probe's inputs (P = 2304, ``probe_library``)
with both of ``probe_library``'s timers, in the order of ``VARIANTS`` and
then back. The copies compute wrong numbers on purpose; each line says
whether the outputs are the plain version's bit for bit. ``one product``
and ``two products`` leave out E lo (and E mid): the time of a product;
``no refill`` issues no copy past the ring's first stages (the later
stages read what is there): the products and the stores without the
copies' wait; ``no products``: the copies and the stores alone. Then the
kernel's registers and spills from each copy's ``-Xptxas -v``, and the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from bcd_tpu_torch.ops import _build, probe_library, probes

WORK = _build.BUILD_DIR.parent / "transpose_ab"
SOURCE = _build.CSRC / "probes.cu"
_LO = "tx_wgmma(acc, a[kk][2], desc);"
_MID = "tx_wgmma(acc, a[kk][1], desc);"
_HI = "tx_wgmma(acc, a[kk][0], desc);"
_REFILL = "if (s + TX_STAGES - 1 < n_k) fill(s + TX_STAGES - 1);"
# name: the lines each copy leaves out
VARIANTS = {"kernel": (), "one product": (_LO, _MID),
            "two products": (_LO,), "no refill": (_REFILL,),
            "no products": (_LO, _MID, _HI)}


def build(name: str) -> tuple[ctypes.CDLL, str]:
    """(the library of ``name``'s copy of csrc/probes.cu, nvcc's report)."""
    text = SOURCE.read_text()
    for line in VARIANTS[name]:
        if text.count(line) != 1:
            raise RuntimeError(f"{SOURCE}: {line!r} is not there once")
        text = text.replace(line, "")
    stem = name.replace(" ", "_")
    src, lib = WORK / f"{stem}.cu", WORK / f"{stem}.so"
    src.write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}: rc {proc.returncode}\n"
                           f"{proc.stdout}{proc.stderr}")
    loaded = ctypes.CDLL(str(lib))
    loaded.bcd_probe_transpose_mma.argtypes = _build._SIGNATURES[
        "bcd_probe_transpose_mma"]
    return loaded, proc.stdout + proc.stderr


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    WORK.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    dev = torch.device("cuda")
    m2, expand, index = probe_library.transpose_inputs(dev)
    (p_total, k), m = m2.shape, expand.shape[0]
    want = probes.transpose_plain(m2, index)
    lanes = torch.empty((m, p_total), device=dev)
    back = torch.empty((p_total, m), device=dev)
    ptr = _build.ptr

    def call(lib, with_back: bool):
        _build.check(lib.bcd_probe_transpose_mma(
            ptr(m2), ptr(expand), p_total, k, m, ptr(lanes),
            ptr(back) if with_back else None, _build.stream_of(m2)),
            "transpose_wgmma_kernel")

    readings = {}
    for name in [*VARIANTS, *reversed(VARIANTS)]:
        lib = built[name][0]
        for with_back in (True, False):
            lanes.zero_()
            back.zero_()
            call(lib, with_back)
            torch.cuda.synchronize()
            same = torch.equal(lanes, want[0]) and (
                not with_back or torch.equal(back, want[1]))
            run = lambda: call(lib, with_back)  # noqa: E731
            readings.setdefault((name, with_back), []).append(
                (probe_library.graph_ms(run), probe_library.cuda_ms(run),
                 same))
    for (name, with_back), runs in readings.items():
        print(f"{name}, {'A' if with_back else 'D'}: " + "; ".join(
            f"{graph:.4f} ms in a graph ({launched:.4f} launched), "
            f"{'bit for bit' if same else 'not'} the plain version"
            for graph, launched, same in runs), flush=True)
    for name, (_, log) in built.items():
        for entry, (regs, stack, stores, loads) in _build.ptxas_report(
                log, "transpose_wgmma_kernel").items():
            print(f"{name}: {entry}: {regs} registers, stack {stack}, spill "
                  f"stores {stores}, loads {loads}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
