"""Build and load the port's CUDA kernels (``bcd_tpu_torch/csrc/*.cu``).

Every ``.cu`` file is compiled by its own ``nvcc``, all started together
(``csrc/solve_filter_smem.cu`` by one for each patch dimension it is built
for and one for its C entries, ``SPLIT``; ``csrc/solve_filter_big.cu``,
whose d is a runtime argument, is one unit), and the objects are linked into
ONE shared library with a plain C interface
(no PyTorch headers, so the build takes seconds) under ``build/kernels/``
in the checkout, on first use, and loaded with ``ctypes``. The library's file name carries a hash of the sources and flags,
so an edited kernel is rebuilt. Each C entry launches on the stream it is
given, allocates nothing and returns ``cudaGetLastError()``; ``check``
raises when that is not 0.

Nothing here runs at import time: this module is imported on hosts with no
``nvcc`` and no card (the CPU tests), where the wrappers never reach it.

``LAUNCHES`` counts kernel launches per wrapper. A wrapper adds
one where it calls its C entry, and nowhere else, so a run can show that
the main path went through the hand-written kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

# Hopper (sm_90a) only; IEEE division and square root are kept on purpose:
# --use_fast_math's approximate division and rsqrt are the class of error
# that cost the TPU solve kernel 5.5e-4 rms (ops/solve_filter_pallas.py:65-77)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# solve_filter_smem, solve_filter_243, solve_filter_363, solve_filter_507,
# solve_filter_675, solve_filter_867, solve_filter_1083, solve_filter_1323,
# solve_filter_1587 and solve_filter_1875 are csrc/solve_filter_smem.cu at
# d = 147, 243, 363, 507, 675, 867, 1083, 1323, 1587 and 1875;
# solve_filter_big is csrc/solve_filter_big.cu, d a runtime argument (the
# engine's from d = 2187), and solve_matrices_big the same kernel as the lane
# solve_matrices (every d but 27 and 75); probe_* are csrc/probes.cu's
# microbenchmarks of the TPU-compiler probes, one counter a variant
LAUNCHES = {"masks_moments": 0, "solve_matrices_pm": 0, "apply_scatter": 0,
            "solve_filter": 0, "solve_matrices": 0, "solve_filter_smem": 0,
            "solve_filter_243": 0, "solve_filter_363": 0,
            "solve_filter_507": 0, "solve_filter_675": 0,
            "solve_filter_867": 0, "solve_filter_1083": 0,
            "solve_filter_1323": 0, "solve_filter_1587": 0,
            "solve_filter_1875": 0, "solve_filter_big": 0,
            "solve_matrices_big": 0, "probe_transpose_a": 0,
            "probe_transpose_b": 0, "probe_transpose_c": 0,
            "probe_transpose_d": 0, "probe_mosaic_aligned": 0,
            "probe_mosaic_unaligned": 0, "probe_banded_batched": 0,
            "probe_banded_loop": 0}

# sources compiled as several translation units at once: one for each
# instance (-DBCD_SMEM_D=d) and one for the C entries
# (-DBCD_SMEM_ENTRIES). As one unit solve_filter_smem.cu's instances
# compiled one after another, the build's longest step (PERF.md)
SPLIT = {"solve_filter_smem.cu": ("BCD_SMEM_D", "BCD_SMEM_ENTRIES",
                                  (147, 243, 363, 507, 675, 867, 1083, 1323,
                                   1587, 1875))}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # histo, nb, color, pixcov, valid, thr, n_tiles, t, h, b, nbins,
    # mask bits, masks, m2, misc, stream
    "bcd_masks_moments": [_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I,
                          _P, _P, _P, _P, _P],
    # m2, misc, eps, n_pixels, sweeps, a2t, small, stream
    "bcd_solve_matrices_pm": [_P, _P, _F, _I, _I, _P, _P, _P],
    # masks, a2t, small, color, n_tiles, t, h, b, f_scratch, out, stream
    "bcd_apply_scatter": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # cand, mask, noise, n, m, rows, eps, n_rows, n_offsets, d, sweeps,
    # field, stream
    "bcd_solve_filter": [_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _P, _P],
    # m2, msum, nov, n, eps, n_pixels, d, sweeps, a2t, b2, stream
    "bcd_solve_matrices": [_P, _P, _P, _P, _F, _I, _I, _I, _P, _P, _P],
    # cand, mask, noise, n, m, rows, eps, n_rows, n_offsets, d, sweeps,
    # scratch, n_blocks, field, stream
    "bcd_solve_filter_smem": [_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _P,
                              _I, _P, _P],
    # d, n_blocks -> floats of scratch (a 64-bit count)
    "bcd_solve_filter_smem_scratch_floats": [_I, _I],
    # the same arguments as bcd_solve_filter_smem, d any patch dimension
    "bcd_solve_filter_big": [_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _P,
                             _I, _P, _P],
    "bcd_solve_filter_big_scratch_floats": [_I, _I],
    # m2, msum, nov, n, eps, n_pixels, d, sweeps, scratch, n_blocks, a2t, b2,
    # stream (the lane solve_matrices on the runtime-d kernel)
    "bcd_solve_matrices_big": [_P, _P, _P, _P, _F, _I, _I, _I, _P, _I, _P, _P,
                               _P],
    # csrc/probes.cu: m2, expand (or index), P, K, M, lanes, back, stream
    "bcd_probe_transpose_mma": [_P, _P, _I, _I, _I, _P, _P, _P],
    "bcd_probe_transpose_gather": [_P, _P, _I, _I, _I, _P, _P, _P],
    # m2, floats in, floats out, lanes, back, stream
    "bcd_probe_transpose_copy": [_P, _L, _L, _P, _P, _P],
    # g, rows of g, columns, rows out, window rows, weights (host arrays),
    # windows, out, stream
    "bcd_probe_mosaic": [_P, _I, _I, _I, _P, _P, _I, _P, _P],
    # b, s, Y, T, C, out, stream (the loop: band before out)
    "bcd_probe_banded_mma": [_P, _P, _I, _I, _I, _P, _P],
    "bcd_probe_banded_loop": [_P, _P, _I, _I, _I, _I, _P, _P],
    # d, out (6 int64: shared bytes, shared rows, global rows, shared
    # vectors, global vector floats, slot floats a block) -> 0 or -1
    "bcd_solve_filter_big_layout": [_I, _P],
}
_RESTYPES = {"bcd_solve_filter_smem_scratch_floats": ctypes.c_longlong,
             "bcd_solve_filter_big_scratch_floats": ctypes.c_longlong}

_lib = None
_log = ""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _units(sources):
    """(source, extra nvcc flags, object suffix) of every translation unit."""
    units = []
    for src in sources:
        if src.name not in SPLIT:
            units.append((src, [], src.stem))
            continue
        one, entries, dims = SPLIT[src.name]
        units.append((src, [f"-D{entries}"], f"{src.stem}.entries"))
        units += [(src, [f"-D{one}={d}"], f"{src.stem}.{d}") for d in dims]
    return units


def _timed_run(cmd):
    """(return code, output, seconds) of one compile."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def _library_path():
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(repr(sorted(SPLIT.items())).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return sources, BUILD_DIR / f"libbcd_kernels_{digest.hexdigest()[:16]}.so"


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib, _log
    if _lib is not None:
        return _lib
    sources, path = _library_path()
    log_path = path.with_suffix(".log")
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp")
        units = _units(sources)
        objs = [f"{tmp}.{stem}.o" for _, _, stem in units]
        cmds = [[_nvcc(), *NVCC_FLAGS, *extra, "-c", "-o", obj, str(src)]
                for (src, extra, _), obj in zip(units, objs)]
        with ThreadPoolExecutor(len(cmds)) as pool:
            procs = list(pool.map(_timed_run, cmds))
        # nvcc's report, and each unit's compile time
        log = "".join(out for _, out, _ in procs) + "".join(
            f"nvcc {stem}: {secs:.1f} s\n"
            for (_, _, stem), (_, _, secs) in zip(units, procs))
        for cmd, (rc, out, _) in zip(cmds, procs):
            if rc != 0:
                raise RuntimeError(
                    f"nvcc failed (rc {rc}):\n{' '.join(cmd)}\n{out}")
        link = [_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", f"{tmp}.so", *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (rc {proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        log_path.write_text(log)
        os.replace(f"{tmp}.so", path)
        for obj in objs:
            os.remove(obj)
    _log = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    _lib = lib
    return lib


def build_log() -> str:
    """nvcc's output for the loaded library (``-Xptxas -v``: registers,
    shared memory and spills of every kernel)."""
    library()
    return _log


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
