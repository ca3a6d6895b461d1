"""Build and load the port's CUDA kernels (``bcd_tpu_torch/csrc/*.cu``).

Every ``.cu`` file is compiled by its own ``nvcc``, all started together,
and the objects are linked into ONE shared library with a plain C interface
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
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

# Hopper (sm_90a) only; IEEE division and square root are kept on purpose:
# --use_fast_math's approximate division and rsqrt are the class of error
# that cost the TPU solve kernel 5.5e-4 rms (ops/solve_filter_pallas.py:65-77)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"masks_moments": 0, "solve_matrices_pm": 0, "apply_scatter": 0,
            "solve_filter": 0, "solve_matrices": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
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
}

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


def _library_path():
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
        objs = [f"{tmp}.{src.stem}.o" for src in sources]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        outs = [proc.communicate()[0] for proc in procs]
        log = "".join(outs)
        for cmd, proc, out in zip(cmds, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (rc {proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{out}")
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
        fn.restype = ctypes.c_int
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
