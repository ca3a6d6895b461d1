"""The round's pivot-product loop of ``csrc/solve_filter_smem.cu`` at
d = 1323 (eleven passes) in three forms, on one CUDA card:

    python -m bcd_tpu_torch.ops.pivot_loop_ab

``passes``, the kernel's: a lane keeps two row pointers a pass, every pass
loaded together (at eleven passes ptxas spills inside the loop); ``index``:
a row index a pass, the address formed at each load through ``Rows``;
``groups``: the passes in groups of eight, each group's pointers live only
in its own loop. The last two replace the loop only where a round has more
than nine passes, so the smaller d keep their code. This copies the
package three times under ``build/pivot_loop_ab/``, one form in each, and
in one process a copy prints its ``-Xptxas -v`` spills at d = 1323 and
times ``solve_filter_pm`` on one wave of 132 synthetic pixels at 2 sweeps
(CUDA events, after a warm-up call), in the order passes, index, groups,
groups, index, passes. Each line gives a hash of the field: the three
forms sum in the same order, so they must give the same bits.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
WORK = PACKAGE.parent / "build" / "pivot_loop_ab"
D, OFFSETS, CENTERS, SWEEPS = 1323, 1369, 132, 2
LOOP = """        {
          const float4* wv[NP];
          const float4* qv[NP];
#pragma unroll
          for (int k = 0; k < NP; ++k) {
            const int pk = p0 + k * G::PPASS;
            const int pc = pk < HALF ? pk : p0;
            wv[k] = reinterpret_cast<const float4*>(W(cur[pc]));
            qv[k] = reinterpret_cast<const float4*>(Q(cur[pc + HALF]));
            sp[k] = 0.f;
          }
"""
SHUFFLE = """#pragma unroll
          for (int o = 4; o >= 1; o /= 2)
#pragma unroll
            for (int k = 0; k < NP; ++k) sp[k] += __shfl_xor_sync(FULL, sp[k], o);
        } else
"""
INDEX = """        if constexpr (NP > 9) {
          int ra[NP], rb[NP];
#pragma unroll
          for (int k = 0; k < NP; ++k) {
            const int pk = p0 + k * G::PPASS;
            const int pc = pk < HALF ? pk : p0;
            ra[k] = cur[pc];
            rb[k] = DP + cur[pc + HALF];
            sp[k] = 0.f;
          }
#pragma unroll
          for (int mm = 0; mm < (Q4 + 7) / 8; ++mm) {
            const int c4 = sub + 8 * mm;
            if (c4 < Q4) {
#pragma unroll
              for (int k = 0; k < NP; ++k) {
                if (k == 0 || p0 + k * G::PPASS < HALF) {
                  const float4 a = reinterpret_cast<const float4*>(row(ra[k]))[c4];
                  const float4 b = reinterpret_cast<const float4*>(row(rb[k]))[c4];
                  sp[k] = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, sp[k]))));
                }
              }
            }
          }
""" + SHUFFLE
GROUPS = """        if constexpr (NP > 9) {
#pragma unroll
          for (int k0 = 0; k0 < NP; k0 += 8) {
            constexpr int NG = 8;
            const float4* wv[NG];
            const float4* qv[NG];
#pragma unroll
            for (int kk = 0; kk < NG; ++kk) {
              const int k = k0 + kk;
              if (k < NP) {
                const int pk = p0 + k * G::PPASS;
                const int pc = pk < HALF ? pk : p0;
                wv[kk] = reinterpret_cast<const float4*>(W(cur[pc]));
                qv[kk] = reinterpret_cast<const float4*>(Q(cur[pc + HALF]));
                sp[k] = 0.f;
              }
            }
#pragma unroll
            for (int mm = 0; mm < (Q4 + 7) / 8; ++mm) {
              const int c4 = sub + 8 * mm;
              if (c4 < Q4) {
#pragma unroll
                for (int kk = 0; kk < NG; ++kk) {
                  const int k = k0 + kk;
                  if (k < NP && (k == 0 || p0 + k * G::PPASS < HALF)) {
                    const float4 a = wv[kk][c4], b = qv[kk][c4];
                    sp[k] = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, sp[k]))));
                  }
                }
              }
            }
          }
""" + SHUFFLE
# the text put before the kernel's loop in each copy
FORMS = {"passes": "", "index": INDEX, "groups": GROUPS}


def copy_form(name: str) -> Path:
    """A copy of the package whose kernel takes form ``name`` of the loop."""
    root = WORK / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE, root / PACKAGE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = root / PACKAGE.name / "csrc" / "solve_filter_smem.cu"
    text = src.read_text()
    if text.count(LOOP) != 1:
        raise RuntimeError(f"{src}: the pivot-product loop is not there once")
    src.write_text(text.replace(LOOP, FORMS[name] + LOOP))
    return root


def time_form(label: str) -> None:
    """Time the case with the package this process imported."""
    import torch

    from bcd_tpu_torch.ops import _build
    from bcd_tpu_torch.ops import solve_filter as ts
    from bcd_tpu_torch.ops.pivot_ab import inputs

    if not torch.cuda.is_available():
        raise SystemExit("pivot_loop_ab needs a CUDA card")
    if not Path(_build.__file__).resolve().is_relative_to(
            Path.cwd().resolve()):
        raise SystemExit(f"imported {_build.__file__}, not the copy here")
    tail = _build.build_log().split(f"solve_filter_smem_kernelILi{D}E", 1)[1]
    spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", tail)
    x = inputs(D, OFFSETS, CENTERS, torch.device("cuda"))
    out = ts.solve_filter_pm(*x, 1e-8, npx=D // 3, sweeps=SWEEPS)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    ts.solve_filter_pm(*x, 1e-8, npx=D // 3, sweeps=SWEEPS)
    e1.record()
    torch.cuda.synchronize()
    h = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
    print(f"[{label}] d={D}: stack {spill.group(1)}, spills "
          f"{spill.group(2)} / {spill.group(3)} bytes; {CENTERS} centers of "
          f"{OFFSETS} offsets, {SWEEPS} sweeps: {e0.elapsed_time(e1):.3f} "
          f"ms, field {h}", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--time"]:
        time_form(sys.argv[2])
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    roots = {name: copy_form(name) for name in FORMS}
    env = {name: dict(os.environ, PYTHONPATH=str(root))
           for name, root in roots.items()}
    # the three libraries build at once
    builds = [subprocess.Popen(
        [sys.executable, "-c",
         f"from {PACKAGE.name}.ops import _build; _build.library()"],
        cwd=roots[name], env=env[name]) for name in FORMS]
    if any(proc.wait() for proc in builds):
        raise SystemExit("a build failed")
    for name in ("passes", "index", "groups", "groups", "index", "passes"):
        subprocess.run([sys.executable, "-m",
                        f"{PACKAGE.name}.ops.pivot_loop_ab", "--time", name],
                       cwd=roots[name], env=env[name], check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
