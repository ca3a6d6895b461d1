"""The Cholesky's pivot row of ``csrc/solve_filter_smem.cu``, in registers
against staged in shared memory, at every d the kernel is built for, on
one CUDA card:

    python -m bcd_tpu_torch.ops.pivot_ab

The kernel picks one at compile time (``Smem<D>::PIVOT_SMEM``: the row is
staged where a lane's columns pass 16, at d = 675 to 1875). This copies the package
twice under ``build/pivot_ab/``, with the row staged at every d in one copy
and in registers at every d in the other, and in one process a copy times
``solve_filter_pm`` on the same synthetic inputs (CUDA events, after a
warm-up call), in the order registers, staged, staged, registers. Each
line gives a field's hash, which shows that the two give the same numbers,
and each copy's ``-Xptxas -v`` spills of the kernel.
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
WORK = PACKAGE.parent / "build" / "pivot_ab"
CHOICE = "static constexpr bool PIVOT_SMEM = CL > 16;"
VARIANTS = {"registers": "false", "staged": "true"}
# (d, offsets, centers, timed calls): each d at the smallest window that
# reaches its main path, on two or more waves of a 132-SM grid
CASES = ((147, 169, 1056, 3), (243, 289, 528, 3), (363, 441, 264, 1),
         (507, 529, 264, 1), (675, 729, 264, 1), (867, 961, 264, 1),
         (1083, 1089, 264, 1), (1323, 1369, 264, 1), (1587, 1681, 264, 1),
         (1875, 2025, 264, 1))


def copy_variant(name: str) -> Path:
    """A copy of the package whose kernel keeps the pivot row as ``name``
    says at every d."""
    root = WORK / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE, root / PACKAGE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = root / PACKAGE.name / "csrc" / "solve_filter_smem.cu"
    text = src.read_text()
    if text.count(CHOICE) != 1:
        raise RuntimeError(f"{src}: the line {CHOICE!r} is not there once")
    src.write_text(text.replace(
        CHOICE, f"static constexpr bool PIVOT_SMEM = {VARIANTS[name]};"))
    return root


def inputs(d: int, n_off: int, p: int, dev):
    """Synthetic pixel-major stacks (cand, mask, noise, n, m), seeded by
    d: 70% of the candidates similar, the middle one always."""
    import torch

    g = torch.Generator(device=dev).manual_seed(d)
    cand = torch.randn(p, n_off, d, generator=g, device=dev)
    mask = (torch.rand(p, n_off, generator=g, device=dev) < 0.7).float()
    mask[:, n_off // 2] = 1.0
    n = mask.sum(1)
    m = (cand * mask[..., None]).sum(1) / n[:, None]
    npx = d // 3
    noise = torch.zeros(p, npx, 6, device=dev)
    noise[..., :3] = 0.05 + 0.1 * torch.rand(p, npx, 3, generator=g,
                                             device=dev)
    noise[..., 3:] = 0.01 * torch.randn(p, npx, 3, generator=g, device=dev)
    return cand, mask, noise.reshape(p, 6 * npx), n, m


def time_variant(label: str) -> None:
    """Time every case with the package this process imported."""
    import torch

    from bcd_tpu_torch.core.monoscale import solve_filter_sweeps
    from bcd_tpu_torch.ops import _build
    from bcd_tpu_torch.ops import solve_filter as ts

    if not torch.cuda.is_available():
        raise SystemExit("pivot_ab needs a CUDA card")
    if not Path(_build.__file__).resolve().is_relative_to(
            Path.cwd().resolve()):
        raise SystemExit(f"imported {_build.__file__}, not the copy here")
    dev = torch.device("cuda")
    log = _build.build_log()
    for d in dict.fromkeys(re.findall(r"solve_filter_smem_kernelILi(\d+)E",
                                      log)):
        tail = log.split(f"solve_filter_smem_kernelILi{d}E", 1)[1]
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", tail)
        print(f"[{label}] d={d} spills {spill.group(1)} / {spill.group(2)} "
              "bytes", flush=True)
    for d, n_off, p, reps in CASES:
        x = inputs(d, n_off, p, dev)
        sweeps = solve_filter_sweeps(d)
        out = ts.solve_filter_pm(*x, 1e-8, npx=d // 3, sweeps=sweeps)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            ts.solve_filter_pm(*x, 1e-8, npx=d // 3, sweeps=sweeps)
        e1.record()
        torch.cuda.synchronize()
        h = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"[{label}] d={d} O={n_off} {p} centers, {sweeps} sweeps: "
              f"{e0.elapsed_time(e1) / reps:.3f} ms, field {h}", flush=True)
        del x, out


def main() -> int:
    if sys.argv[1:2] == ["--time"]:
        time_variant(sys.argv[2])
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    roots = {name: copy_variant(name) for name in VARIANTS}
    for name in ("registers", "staged", "staged", "registers"):
        env = dict(os.environ, PYTHONPATH=str(roots[name]))
        subprocess.run([sys.executable, "-m", f"{PACKAGE.name}.ops.pivot_ab",
                        "--time", name], cwd=roots[name], env=env, check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
