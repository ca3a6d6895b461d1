"""The SASS of ``csrc/solve_filter_smem.cu`` against another version of the
file, kernel by kernel, and where one instance's spills sit, on a machine
with ``nvcc`` (no card needed); with a third argument, also the SASS of
``csrc/solve_filter_big.cu``'s kernels against another version of that file:

    git show <commit>:bcd_tpu_torch/csrc/solve_filter_smem.cu > build/parent.cu
    git show <commit>:bcd_tpu_torch/csrc/solve_filter_big.cu > build/parent_big.cu
    python -m bcd_tpu_torch.ops.sass_check build/parent.cu 1875 build/parent_big.cu

Both files are compiled with the library's flags (``ops/_build.NVCC_FLAGS``)
under ``build/sass_check/``, the other one under this one's file name, and
each ``solve_filter_smem_kernel<D>`` of ``cuobjdump -sass`` is compared
line for line, with the hashed part of the anonymous namespace's names
blanked. A change that adds an instance must leave every other one SAME.
The library's build compiles the file once for each d
(``_build.SPLIT``); each of those units' kernel must be this tree's
one-unit SASS too (UNIT SAME). Then this tree's file is compiled again
with ``-lineinfo``, and the spill stores and loads (STL, LDL) of ``solve_filter_smem_kernel<D>`` are counted
by source line (``nvdisasm -g -c``), after its ``-Xptxas -v`` report.

``solve_filter_big_kernel`` is a template on its front and back ends
(``kMoments``: the candidate stack and the field, or the lane
solve_matrices' moments and matrices); its ``solve_filter`` instance
(``<false>``) is compared with the other file's kernel of that name,
whether or not that one is a template, and each instance is printed SAME,
DIFF, NEW or GONE.
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from bcd_tpu_torch.ops import _build

SOURCE = _build.CSRC / "solve_filter_smem.cu"
WORK = _build.BUILD_DIR.parent / "sass_check"


def tool(name: str) -> str:
    return str(Path(_build._nvcc()).parent / name)


def run(cmd) -> str:
    proc = subprocess.run([str(c) for c in cmd], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(map(str, cmd))}: rc "
                           f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _by_kernel(sass: str, pattern: str, key) -> dict:
    """``cuobjdump -sass`` text split by kernel: each function whose name
    matches ``pattern`` under ``key(match)``, with the hashed part of the
    anonymous namespace's names blanked, runs of spaces (whose width
    follows the file's longest line) made one, and the branch labels
    (``.L_x_N``, numbered through the whole file) renumbered from 0 in
    each kernel."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : \S*" + pattern, line)
        if m:
            cur = out.setdefault(key(m), [])
        elif "Function :" in line:
            cur = None
        elif cur is not None:
            cur.append(" ".join(re.sub(r"_GLOBAL__N__\w+", "", line).split()))
    for k, lines in out.items():
        labels = {}
        out[k] = [re.sub(r"\.L_x_\d+", lambda m: ".L" + str(
            labels.setdefault(m.group(0), len(labels))), line)
            for line in lines]
    return out


def kernels(sass: str) -> dict[int, list[str]]:
    """``solve_filter_smem_kernel<D>``'s SASS by its d (``_by_kernel``)."""
    return _by_kernel(sass, r"solve_filter_smem_kernelILi(\d+)E",
                      lambda m: int(m.group(1)))


def big_kernels(sass: str) -> dict[str, list[str]]:
    """``solve_filter_big_kernel``'s SASS by instance, "solve_filter"
    (``<false>``, or the kernel where it is no template) or
    "solve_matrices" (``<true>``) (``_by_kernel``)."""
    return _by_kernel(sass, r"solve_filter_big_kernel(ILb([01])E)?",
                      lambda m: "solve_matrices" if m.group(2) == "1"
                      else "solve_filter")


def compare_big(other: Path) -> dict[str, str]:
    """Compile ``csrc/solve_filter_big.cu`` and ``other`` (under this file's
    name) with the library's flags and print each instance of
    ``solve_filter_big_kernel`` as SAME, DIFF, NEW or GONE against it;
    returns {instance: state}."""
    source = _build.CSRC / "solve_filter_big.cu"
    (WORK / "other_big").mkdir(parents=True, exist_ok=True)
    shutil.copy(other, WORK / "other_big" / source.name)
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    jobs = {"other_big": [nvcc, *flags, "-c", "-o", WORK / "other_big.o",
                          WORK / "other_big" / source.name],
            "tree_big": [nvcc, *flags, "-c", "-o", WORK / "tree_big.o",
                         source]}
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(run, jobs.values()))
    old, new = (big_kernels(run([tool("cuobjdump"), "-sass",
                                 WORK / f"{k}.o"]))
                for k in ("other_big", "tree_big"))
    states = {}
    for k in sorted(set(old) | set(new)):
        states[k] = ("NEW" if k not in old else "GONE" if k not in new
                     else "SAME" if old[k] == new[k] else "DIFF")
        print(f"solve_filter_big_kernel, {k} instance: {states[k]} against "
              f"{other}", flush=True)
        if states[k] == "DIFF":
            print(f"    {first_difference(old[k], new[k])}", flush=True)
    return states


def first_difference(a: list[str], b: list[str]) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"line {i}: {x} | {y}"
    return f"lengths {len(a)} and {len(b)}"


def spills_by_line(cubin: Path, d: int) -> collections.Counter:
    """(source line, STL or LDL) -> its count in the kernel at ``d``."""
    counts, fn, line = collections.Counter(), "", 0
    for text in run([tool("nvdisasm"), "-g", "-c", cubin]).splitlines():
        m = re.match(r"\s*\.text\.(\S+):", text)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r'//## File ".*?", line (\d+)', text)
        if m:
            line = int(m.group(1))
        elif f"solve_filter_smem_kernelILi{d}E" in fn:
            for op in ("STL", "LDL"):
                if re.search(rf"\b{op}\b", text):
                    counts[(line, op)] += 1
    return counts


def main() -> int:
    if len(sys.argv) not in (3, 4):
        raise SystemExit("usage: python -m bcd_tpu_torch.ops.sass_check "
                         "OTHER_SOLVE_FILTER_SMEM_CU D "
                         "[OTHER_SOLVE_FILTER_BIG_CU]")
    other, d = Path(sys.argv[1]), int(sys.argv[2])
    if len(sys.argv) == 4:
        compare_big(Path(sys.argv[3]))
    (WORK / "other").mkdir(parents=True, exist_ok=True)
    shutil.copy(other, WORK / "other" / SOURCE.name)
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    one_d, _, dims = _build.SPLIT[SOURCE.name]
    jobs = {"other": [nvcc, *flags, "-c", "-o", WORK / "other.o",
                      WORK / "other" / SOURCE.name],
            "tree": [nvcc, *flags, "-c", "-o", WORK / "tree.o", SOURCE],
            "lineinfo": [nvcc, *flags, "-lineinfo", "-cubin", "-o",
                         WORK / "tree.cubin", SOURCE]}
    jobs.update({f"unit{k}": [nvcc, *flags, f"-D{one_d}={k}", "-c", "-o",
                              WORK / f"unit{k}.o", SOURCE] for k in dims})
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = dict(zip(jobs, pool.map(run, jobs.values())))
    old, new = (kernels(run([tool("cuobjdump"), "-sass", WORK / f"{k}.o"]))
                for k in ("other", "tree"))
    for k in sorted(set(old) | set(new)):
        state = ("NEW" if k not in old else "GONE" if k not in new
                 else "SAME" if old[k] == new[k] else "DIFF")
        unit = kernels(run([tool("cuobjdump"), "-sass",
                            WORK / f"unit{k}.o"])) if k in dims else {}
        same = unit.get(k) == new.get(k)
        print(f"solve_filter_smem_kernel<{k}>: {state} against {other}; "
              f"its build unit {'UNIT SAME' if same else 'UNIT DIFF'}"
              + ("" if same or k not in unit or k not in new else
                 f" ({first_difference(new[k], unit[k])})"), flush=True)
        if state == "DIFF":
            print(f"    {first_difference(old[k], new[k])}", flush=True)
    report = logs["tree"].split(f"solve_filter_smem_kernelILi{d}E", 1)[1]
    print(f"<{d}> -Xptxas -v: "
          + "; ".join(x.strip() for x in report.splitlines()[1:3]))
    src = SOURCE.read_text().splitlines()
    for (line, op), n in sorted(spills_by_line(WORK / "tree.cubin",
                                               d).items()):
        print(f"<{d}> {op} {n:3d} at line {line}: "
              f"{src[line - 1].strip()[:70]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
