#!/usr/bin/env python3
"""Where a kernel's local-memory traffic comes from: the LDL / STL
instructions of its SASS by the source line they were compiled from.

    python3 tools/ab/sass_lines.py [--source mesh_megakernel.cu] [--top 25] TREE ...

For each TREE (a root of the repo, e.g. ``.`` or ``build/ab/parent``),
compiles ``gopbrt_tpu_torch/csrc/SOURCE`` with the package's nvcc flags
plus ``-lineinfo -cubin`` into a temporary directory, disassembles it with
``nvdisasm -g`` (the toolkit's, beside nvcc) and prints, per kernel, the
registers and spill bytes ptxas reports, the LDL and STL count, and the
source lines (file:line, the innermost of an inlined call) with the most
local loads and stores.  A local load or store is a register spill or an
access to an array indexed at run time (the BVH walk's stack).  Needs
the CUDA toolkit; run it on the machine with the card, e.g. in the same
call as ``kernel_ab.py run``.  ``-lineinfo`` adds line tables only; the
code is that of the package's build.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

LOCAL = re.compile(r"\b(LDL|STL)\b")
WHERE = re.compile(r'//## File "([^"]+)", line (\d+)')
FUNCTION = re.compile(r"\.text\.(\S+?):?\s*$|Function : (\S+)")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _flags(tree: Path) -> list[str]:
    """The tree's own nvcc flags (its _build.NVCC_FLAGS), for a cubin
    instead of a shared library."""
    spec = importlib.util.spec_from_file_location(
        f"_build_{abs(hash(str(tree)))}", tree / "gopbrt_tpu_torch" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    drop = {"-shared", "-Xcompiler", "-fPIC"}
    return [f for f in mod.NVCC_FLAGS if f not in drop] + ["-lineinfo", "-cubin"]


def analyse(tree: Path, source: str, top: int) -> None:
    nvcc = _nvcc()
    csrc = tree / "gopbrt_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        p = subprocess.run([nvcc, *_flags(tree), "-o", str(cubin), str(csrc / source)],
                           capture_output=True, text=True, timeout=600)
        if p.returncode:
            print(f"[sass-lines] {tree}: nvcc failed\n{p.stdout}{p.stderr}", flush=True)
            return
        ptxas = [ln.strip() for ln in (p.stdout + p.stderr).splitlines()
                 if "registers" in ln or "spill" in ln]
        dis = subprocess.run([os.path.join(os.path.dirname(nvcc), "nvdisasm"), "-g", "-c",
                              str(cubin)], capture_output=True, text=True, timeout=600)
    if dis.returncode:
        print(f"[sass-lines] {tree}: nvdisasm failed: {dis.stderr[-500:]}", flush=True)
        return
    per_fn: dict = collections.defaultdict(collections.Counter)
    totals: dict = collections.defaultdict(collections.Counter)
    fn, where = "?", "?"
    for line in dis.stdout.splitlines():
        m = FUNCTION.search(line)
        if m and ("Function" in line or line.lstrip().startswith(".text.")):
            fn, where = m.group(1) or m.group(2), "?"
            continue
        m = WHERE.search(line)
        if m:
            where = f"{os.path.basename(m.group(1))}:{m.group(2)}"
            continue
        m = LOCAL.search(line)
        if m:
            per_fn[fn][(where, m.group(1))] += 1
            totals[fn][m.group(1)] += 1
    print(f"[sass-lines] {tree} {source}: " + " | ".join(ptxas), flush=True)
    for name, counter in per_fn.items():
        print(f"[sass-lines] {name}: {totals[name]['LDL']} LDL, {totals[name]['STL']} STL; "
              "by line: " + ", ".join(f"{w} {op} {n}" for (w, op), n in
                                      counter.most_common(top)), flush=True)
    if not per_fn:
        print(f"[sass-lines] {tree} {source}: no local loads or stores", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default="mesh_megakernel.cu")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("trees", nargs="+", type=Path)
    a = ap.parse_args()
    for tree in a.trees:
        analyse(tree.resolve(), a.source, a.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
