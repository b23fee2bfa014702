#!/usr/bin/env python3
"""Kernel A/B of the port on one card: ``chip_smoke.py`` of several source
trees, run in turns in one process tree, so two versions of a kernel meet
the same card, clocks and power limit.

Prepare the trees in a git checkout, then run them on a machine with the
card:

    python3 tools/ab/kernel_ab.py prepare PARENT_REV [VARIANT ...]
    python3 tools/ab/kernel_ab.py run [--out DIR] parent change wavefront_sort change parent
    python3 tools/ab/kernel_ab.py launches [--out DIR] parent change change parent

``prepare`` writes ``build/ab/<tree>/``, each a whole tree of the repo:

- ``parent``: ``git archive PARENT_REV``;
- ``change``: the working tree as ``git add -A`` would stage it (through a
  scratch index; the checkout's own index is left alone);
- each VARIANT: ``change`` with the patches ``tools/ab/<name>.patch``
  applied in turn, one for each ``+``-separated name (``a+b``).

``run`` runs ``python3 chip_smoke.py`` in each named tree in the order
given (a tree may come back), one at a time, each building its kernels in
its own ``build/``.  Each run's whole output goes to ``DIR/<k>-<tree>.log``
(DIR: ``build/ab/out`` unless given); the per-run figures (each kernel's
ms per launch and per pass, its share of the bound, the passes' ms) go to
``DIR/summary.json`` and are printed as a table.  A tree that
fails is recorded and the others still run; the exit code is 1 if any
failed.

``launches`` times the BVH walk kernels alone, in each named tree in the
order given: every launch the general chain makes over one 1920x273 band
of the metal mesh at depth 5 (CUDA events, median of 21, inputs recorded
from the chain), and the walk kernels' device ms in one profiled 1080p
metal-mesh pass.  It prints and writes ``DIR/launches.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tarfile
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PATCHES = Path(__file__).resolve().parent
TREES = ROOT / "build" / "ab"
RUN_TIMEOUT_S = 600


def _git(*args: str, env=None) -> str:
    return subprocess.run(["git", *args], cwd=ROOT, check=True, capture_output=True,
                          text=True, env=env).stdout.strip()


def _unpack(rev: str, dest: Path) -> None:
    if dest.exists():
        shutil.rmtree(dest)
    dest.mkdir(parents=True)
    with tempfile.TemporaryDirectory() as tmp:
        tar = Path(tmp) / "tree.tar"
        subprocess.run(["git", "archive", "-o", str(tar), rev], cwd=ROOT, check=True)
        with tarfile.open(tar) as t:
            t.extractall(dest, filter="data")


def prepare(parent: str, variants: list[str]) -> None:
    _unpack(parent, TREES / "parent")
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, GIT_INDEX_FILE=str(Path(tmp) / "index"))
        shutil.copy(ROOT / ".git" / "index", env["GIT_INDEX_FILE"])
        _git("add", "-A", env=env)
        tree = _git("write-tree", env=env)
    _unpack(tree, TREES / "change")
    for name in variants:
        dest = TREES / name
        if dest.exists():
            shutil.rmtree(dest)
        shutil.copytree(TREES / "change", dest)
        for part in name.split("+"):
            with open(PATCHES / f"{part}.patch", "rb") as f:
                subprocess.run(["patch", "-p1", "--quiet", "-d", str(dest)], stdin=f,
                               check=True)
    print(f"parent = {parent}, change = tree {tree}; trees in {TREES}: "
          + ", ".join(["parent", "change", *variants]))


def _figures(log: str) -> dict:
    """What one chip_smoke.py run printed: the kernels line's figures by
    kernel, the main paths' ms per pass, the ptxas lines and the SASS local
    loads and stores (trees that print them)."""
    out: dict = {"kernels": {}, "passes_ms": {}, "ptxas": {}, "sass": {}}
    for line in log.splitlines():
        if line.startswith('{"kernels"'):
            for k in json.loads(line)["kernels"]:
                out["kernels"][k["name"]] = {
                    key: k.get(key) for key in ("ms", "bound_ms", "ms_per_pass",
                                                "ms_last_launch", "launches")}
        m = re.match(r"\[main-path\] (demo|config 1|feature scene|mesh|metal mesh)\b.*?"
                     r"([\d.]+) ms per pass", line)
        if m and "profiled" not in line:
            out["passes_ms"][m.group(1)] = float(m.group(2))
        m = re.match(r"\[sass\] (\w+): (.*)", line)
        if m:
            out["sass"][m.group(1)] = m.group(2)
        m = re.match(r"\[build\] (\w+): nvcc [\d.]+ s; (.*)", line)
        if m:
            out["ptxas"][m.group(1)] = re.findall(
                r"(\d+ bytes stack frame, \d+ bytes spill stores|Used \d+ registers)",
                m.group(2))
    return out


def run(order: list[str], out_dir: Path) -> int:
    out_dir.mkdir(parents=True, exist_ok=True)
    card = "not read"
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else card
    print(card, flush=True)
    runs = []
    for k, name in enumerate(order, 1):
        tree = TREES / name
        t0 = time.perf_counter()
        try:
            p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, text=True,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               timeout=RUN_TIMEOUT_S)
            rc, log = p.returncode, p.stdout
        except subprocess.TimeoutExpired as e:
            out = e.stdout or ""
            rc, log = 124, out.decode() if isinstance(out, bytes) else out
        seconds = time.perf_counter() - t0
        (out_dir / f"{k}-{name}.log").write_text(log)
        runs.append({"k": k, "tree": name, "rc": rc, "seconds": seconds, **_figures(log)})
        print(f"[ab] run {k} {name}: rc {rc}, {seconds:.1f} s", flush=True)
    (out_dir / "summary.json").write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    kernels = sorted({n for r in runs for n in r["kernels"]})
    print(f"ms per launch (median of CUDA events), then device ms per pass; {card}")
    for r in runs:
        cells = []
        for n in kernels:
            f = r["kernels"].get(n)
            if f:
                share = f["bound_ms"] / f["ms"] if f["ms"] else float("nan")
                cells.append(f"{n} {f['ms']:.4f} ({share:.3f} of bound"
                             + (f", {f['ms_per_pass']:.3f}/pass" if f.get("ms_per_pass") else "")
                             + (f", last {f['ms_last_launch']:.4f}"
                                if f.get("ms_last_launch") else "") + ")")
        passes = ", ".join(f"{k} {v:.2f}" for k, v in r["passes_ms"].items())
        print(f"{r['k']:>2} {r['tree']}: rc {r['rc']}; " + "; ".join(cells)
              + f"; passes ms: {passes}", flush=True)
    return 1 if any(r["rc"] != 0 for r in runs) else 0


# Run in a tree's root by ``launches``; uses only what PR 3's tree has too.
LAUNCHES_CODE = r"""
import json, statistics, sys
import torch
sys.path.insert(0, ".")
from gopbrt_tpu_torch import _build
from gopbrt_tpu_torch.models import film as film_mod, integrators, meshes, render
from gopbrt_tpu_torch.ops import bvh

W, H, DEPTH = 1920, 1080, 5
dev = torch.device("cuda")
_build.build()
metal = meshes.build_mesh_scene(device=dev, mesh_material="metal")
cam = meshes.mesh_camera(W, H, device=dev)
settings = render.RenderSettings(width=W, height=H, spp=1, max_depth=DEPTH,
                                 integrator="path", samples_per_pass=1)
rows = settings.chunk_pixels // W
_, o, d, pix, smp = render.band_rays(cam, settings, rows, rows, 0)
calls = []
names = ("bvh_intersect_fused", "bvh_intersect_p_fused")
saved = [getattr(bvh, k) for k in names]
for k, fn in zip(names, saved):
    def rec(*a, fn=fn, k=k):
        calls.append((k, a))
        return fn(*a)
    setattr(bvh, k, rec)
integrators._li_wavefront(metal, o, d, pix, smp, settings.seed, render.path_config(settings),
                          cone=render._cone(cam, settings))
for k, fn in zip(names, saved):
    setattr(bvh, k, fn)

def ms(fn, reps=21):
    fn()
    torch.cuda.synchronize()
    t = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        t.append(a.elapsed_time(b))
    return statistics.median(t)

launches = [[k, ms(lambda: getattr(bvh, k)(*a))] for k, a in calls]
film = film_mod.new_film(W, H, device=dev)
render.render_pass(metal, cam, film, settings, 0, device=dev)
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    render.render_pass(metal, cam, film, settings, 1, device=dev)
    torch.cuda.synchronize()
cuda = torch.autograd.DeviceType.CUDA
per_pass = {k: sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == cuda and k in e.name) / 1e3
            for k in ("bvh_closest_kernel", "bvh_any_kernel")}
print(json.dumps({"launches": launches, "per_pass_ms": per_pass}))
"""


def launches(order: list[str], out_dir: Path) -> int:
    out_dir.mkdir(parents=True, exist_ok=True)
    runs, failed = [], False
    for k, name in enumerate(order, 1):
        p = subprocess.run([sys.executable, "-c", LAUNCHES_CODE], cwd=TREES / name, text=True,
                           capture_output=True, timeout=RUN_TIMEOUT_S)
        last = p.stdout.strip().splitlines()[-1:] if p.returncode == 0 else []
        if not last:
            failed = True
            print(f"[launches] run {k} {name}: rc {p.returncode}\n{p.stderr[-2000:]}", flush=True)
            continue
        r = {"k": k, "tree": name, **json.loads(last[0])}
        runs.append(r)
        band = {kind: sum(t for n, t in r["launches"] if n == kind)
                for kind in ("bvh_intersect_fused", "bvh_intersect_p_fused")}
        print(f"[launches] run {k} {name}: ms a launch " + ", ".join(
            f"{n.split('_fused')[0]} {t:.4f}" for n, t in r["launches"]) + "; band sums "
            + ", ".join(f"{n} {t:.4f}" for n, t in band.items()) + "; device ms per pass "
            + ", ".join(f"{n} {t:.4f}" for n, t in r["per_pass_ms"].items()), flush=True)
    (out_dir / "launches.json").write_text(json.dumps(runs, indent=1))
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("prepare", help="write build/ab/<tree>/ (needs git)")
    p.add_argument("parent", help="the commit to compare with, e.g. HEAD or HEAD~1")
    p.add_argument("variants", nargs="*", help="patch names of tools/ab/, joined by +")
    r = sub.add_parser("run", help="run chip_smoke.py of the trees in this order")
    r.add_argument("--out", type=Path, default=TREES / "out",
                   help="where the logs and summary.json go")
    r.add_argument("order", nargs="+")
    q = sub.add_parser("launches", help="time the BVH walk launches of the trees in turn")
    q.add_argument("--out", type=Path, default=TREES / "out")
    q.add_argument("order", nargs="+")
    a = ap.parse_args()
    if a.cmd == "prepare":
        prepare(a.parent, a.variants)
        return 0
    if a.cmd == "launches":
        return launches(a.order, a.out.resolve())
    return run(a.order, a.out.resolve())


if __name__ == "__main__":
    sys.exit(main())
