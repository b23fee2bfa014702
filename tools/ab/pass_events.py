#!/usr/bin/env python3
"""Device events of a 1080p pass, by name, in profiler sessions run one
after another in one process: whether a pass's count of device kernels and
copies depends on the session it lands in, and which events differ
between two trees.

    python3 tools/ab/pass_events.py [--out DIR] [TREE ...]

Each TREE (a directory holding a tree of the repo, as
``tools/ab/kernel_ab.py prepare`` writes them under ``build/ab/``; default:
this checkout) runs in a process of its own, on the card: the demo scene
(path depth 10) and the mesh scene (depth 5) at 1920x1080, 1 spp, a
warm-up pass each, then ``SESSIONS`` profiled passes of each in turn.  It
prints each session's event count and the events by which the sessions
differ, and writes ``DIR/pass_events.json`` (DIR: ``build/ab/out``).
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SESSIONS = 3


def _events(render, scene, camera, settings, dev, sample) -> collections.Counter:
    import torch

    from gopbrt_tpu_torch.models import film as film_mod

    film = film_mod.new_film(settings.width, settings.height, device=dev)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        render.render_pass(scene, camera, film, settings, sample, device=dev)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return collections.Counter(e.name for e in prof.events()
                               if e.device_type == cuda and not e.name.startswith("render."))


def child() -> dict:
    """Runs in the tree's own process (the tree is the working directory)."""
    import torch

    sys.path.insert(0, str(Path.cwd()))
    from gopbrt_tpu_torch.models import film as film_mod
    from gopbrt_tpu_torch.models import meshes, render
    from gopbrt_tpu_torch.models.demo import build_demo_camera, build_demo_scene, demo_settings

    if not torch.cuda.is_available():
        raise SystemExit("pass_events: no CUDA device")
    dev = torch.device("cuda")
    w, h = 1920, 1080
    paths = {
        "demo": (build_demo_scene(device=dev), build_demo_camera(w, h, device=dev),
                 demo_settings(w, h, spp=1, samples_per_pass=1)),
        "mesh": (meshes.build_mesh_scene(device=dev), meshes.mesh_camera(w, h, device=dev),
                 render.RenderSettings(width=w, height=h, spp=1, max_depth=5,
                                       samples_per_pass=1)),
    }
    for scene, camera, settings in paths.values():  # warm-up
        render.render_pass(scene, camera, film_mod.new_film(w, h, device=dev), settings, 0,
                           device=dev)
    torch.cuda.synchronize()
    out = {name: [] for name in paths}
    for s in range(SESSIONS):
        for name, (scene, camera, settings) in paths.items():
            out[name].append(dict(_events(render, scene, camera, settings, dev, s + 1)))
    return out


def _diff(a: dict, b: dict) -> dict:
    """Events whose counts differ: {name: [count in a, count in b]}."""
    return {k: [a.get(k, 0), b.get(k, 0)] for k in sorted(set(a) | set(b))
            if a.get(k, 0) != b.get(k, 0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ab" / "out")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("trees", nargs="*", type=Path)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child()))
        return 0
    results = {}
    for tree in args.trees or [ROOT]:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child"],
                              cwd=tree, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        results[str(tree)] = json.loads(proc.stdout.strip().splitlines()[-1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    trees = list(results)
    for tree, paths in results.items():
        for name, sessions in paths.items():
            counts = [sum(s.values()) for s in sessions]
            print(f"{tree} {name}: events a session {counts}; session 1 vs {SESSIONS}: "
                  f"{json.dumps(_diff(sessions[0], sessions[-1]))}")
    for name in results[trees[0]]:
        for tree in trees[1:]:
            print(f"{name}, last session, {trees[0]} vs {tree}: "
                  f"{json.dumps(_diff(results[trees[0]][name][-1], results[tree][name][-1]))}")
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "pass_events.json").write_text(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
