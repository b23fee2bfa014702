#!/usr/bin/env python3
"""Host op counts of the port's torch chain on the CPU: the ``aten::`` ops
``torch.profiler`` records for one call, so that a change can show that a
path issues the ops it issued before, or how many more.

    python3 tools/ab/host_ops.py [TREE ...]

Each TREE (a directory holding a tree of the repo, as ``tools/ab/
kernel_ab.py prepare`` writes them under ``build/ab/``; default: this
checkout) runs in a process of its own, on the CPU: ``li_direct`` (depth 3)
and ``_li_wavefront`` (depth 5) on BASELINE config 1 at 32x18, then one
``render_pass`` of config 1 (direct, depth 3) and of each of
``gallery.FAMILIES`` at 48x27, 1 spp.  It prints one JSON line a tree:
the op count of each call, and the sum of the radiance where a call
returns it (equal sums in two trees: the same result).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _count(fn) -> int:
    from torch.profiler import ProfilerActivity, profile

    fn()  # first-call work (lazy tables) is not the path's
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.events() if e.name.startswith("aten::"))


def measure() -> dict:
    from gopbrt_tpu_torch.models import film as film_mod
    from gopbrt_tpu_torch.models import gallery, integrators, render

    out = {}
    scene, camera, settings = gallery.config1(32, 18, device="cpu")
    settings = settings._replace(spp=1, samples_per_pass=1)
    _, o, d, pix, smp = render.band_rays(camera, settings, 0, 18, 0)
    cone = render._cone(camera, settings)
    calls = {
        "config1_li_direct_32x18_d3": lambda: integrators.li_direct(
            scene, o, d, pix, smp, settings.seed, max_depth=3, cone=cone),
        "config1_li_wavefront_32x18_d5": lambda: integrators._li_wavefront(
            scene, o, d, pix, smp, settings.seed, integrators.PathConfig(max_depth=5),
            cone=cone),
    }
    for name, fn in calls.items():
        out[name] = {"aten_ops": _count(fn), "sum_L": float(fn().sum())}
    passes = {"config1": gallery.config1(48, 27, device="cpu")}
    passes["config1"] = (*passes["config1"][:2],
                         passes["config1"][2]._replace(spp=1, samples_per_pass=1))
    for name, build in getattr(gallery, "FAMILIES", {}).items():
        passes[name] = build(48, 27, device="cpu")
    for name, (scene, camera, settings) in passes.items():
        film = film_mod.new_film(settings.width, settings.height, device="cpu")
        out[f"{name}_render_pass_48x27"] = {"aten_ops": _count(
            lambda: render.render_pass(scene, camera, film, settings, 1, device="cpu"))}
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--here":
        print(json.dumps(measure()), flush=True)
        return 0
    rc = 0
    for tree in sys.argv[1:] or [str(ROOT)]:
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--here"],
                             cwd=tree, capture_output=True, text=True,
                             env=dict(os.environ, PYTHONPATH=str(Path(tree).resolve())))
        line = next((ln for ln in res.stdout.splitlines() if ln.startswith("{")), None)
        print(json.dumps({"tree": tree, "ops": json.loads(line) if line else None,
                          "rc": res.returncode}), flush=True)
        rc |= res.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
