#!/usr/bin/env python3
"""The SPD sphereflake on kernel #5, on one card.

    python3 tools/sphereflake_checks.py [--seed N] [--reps N]

On the benchmark cell's frame (1024x1024, 4 samples a pixel in one pass,
path depth 10: two bands of 512 rows, one launch of 2^19 lanes a band and
sample), each line tagged as in chip_smoke.py:

- ``[flake-scene]``: the scene's build (the native SAH builder), its prims,
  the tree's nodes and depth against the walk's STACK_DEPTH, the gate;
- ``[flake-vs-plain]``: kernel #5 against ``path_li_plain(accel="bvh")`` on
  the first band's first sample, per lane (the bar of
  tests/test_torch_mesh.py: > 98% of lanes within 1e-3, mean within 1e-2),
  and every lane finite;
- ``[flake-launch]``: the device ms of a launch between CUDA events, each
  queued behind a sleeping kernel (median of ``--reps``);
- ``[flake-frame]``: one ``render.render`` of the frame under
  ``trace.enable()``: ``li.route``, the launches of the program's kernels
  (#5 only, none of the BVH walk kernels #4), the counting instance's
  lane occupancy.

Exits non-zero where a check fails.  Needs a card.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

WIDTH = HEIGHT = 1024
SPP, DEPTH = 4, 10


def tree_depth(nodes: torch.Tensor) -> int:
    """The deepest leaf's depth (the root at 1) of a packed tree
    (ops/bvh.py bvh_table: node 0 the header, a child's code its node index
    if interior, else negative)."""
    codes = nodes.reshape(-1, 16).cpu().view(torch.int32)
    depth, todo = 0, [(int(codes[0, 3]), 1)]
    while todo:
        code, d = todo.pop()
        depth = max(depth, d)
        if code >= 1:
            todo += [(int(codes[code, 3]), d + 1), (int(codes[code, 11]), d + 1)]
    return depth


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2147500411)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sphereflake_checks: no CUDA device", file=sys.stderr)
        return 1
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.models import render, spd
    from gopbrt_tpu_torch.ops import megakernel as mk
    from gopbrt_tpu_torch.ops import mesh_megakernel as mm
    from gopbrt_tpu_torch.utils import trace

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.phase("device", f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.load("mesh_megakernel")

    t0 = time.perf_counter()
    scene = spd.build_sphereflake_scene(device=dev)
    build_s = time.perf_counter() - t0
    bt = scene.bvh_tables
    depth = tree_depth(bt.nodes)
    cs.phase("flake-scene", f"{scene.prims.count} prims, built in {build_s:.2f} s "
             f"(the tree by {bt.backend}, {bt.build_ms} ms); {bt.nodes.shape[0]} nodes, "
             f"{bt.records.shape[0]} records; tree depth {depth} (stack 64); mesh_ok "
             f"{scene.fastinfo.mesh_ok}, fits {mm.fits(scene)}")
    ok = scene.fastinfo.mesh_ok and mm.fits(scene) and depth < 64

    camera = spd.sphereflake_camera(WIDTH, HEIGHT, device=dev)
    settings = render.RenderSettings(width=WIDTH, height=HEIGHT, spp=SPP,
                                     samples_per_pass=SPP, max_depth=DEPTH,
                                     rr_threshold=1.0, seed=args.seed)
    rows = settings.chunk_pixels // WIDTH
    cfg, cone = render.path_config(settings), render._cone(camera, settings)
    _, o, d, pixel, sample = render.band_rays(camera, settings, 0, rows, 0)
    out = torch.empty_like(o)
    launch = mk.make_launch(mm.MESH, scene, o, d, pixel, sample, settings.seed, cfg, cone, out)
    got = launch().clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = mk.path_li_plain(scene, o, d, pixel, sample, settings.seed, cfg, cone=cone,
                           accel="bvh")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    frac, mean_rel, max_abs = cs.agreement(got, ref)
    finite = bool(torch.isfinite(got).all())
    cs.phase("flake-vs-plain", f"band 0, sample 0 ({o.shape[0]} lanes), depth {DEPTH}: "
             f"{frac:.5f} of lanes within 1e-3, mean diff {mean_rel:.2e}, max abs "
             f"{max_abs:.3e}, mean L {float(ref.mean()):.6f}, finite {finite}; plain "
             f"{plain_s:.2f} s")
    ok = ok and finite and frac > 0.98 and mean_rel < 1e-2

    ms = cs.cuda_ms(launch, args.reps, spin=True)
    cs.phase("flake-launch", f"#5 on {o.shape[0]} lanes: {ms:.4f} ms a launch (median of "
             f"{args.reps}, behind a sleeping kernel); {smi}")

    trace.enable()
    before = collections.Counter(_build.LAUNCHES)
    with trace.request() as req:
        img = render.render(scene, camera, settings, device=dev)
        torch.cuda.synchronize()
    trace.disable()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
    route = req.counter("li.route")
    stats = {name: req.total(name) for name in _build.STATS}
    occ = 100.0 * stats["steps"] / max(stats["warp_slots"], 1)
    cs.phase("flake-frame", f"li.route {route}; launches {launched}; counting instance: "
             f"{stats}, lane occupancy {occ:.2f}%; image mean {float(img.mean()):.6f}, "
             f"finite {bool(torch.isfinite(img).all())}")
    waves = HEIGHT // rows * SPP
    ok = (ok and route == {"bvh_megakernel": waves} and set(launched) <= {
        "mesh_megakernel", "camera_rays", "splat_rows"} and launched.get("mesh_megakernel") == waves)
    cs.phase("flake", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
