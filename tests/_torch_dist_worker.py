"""Ranks of the port's multi-process tests, on gloo and the CPU.

``spawn(world, spec, tmp_path)`` starts ``world`` processes (the spawn start
method), each of which brings up a gloo group over a ``FileStore`` in
``tmp_path`` (so parallel test workers never share a port), builds its
mesh, runs the jobs of ``spec`` and saves what it saw to
``tmp_path/rank<r>.pt``; it returns those results, rank by rank.  A rank
that raises, or a run past ``timeout``, fails the call, and every process
is stopped.

This module imports only torch and the port, so the ranks never import JAX.

spec keys:
  mesh:    (data, sample)
  scene:   (arrays, infos) for ``scene_from_arrays``; camera: its arguments
  renders: {name: (settings kwargs, band_film)} through ``render_sharded``
  train:   {"settings": kwargs, "lr": float, "steps": int} -> the first
           step's averaged kd gradient and every step's loss (Adam on the
           materials' kd, toward a black target)
  service: {"requests": [RenderRequest kwargs]}: rank 0 asks, the other
           ranks follow
"""

from __future__ import annotations

import os
import time

import torch
import torch.multiprocessing as mp


def _camera(spec):
    from gopbrt_tpu_torch.models import camera as cam_mod
    from gopbrt_tpu_torch.ops import geom

    c = spec["camera"]
    return cam_mod.perspective_camera(geom.look_at(c["eye"], c["look"], c["up"]),
                                      c["width"], c["height"], fov_deg=c["fov"],
                                      device="cpu")


def _settings(kwargs):
    from gopbrt_tpu_torch.models import render
    from gopbrt_tpu_torch.ops import filters

    kwargs = dict(kwargs)
    if "filter" in kwargs:
        kwargs["filter"] = getattr(filters, kwargs["filter"][0])(*kwargs["filter"][1:])
    return render.RenderSettings(**kwargs)


def _rank(rank: int, world: int, store: str, out_dir: str, spec: dict) -> None:
    torch.set_num_threads(1)
    from gopbrt_tpu_torch.models.scene import scene_from_arrays
    from gopbrt_tpu_torch.parallel import shard

    assert shard.init_distributed(init_method=f"file://{store}", rank=rank,
                                  world_size=world, device="cpu")
    mesh = shard.make_mesh(*spec["mesh"], device="cpu")
    out = {"d_idx": mesh.d_idx, "s_idx": mesh.s_idx}
    if "service" in spec:
        from gopbrt_tpu_torch.service.proto import RenderRequest
        from gopbrt_tpu_torch.service.server import RenderService

        svc = RenderService(mesh=mesh, out_dir=out_dir)
        if rank == 0:
            for i, kw in enumerate(spec["service"]["requests"]):
                out[f"image{i}"] = svc.image(RenderRequest(**kw))
            out["path"] = svc.render(RenderRequest(**spec["service"]["requests"][0]),
                                     None).path
            svc.stop()
        else:
            svc.follow()
    if "scene" in spec:
        scene = scene_from_arrays(*spec["scene"], "cpu")
        camera = _camera(spec)
    for name, (kwargs, band_film) in spec.get("renders", {}).items():
        settings = _settings(kwargs)
        out[name] = shard.render_sharded(mesh, scene, camera, settings, band_film=band_film)
        out[name + "_band_rows"] = shard.new_band_film(mesh, settings).rgb.shape[0]
    if "train" in spec:
        t = spec["train"]
        settings = _settings(t["settings"])
        kd = scene.materials.kd.clone().requires_grad_(True)
        opt = torch.optim.Adam([kd], lr=t["lr"])
        step = shard.make_train_step(
            mesh, camera, settings,
            lambda p: scene._replace(materials=scene.materials._replace(kd=p)), opt)
        target = torch.zeros((settings.height, settings.width, 3))
        losses = []
        for k in range(t["steps"]):
            losses.append(float(step(kd, target)))
            if k == 0:
                out["grad"] = kd.grad.clone()
        out.update(losses=losses, kd=kd.detach().clone())
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def spawn(world: int, spec: dict, tmp_path, timeout: float = 240.0) -> list:
    """Run ``spec`` on ``world`` gloo ranks -> each rank's results."""
    out_dir = str(tmp_path)
    store = os.path.join(out_dir, "store")
    ctx = mp.start_processes(_rank, args=(world, store, out_dir, spec), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True)
            for r in range(world)]
