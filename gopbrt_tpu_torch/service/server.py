"""gRPC render daemon: the service and process layer of the port.

Counterpart of ``gopbrt_tpu/service/server.py``:
  * the RPC handler (``internal/render/server.go:29-172``): a request's
    scene from a registry built once per id, rendered by the path tracer,
    written as a PNG;
  * the daemon (``cmd/pbrtd/main.go:16-38``): listen on :3001, register the
    service and server reflection (service/reflection.py), shut down on
    SIGINT / SIGTERM.

As in the reference: ``scene_id`` selects demo, cornell (BASELINE config 2),
mesh (config 3) or glass (config 4), and here also sphereflake (Haines'
SPD ``balls``, ``models/spd.py``), an unknown id the demo; the request's
``time`` pins the camera shutter to that instant; the superset fields
``spp`` (default 16) and ``max_depth`` set the sampling and ``seed`` the
render's seed (default 0); an empty request is the reference's demo
request, 1920x1080, 16 spp, path depth 10.  The PNG's name carries the
request's number after the time stamp, so two requests in one second write
two files.  A call is one request of the tracer (``utils/trace``): the
render's spans, then ``service.png``, the PNG's encoding and write.

More than one rank (``torchrun``): rank 0 serves; it broadcasts each
request's bytes to the other ranks, which wait in ``follow()``, and all of
them run ``shard.render_sharded``.  With one rank the handler calls
``render.render``.

Importing this module imports neither grpc nor protobuf: ``make_server``
and ``main`` import them, so the handler runs where they are not installed.
"""

from __future__ import annotations

import os
import signal
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from gopbrt_tpu_torch.models import film, gallery, render
from gopbrt_tpu_torch.models.demo import build_demo_camera, build_demo_scene, demo_settings
from gopbrt_tpu_torch.models.meshes import mesh_camera
from gopbrt_tpu_torch.models.spd import build_sphereflake_scene, sphereflake_camera
from gopbrt_tpu_torch.parallel import shard
from gopbrt_tpu_torch.parallel.dist import local_device
from gopbrt_tpu_torch.service.proto import RenderRequest, RenderResponse
from gopbrt_tpu_torch.utils import trace

SERVICE_NAME = "render.Render"
DEFAULT_PORT = 3001


class RenderService:
    """The Render/Render RPC (server.go:29-172), on ``device`` (None = the
    card; raises without one) or on the ranks of ``mesh``."""

    def __init__(self, device=None, mesh=None, out_dir: str = "build"):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else local_device(device)
        self.out_dir = out_dir
        self._scenes = {}
        self._lock = threading.Lock()  # the scene registry and the file count
        self._serve = threading.Lock()  # one request at a time across the ranks
        self._count = 0

    @property
    def _multi(self) -> bool:
        return self.mesh is not None and self.mesh.world > 1

    def _build_scene(self, scene_id: str):
        """The scene registry: id -> scene (the BASELINE gallery, the SPD
        sphereflake; "demo", and any id not listed, is the reference's
        hard-coded scene)."""
        builders = {"cornell": gallery.config2, "mesh": gallery.config3,
                    "glass": gallery.config4}
        if scene_id in builders:
            return builders[scene_id](device=self.device)[0]
        if scene_id == "sphereflake":
            return build_sphereflake_scene(device=self.device)
        return build_demo_scene(device=self.device)

    def _get_scene(self, scene_id: str):
        with self._lock:
            if scene_id not in self._scenes:
                self._scenes[scene_id] = self._build_scene(scene_id)
            return self._scenes[scene_id]

    def job(self, request: RenderRequest):
        """The request's (scene, camera, settings)."""
        width = request.width or 1920
        height = request.height or 1080
        scene_id = request.scene_id or "demo"
        scene = self._get_scene(scene_id)
        if scene_id == "cornell":
            camera = gallery.config2(width, height, device=self.device)[1]
        elif scene_id == "mesh":
            camera = mesh_camera(width, height, device=self.device)
        elif scene_id == "glass":
            camera = gallery.config4(width, height, device=self.device)[1]
        elif scene_id == "sphereflake":
            camera = sphereflake_camera(width, height, device=self.device)
        else:
            camera = build_demo_camera(width, height, device=self.device)
        if request.time:
            # the request's animation time (service.proto:11, ignored by
            # the reference daemon): the shutter pinned to that instant
            t = float(np.float32(min(max(request.time, 0.0), 1.0)))
            camera = camera._replace(shutter_open=t, shutter_close=t)
        settings = demo_settings(width=width, height=height, spp=request.spp or 16,
                                 seed=int(request.seed))
        if request.max_depth:
            settings = settings._replace(max_depth=int(request.max_depth))
        return scene, camera, settings

    def _render(self, request: RenderRequest) -> torch.Tensor:
        scene, camera, settings = self.job(request)
        if self._multi:
            return shard.render_sharded(self.mesh, scene, camera, settings)
        return render.render(scene, camera, settings, device=self.device)

    def image(self, request: RenderRequest) -> torch.Tensor:
        """The request's developed image f32[H,W,3]; on rank 0 of a mesh,
        with the other ranks (``follow``) rendering their shares."""
        if not self._multi:
            return self._render(request)
        with self._serve:
            self._broadcast(request.SerializeToString())
            return self._render(request)

    def render(self, request: RenderRequest, context) -> RenderResponse:
        return self.render_image(request)[0]

    def render_image(self, request: RenderRequest) -> tuple[RenderResponse, torch.Tensor]:
        """The RPC's work -> (its response, the developed image f32[H,W,3]
        that the response's PNG was written from)."""
        with trace.request():
            img = self.image(request)
            with self._lock:
                self._count += 1
                name = f"render-{time.strftime('%Y-%m-%dT%H:%M:%S')}-{self._count:04d}.png"
            os.makedirs(self.out_dir, exist_ok=True)
            with trace.span("service.png"):
                path = film.write_png(os.path.join(self.out_dir, name), img)
        return RenderResponse(path=path), img

    def follow(self) -> None:
        """Ranks other than 0: render each request rank 0 broadcasts, until
        it sends the stop (``stop``)."""
        while (buf := self._broadcast(None)) is not None:
            self._render(RenderRequest.FromString(buf))

    def stop(self) -> None:
        """Rank 0: release the ranks waiting in ``follow``."""
        if self._multi:
            with self._serve:
                self._broadcast(None)

    def _broadcast(self, payload):
        """Rank 0's ``payload`` (bytes; None = stop) on every rank of the
        mesh: its length, then its bytes, broadcast on the mesh's device."""
        dev = self.device
        n = torch.tensor([-1 if payload is None else len(payload)], dtype=torch.int64,
                         device=dev)
        dist.broadcast(n, src=0)
        size = int(n.item())
        if size < 0:
            return None
        if payload:
            buf = torch.tensor(list(payload), dtype=torch.uint8, device=dev)
        else:
            buf = torch.empty((size,), dtype=torch.uint8, device=dev)
        if size:
            dist.broadcast(buf, src=0)
        return bytes(buf.cpu().numpy())


def make_server(port: int = DEFAULT_PORT, service: RenderService | None = None):
    """A grpc server with the Render service and reflection on ``port``."""
    from concurrent import futures

    import grpc

    from gopbrt_tpu_torch.service.reflection import reflection_handlers

    service = service or RenderService()
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    rpc = grpc.unary_unary_rpc_method_handler(
        service.render,
        request_deserializer=RenderRequest.FromString,
        response_serializer=RenderResponse.SerializeToString,
    )
    handler = grpc.method_handlers_generic_handler(SERVICE_NAME, {"Render": rpc})
    server.add_generic_rpc_handlers((handler, *reflection_handlers([SERVICE_NAME])))
    server.add_insecure_port(f"[::]:{port}")
    return server


def main(port: int = DEFAULT_PORT) -> None:
    """The daemon (cmd/pbrtd/main.go): serve on the card until SIGINT /
    SIGTERM.  Under ``torchrun`` every rank joins the mesh; rank 0 serves."""
    mesh = shard.make_mesh() if shard.init_distributed() else None
    service = RenderService(mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        service.follow()
        return
    server = make_server(port, service)
    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    server.start()
    print(f"pbrtd listening on :{port} ({mesh.world if mesh else 1} rank(s) on "
          f"{service.device})", flush=True)
    stop.wait()
    server.stop(grace=5).wait()
    service.stop()
    print("shutdown complete", flush=True)


if __name__ == "__main__":
    main(int(os.environ.get("PBRTD_PORT", DEFAULT_PORT)))
