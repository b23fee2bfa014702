"""Rendering over several processes: row bands, sample sets, film reduction.

Counterpart of ``gopbrt_tpu/parallel/shard.py``.  The reference runs SPMD
over a ``jax.sharding.Mesh`` of devices with axes ``data`` (row bands of
the image) and ``sample`` (sets of samples); here each rank of a
``torch.distributed`` group is one cell of that mesh, rank r at
``(r // sample, r % sample)``, and the reference's ``psum`` / ``ppermute``
become collectives over the world and over two subgroups: the ranks that
share a band (the ``sample`` axis) and the ranks of one sample set, one per
band (the ``data`` axis).

  * ``render_pass_sharded``: the replicated film.  Each rank splats its
    band into a full-size film; one ``all_reduce`` over the world sums them.
  * ``render_pass_sharded_band``: the band film.  Each rank keeps only its
    band's rows; the band is summed over the ``sample`` group, and the
    filter's halo rows (ceil(radius) above and below) go to the data
    neighbours through an all-gather of the edge strips over the ``data``
    group (the reference's two ``ppermute``s; the edge ranks receive
    nothing).
  * ``make_train_step``: the data-parallel inverse-rendering step, the
    loss on the all-reduced film, the gradients averaged over the world.

The counter-based sampler keys on global pixel and sample ids, so any mesh
draws the same streams: a sharded render equals ``render`` up to the order
of the film's sums.  Each rank walks its band in waves of at most
``settings.chunk_pixels`` lanes, as ``render_pass`` does (the reference
traces a device's band in one wave; each lane's radiance is the same).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

from gopbrt_tpu_torch.models import camera as cam_mod
from gopbrt_tpu_torch.models import film as film_mod
from gopbrt_tpu_torch.models import render
from gopbrt_tpu_torch.parallel.dist import init_distributed, local_device  # noqa: F401
from gopbrt_tpu_torch.utils import trace


class Mesh(NamedTuple):
    """This rank's cell of the (data, sample) mesh and its process groups."""

    data: int
    sample: int
    rank: int
    device: torch.device
    # the ranks that share this rank's band, and the ranks of this rank's
    # sample set (one per band, in band order); None without a process group
    sample_group: Optional[object] = None
    data_group: Optional[object] = None

    @property
    def world(self) -> int:
        return self.data * self.sample

    @property
    def d_idx(self) -> int:
        return self.rank // self.sample

    @property
    def s_idx(self) -> int:
        return self.rank % self.sample

    @property
    def distributed(self) -> bool:
        return self.data_group is not None


def make_mesh(data: int = 0, sample: int = 1, device=None) -> Mesh:
    """This rank's cell of a (data, sample) mesh over the default process
    group (shard.py:38-46); ``data=0`` takes the world size over ``sample``.
    Without a process group the mesh is world 1.  The rank renders on
    ``device`` (None = the card, ``cuda:(local rank % device count)``);
    raises without a card unless ``device="cpu"``.

    Every rank of the group must call it with the same arguments: it makes
    the subgroups of both axes, as ``dist.new_group`` requires."""
    dev = local_device(device)
    world, rank = ((dist.get_world_size(), dist.get_rank()) if dist.is_initialized()
                   else (1, 0))
    if data == 0:
        data = world // sample
    if data * sample != world:
        raise ValueError(f"mesh {data}x{sample} != {world} ranks")
    if not dist.is_initialized():
        return Mesh(data, sample, rank, dev)
    mine = {}
    for d in range(data):  # the sample axis: the ranks of band d
        g = dist.new_group([d * sample + s for s in range(sample)])
        if d == rank // sample:
            mine["sample_group"] = g
    for s in range(sample):  # the data axis: sample set s, band by band
        g = dist.new_group([d * sample + s for d in range(data)])
        if s == rank % sample:
            mine["data_group"] = g
    return Mesh(data, sample, rank, dev, **mine)


def _band(mesh: Mesh, settings: render.RenderSettings):
    """(rows a band, this rank's first row, its end clipped to the image)."""
    band_rows = -(-settings.height // mesh.data)
    row0 = mesh.d_idx * band_rows
    return band_rows, row0, min(row0 + band_rows, settings.height)


def _chunks(settings: render.RenderSettings, start: int, end: int):
    """Row chunks of at most ``chunk_pixels`` pixels over rows [start, end),
    as ``render_pass`` cuts the image -> (first row, rows)."""
    w = settings.width
    chunk = settings.chunk_pixels or (w * settings.height)
    rows = max(1, min(chunk // w, settings.height))
    for r0 in range(start, end, rows):
        yield r0, min(rows, end - r0)


def _all_gather(mesh: Mesh, t: torch.Tensor) -> list:
    """``t`` of every rank of this rank's data group, in band order."""
    out = [torch.empty_like(t) for _ in range(mesh.data)]
    dist.all_gather(out, t.contiguous(), group=mesh.data_group)
    return out


def render_pass_sharded(mesh: Mesh, scene, camera: cam_mod.Camera, film: film_mod.Film,
                        settings: render.RenderSettings, sample_base: int) -> film_mod.Film:
    """One pass with the film replicated on every rank (shard.py:49-96):
    the rank renders its band for its ``samples_per_pass`` samples (sample
    ``sample_base + s_idx * samples_per_pass + s``) into a full-size film,
    the films are summed over the world and merged into ``film``."""
    _, row0, end = _band(mesh, settings)
    spp = settings.samples_per_pass
    local = film_mod.new_film(settings.width, settings.height, device=film.rgb.device)
    for r0, n in _chunks(settings, row0, end):
        for s in range(spp):
            render.render_wave_rows(scene, camera, local, settings, r0, n,
                                    sample_base + mesh.s_idx * spp + s)
    if mesh.distributed:
        dist.all_reduce(local.rgb)
        dist.all_reduce(local.weight)
    return film_mod.merge(film, local)


def render_pass_sharded_band(mesh: Mesh, scene, camera: cam_mod.Camera,
                             film: film_mod.Film, settings: render.RenderSettings,
                             sample_base: int) -> film_mod.Film:
    """One pass into this rank's band of the film (shard.py:99-181): the
    band's halo-extended taps (``film.splat_band_halo``) are summed over the
    sample group, the rr = ceil(radius) rows above and below the band go to
    the data neighbours, and the band's own rows fold into ``film`` (in
    place; returned)."""
    band_rows = film.weight.shape[0]
    if band_rows != -(-settings.height // mesh.data):
        raise ValueError("the film is not this mesh's band (new_band_film)")
    rr = int(math.ceil(settings.filter.radius))
    if mesh.data > 1 and rr > band_rows:
        raise ValueError(f"the filter's {rr} halo rows exceed a band of {band_rows}")
    _, row0, end = _band(mesh, settings)
    w, spp, dev = settings.width, settings.samples_per_pass, film.rgb.device
    acc_rgb = torch.zeros((band_rows + 2 * rr, w, 3), dtype=torch.float32, device=dev)
    acc_w = torch.zeros((band_rows + 2 * rr, w), dtype=torch.float32, device=dev)
    for r0, n in _chunks(settings, row0, end):
        for s in range(spp):
            jitter, L = render.band_jitter_radiance(scene, camera, settings, r0, n,
                                                    sample_base + mesh.s_idx * spp + s)
            with trace.span("render.splat"):
                r_, w_ = film_mod.splat_band_halo(r0, jitter, L, settings.height,
                                                  settings.filter)
                acc_rgb[r0 - row0:r0 - row0 + n + 2 * rr] += r_
                acc_w[r0 - row0:r0 - row0 + n + 2 * rr] += w_
    if mesh.distributed and mesh.sample > 1:
        dist.all_reduce(acc_rgb, group=mesh.sample_group)
        dist.all_reduce(acc_w, group=mesh.sample_group)
    core_rgb, core_w = acc_rgb[rr:rr + band_rows], acc_w[rr:rr + band_rows]
    if mesh.distributed and mesh.data > 1 and rr > 0:
        # the halo exchange: my top rr rows belong to the band before, my
        # bottom rr rows to the band after; the edge bands receive nothing
        acc = torch.cat([acc_rgb, acc_w[..., None]], dim=-1)
        edges = _all_gather(mesh, torch.stack([acc[:rr], acc[band_rows + rr:]]))
        d = mesh.d_idx
        if d > 0:
            core_rgb[:rr] += edges[d - 1][1, ..., :3]
            core_w[:rr] += edges[d - 1][1, ..., 3]
        if d < mesh.data - 1:
            core_rgb[band_rows - rr:] += edges[d + 1][0, ..., :3]
            core_w[band_rows - rr:] += edges[d + 1][0, ..., 3]
    film.rgb.add_(core_rgb)
    film.weight.add_(core_w)
    return film


def new_band_film(mesh: Mesh, settings: render.RenderSettings) -> film_mod.Film:
    """An empty film of this rank's band only, ceil(H / data) rows: the
    image's height padded to data x band rows (shard.py:183-192)."""
    band_rows = -(-settings.height // mesh.data)
    return film_mod.new_film(settings.width, band_rows, device=mesh.device)


def render_sharded(mesh: Mesh, scene, camera: cam_mod.Camera,
                   settings: render.RenderSettings, band_film: bool = True,
                   progress: Optional[Callable[[int, int], None]] = None) -> torch.Tensor:
    """The full render over the mesh (shard.py:194-231) -> the developed
    image f32[H,W,3] on every rank.  ``band_film`` keeps each rank's band
    of the film for the whole render and gathers the bands once at the
    end; False sums a replicated film every pass.  progress(done, total) is
    called after each pass, as ``render`` calls it.  The call is one
    request of the tracer (``utils/trace.request``)."""
    render._check_device("the scene", scene.device, mesh.device)
    render._check_device("the camera", camera.raster_to_camera.device, mesh.device)
    with trace.request():
        spp_per_pass = settings.samples_per_pass * mesh.sample
        n_passes = -(-settings.spp // spp_per_pass)
        if band_film:
            film = new_band_film(mesh, settings)
            pass_fn = render_pass_sharded_band
        else:
            film = film_mod.new_film(settings.width, settings.height, device=mesh.device)
            pass_fn = render_pass_sharded
        for p in range(n_passes):
            film = pass_fn(mesh, scene, camera, film, settings, p * spp_per_pass)
            if progress is not None:
                trace.synchronize(mesh.device)
                progress(p + 1, n_passes)
        if band_film:
            # gather the bands once, then crop the padding rows
            full = torch.cat([film.rgb, film.weight[..., None]], dim=-1)
            if mesh.distributed and mesh.data > 1:
                full = torch.cat(_all_gather(mesh, full))
            h = settings.height
            film = film_mod.Film(rgb=full[:h, :, :3], weight=full[:h, :, 3])
        return film_mod.develop(film)


def make_train_step(mesh: Mesh, camera: cam_mod.Camera, settings: render.RenderSettings,
                    param_to_scene: Callable, optimizer: torch.optim.Optimizer) -> Callable:
    """The data-parallel inverse-rendering step (shard.py:245-314) ->
    ``train_step(params, target) -> loss``.

    ``param_to_scene(params)`` splices the optimised tensors (those
    ``optimizer`` holds) into a scene.  Each rank renders its band's pixels
    for its ``samples_per_pass`` samples through ``render_wave`` (lanes in
    waves of at most ``chunk_pixels``), the films are summed over the world
    by a differentiable ``all_reduce``, and the loss is the MSE of the
    image against ``target`` f32[H,W,3].  Then ``backward``, the gradients'
    mean over the world, and ``optimizer.step()``; the averaged gradients
    stay in ``.grad``.

    The mean, not the sum: every rank takes the loss of the same summed
    film, and the all-reduce's backward sums the world's equal cotangents,
    so each rank's gradient is ``world`` times its lanes' share of the
    single-process gradient (the reference's over-count, shard.py:292-302).
    Compaction is off, as in the reference (shard.py:263).
    """
    settings = settings._replace(compaction=False)
    _, row0, end = _band(mesh, settings)
    w, h, spp, dev = settings.width, settings.height, settings.samples_per_pass, mesh.device
    pixels = torch.arange(row0 * w, end * w, device=dev)
    pixel = pixels.repeat(spp)
    sample = torch.arange(mesh.s_idx * spp, (mesh.s_idx + 1) * spp,
                          device=dev).repeat_interleave(pixels.numel())
    chunk = settings.chunk_pixels or max(pixel.numel(), 1)
    leaves = [p for g in optimizer.param_groups for p in g["params"]]

    def train_step(params, target: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad()
        scene = param_to_scene(params)
        film = film_mod.new_film(w, h, device=dev)
        for k in range(0, pixel.numel(), chunk):
            film = render.render_wave(scene, camera, film, settings, pixel[k:k + chunk],
                                      sample[k:k + chunk])
        rgb, weight = film.rgb, film.weight
        if mesh.distributed:
            rgb, weight = dist_fn.all_reduce(rgb), dist_fn.all_reduce(weight)
        img = rgb / torch.clamp(weight[..., None], min=1e-8)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        if mesh.distributed:
            for p in leaves:
                if p.grad is None:  # every rank runs the same collectives
                    p.grad = torch.zeros_like(p)
                dist.all_reduce(p.grad)
                p.grad /= mesh.world
        optimizer.step()
        return loss.detach()

    return train_step
