"""The mesh megakernel: the whole path trace of a triangle-mesh scene in
one CUDA kernel.

Counterpart of ``gopbrt_tpu/ops/pallas_mesh_megakernel.py``: the
per-material shade table (``_mat_shade_np``, here
``ops/megakernel.material_table``), the tables packed by the builder
(``mesh_tables``: the materials, made at build as in ``build_mesh_tables``,
and the lights, packed again for a scene whose lights changed, as the
reference packs them per call; the tree and the primitive records are
``Scene.bvh_tables``, made at build), and
``mesh_li_fused``.  On CUDA tensors ``mesh_li_fused`` launches
``csrc/mesh_megakernel.cu`` (the bounce skeleton over the BVH walk), the
whole depth in one launch per band; on CPU tensors it runs
``ops/megakernel.path_li_plain(accel="bvh")``.

Left out of the port: the phase split and the octant x origin-cell
re-sort of the wavefront between bounces (pallas_mesh_megakernel.py
:1455-1516; per-lane results do not depend on them), the pixel/sample
bitcast packing, and the GOPBRT_MESH_* profiling switches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gopbrt_tpu_torch import _build
from gopbrt_tpu_torch.ops import megakernel as mk
from gopbrt_tpu_torch.ops import packed
from gopbrt_tpu_torch.utils import trace

# Packed table layout read by csrc/mesh_megakernel.cu (struct MeshTables):
# the material rows, then the light tables of ops/megakernel.TABLE_LAYOUT.
MESH_TABLE_LAYOUT = (("mat", mk.MAX_MATS * mk.MAT_K),) + tuple(
    (name, words) for name, words in mk.TABLE_LAYOUT if name[0] == "l")
MESH_TABLE_WORDS = sum(n for _, n in MESH_TABLE_LAYOUT)


class MeshTables(NamedTuple):
    """What every launch for one scene reads besides the BVH tables, and
    the key of the scene tensors it was packed from (``ops/packed.py``)."""

    tables: torch.Tensor  # f32[MESH_TABLE_WORDS]
    mat: torch.Tensor  # f32[M, MAT_K]: the material rows, made at build
    n_mats: int
    func_int: float
    world_radius: float
    key: tuple


def fits(scene) -> bool:
    """Whether the kernel takes the scene: the mesh fast-path set, a BVH,
    more prims than the brute kernel takes (integrators.py:123-141,
    scene.py:669-690), 1..16 lights and at most MAX_MATS materials."""
    return (scene.fastinfo is not None and scene.fastinfo.mesh_ok
            and scene.bvh_tables is not None and scene.prims.count > mk.MAX_PRIMS
            and 1 <= scene.lights.count <= mk.MAX_LIGHTS
            and scene.materials.mat_type.shape[0] <= mk.MAX_MATS)


def _light_sources(scene) -> tuple:
    return packed.tensors(scene.lights, scene.light_func, scene.light_cdf) + \
        mk.scalar_sources(scene)


def mesh_tables(scene, old=None) -> MeshTables:
    """Packs the scene for the kernel; the builder does it once per scene.
    ``old``: earlier tables of the scene, whose material rows (made at
    build, as the reference's ``build_mesh_tables``,
    pallas_mesh_megakernel.py:317) and host scalars it keeps; the light
    rows are packed from the scene."""
    mat = mk.material_table(scene) if old is None else old.mat
    tables = mk.pack_layout({"mat": mat, **mk.light_parts(scene)}, MESH_TABLE_LAYOUT)
    return MeshTables(tables, mat, int(mat.shape[0]), *mk.host_scalars(scene, old),
                      packed.key(_light_sources(scene)))


def tables_for(scene) -> MeshTables:
    """What a launch on ``scene`` reads: ``scene.mesh`` while its lights were
    packed from the scene's tensors as they stand, else its material rows
    with the lights packed now (the reference packs them per call,
    pallas_mesh_megakernel.py:1346)."""
    mt = scene.mesh
    if mt is None:
        raise ValueError("the scene carries no packed mesh tables (SceneBuilder.build "
                         "and scene_from_arrays pack them)")
    if packed.holds(mt.key, _light_sources(scene)):
        return mt
    return mesh_tables(scene, mt)


_WHY = "the mesh megakernel takes mesh fast-path scenes above 64 prims with a BVH"


def make_launch(scene, o, d, pixel, sample, seed, cfg, cone, out):
    """Everything a CUDA launch needs, prepared once: returns a callable
    that launches the kernel on the current stream, writing radiance into
    ``out`` (f32[N,3], on the card), and counts the launch."""
    pixel, sample = mk.check_inputs(scene, o, d, pixel, sample, fits, _WHY)
    mk.check_cfg(cfg)
    mk.check_launch(o, d, out)
    mt, bt = tables_for(scene), scene.bvh_tables
    fn = _build.load("mesh_megakernel").gopbrt_mesh_li
    pix32, smp32 = mk.as_i32_bits(pixel), mk.as_i32_bits(sample)
    w0, sp = (0.0, 0.0) if cone is None else (float(cone[0]), float(cone[1]))
    args = (
        o.data_ptr(), d.data_ptr(), pix32.data_ptr(), smp32.data_ptr(),
        out.data_ptr(), o.shape[0], mt.tables.data_ptr(), MESH_TABLE_WORDS,
        bt.nodes.data_ptr(), bt.records.data_ptr(), bt.flags, mt.n_mats,
        scene.lights.count, int(seed) & 0xFFFFFFFF, mt.func_int, mt.world_radius, w0, sp,
        cfg.max_depth, cfg.rr_start_depth, float(cfg.rr_threshold),
        mk.kernel_flags(scene, cone is not None),
    )

    next_path = _build.counter(o.device)

    def launch(_keep=(o, d, mt.tables, bt.nodes, bt.records, pix32, smp32, out,
                      next_path)):
        # _keep holds the tensors behind the pointers in ``args``; after
        # trace.enable(), the counting instance runs on a counter of its own
        counting = trace.enabled()
        ctr = _build.counter(o.device) if counting else next_path
        err = fn(*args, torch.cuda.current_stream(o.device).cuda_stream, ctr.data_ptr(),
                 int(counting))
        if err != 0:
            raise RuntimeError(f"mesh megakernel launch failed: cudaError_t {err}")
        _build.LAUNCHES["mesh_megakernel"] += 1
        if counting:
            mk.count_stats("mesh_megakernel", ctr)
        return out

    return launch


def mesh_li_fused(scene, o, d, pixel, sample, seed, cfg, cone=None) -> torch.Tensor:
    """Drop-in for integrators.li on mesh fast-path scenes: radiance
    f32[N,3].  CUDA tensors launch csrc/mesh_megakernel.cu on the current
    stream; CPU tensors run ``path_li_plain(accel="bvh")``.  cone:
    optional (width0, spread) ray-cone floats enabling the checker box
    filter.  The result carries a gradient by path replay
    (``megakernel.replayed``, pallas_mesh_megakernel.py:1521-1556): the
    forward reads the build's material rows, the replay ``scene.materials``,
    as in the reference.  A cfg with nee or mis off raises
    (``megakernel.check_cfg``)."""
    mk.check_cfg(cfg)
    if o.device.type == "cpu":
        def run():
            p, s = mk.check_inputs(scene, o, d, pixel, sample, fits, _WHY)
            return mk.path_li_plain(scene, o, d, p, s, seed, cfg, cone=cone, accel="bvh")
    else:
        def run():
            out = torch.empty(o.shape, dtype=torch.float32, device=o.device)
            if o.shape[0] == 0:
                return out
            return make_launch(scene, o, d, pixel, sample, seed, cfg, cone, out)()
    return mk.replayed(run, scene, o, d, pixel, sample, seed, cfg, cone)
