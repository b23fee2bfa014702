"""The mesh megakernel: the whole path trace of a triangle-mesh scene in
one CUDA kernel.

Counterpart of ``gopbrt_tpu/ops/pallas_mesh_megakernel.py``: the
per-material shade table (``_mat_shade_np``, here
``ops/megakernel.material_table``), the tables packed by the builder
(``mesh_tables``: the materials, made at build as in ``build_mesh_tables``,
and the lights, packed again for a scene whose lights changed, as the
reference packs them per call; the tree and the primitive records are
``Scene.bvh_tables``, made at build), and ``MESH``, the kernel's record:
``megakernel.make_launch`` launches ``csrc/mesh_megakernel.cu`` (the
bounce skeleton over the BVH walk) with it, the whole depth in one launch
per band, and ``megakernel.path_li_plain(accel="bvh")`` is its plain twin.

Left out of the port: the phase split and the octant x origin-cell
re-sort of the wavefront between bounces (pallas_mesh_megakernel.py
:1455-1516; per-lane results do not depend on them), the pixel/sample
bitcast packing, and the GOPBRT_MESH_* profiling switches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gopbrt_tpu_torch.ops import megakernel as mk
from gopbrt_tpu_torch.ops import packed

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


# the BVH instance, csrc/mesh_megakernel.cu: its own arguments are the
# tree's nodes, records and flags and the material count
MESH = mk.Kernel(
    mk.bounce_entry("mesh_megakernel", "gopbrt_mesh_li", "mesh_megakernel",
                    (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int)),
    tables_for, fits,
    "the mesh megakernel takes mesh fast-path scenes above 64 prims with a BVH", "bvh",
    lambda scene, mt: (scene.bvh_tables.nodes.data_ptr(), scene.bvh_tables.records.data_ptr(),
                       scene.bvh_tables.flags, mt.n_mats))
