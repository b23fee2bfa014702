"""Scene construction: a host-side builder producing device SoA tables.

Counterpart of ``gopbrt_tpu/models/scene.py``: ``Scene``, ``Materials`` and
the subset of ``SceneBuilder`` that the port runs — spheres, disks and
world-space triangles; matte (Lambert and Oren-Nayar, with an optional bump
texture), mirror, glass (smooth and rough), plastic, metal, subsurface (the
Burley BSSRDF) and null materials; constant, checkerboard (planar and uv
mapping), uv and image textures (one atlas, the images stacked vertically);
point, distant, and sphere- and disk-area lights under the uniform or the
power light distribution, or the spatial light grid (``LightGrid``, one
distribution per voxel); a global homogeneous medium (``set_medium``) or
bounded media (``add_medium``) with per-prim medium interfaces and the
camera's medium; two-keyframe motion of spheres and disks over the
shutter (``animate``: the decomposed keyframes in ``Primitives.anim``, the
BVH built over each moving prim's bounds across the shutter); triangle
meshes and the SAH BVH (``accelerator="bvh"``, built on the host by
``ops/bvh.build_from_bounds``).  The builder runs in NumPy on the host and
``build`` ends in ``torch.as_tensor(..., device=device)``.

``scene_from_arrays`` carries a scene across from tables given as NumPy
arrays, the tree included, so the tests render identical tables in both
packages.  It also packs the tables the kernels read: ``Scene.brute`` (the
brute intersection), ``Scene.kernel`` (the bounce megakernel),
``Scene.bvh_tables`` (the BVH walk) and ``Scene.mesh`` (the mesh
megakernel).  A launch reads ``brute``, ``kernel`` and the lights of
``mesh`` only while they were packed from the scene's tensors as they
stand, and packs them again otherwise (``ops/packed.py``), so a scene made
with ``_replace`` renders its own materials, lights and prims.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from gopbrt_tpu_torch import resolve_device
from gopbrt_tpu_torch.ops import bvh as bvh_ops
from gopbrt_tpu_torch.ops import lights as lights_ops
from gopbrt_tpu_torch.ops import brute_intersect, megakernel, mesh_megakernel, sampling
from gopbrt_tpu_torch.ops.bsdf import (GLASS, MATTE, METAL, MIRROR, NULLMAT, PLASTIC,
                                       SUBSURFACE)
from gopbrt_tpu_torch.ops.intersect import DISK, SPHERE, TRIANGLE, AnimPrims, Primitives
from gopbrt_tpu_torch.ops.media import HomogeneousMedium, MediaTable
from gopbrt_tpu_torch.ops.lights import (
    LIGHT_AREA,
    LIGHT_DISTANT,
    LIGHT_POINT,
    SHAPE_DISK,
    SHAPE_SPHERE,
    Lights,
)
from gopbrt_tpu_torch.ops.static_info import FastPathInfo, MatInfo, PrimInfo
from gopbrt_tpu_torch.ops.texture import (
    MAP_PLANAR,
    MAP_UV,
    TEX_CHECKERBOARD,
    TEX_CONSTANT,
    TEX_IMAGE,
    TEX_UV,
    Textures,
)


class Materials(NamedTuple):
    """SoA material table."""

    mat_type: torch.Tensor  # int32[M]
    kd: torch.Tensor  # f32[M,3]
    kd_tex: torch.Tensor  # int32[M]  texture id, -1 = constant kd
    sigma: torch.Tensor  # f32[M]
    kr: torch.Tensor  # f32[M,3]
    kt: torch.Tensor  # f32[M,3]
    eta: torch.Tensor  # f32[M]
    roughness: torch.Tensor  # f32[M] GGX alpha (remapped at build)
    info: Optional[MatInfo] = None
    # bump mapping: a texture perturbing the shading normal, -1 none; None
    # where no material has one
    bump_tex: Optional[torch.Tensor] = None  # int32[M]
    bump_scale: Optional[torch.Tensor] = None  # f32[M]
    # subsurface (ops/bssrdf.py): each channel's diffusion radius d = mfp /
    # s(rho), and the exit lobe's normalization c-bar; None where no
    # material is subsurface
    sss_d: Optional[torch.Tensor] = None  # f32[M,3]
    sss_cbar: Optional[torch.Tensor] = None  # f32[M]


class LightGrid(NamedTuple):
    """The spatial light distribution (the reference's unimplemented
    LightStrategy Spatial, lightdistribution.go:11-19; scene.py:75-86): a
    voxel grid over the scene's bounds with one distribution over the
    lights per voxel, estimated at build from distance-attenuated power."""

    lo: torch.Tensor  # f32[3] the grid's origin
    inv_extent: torch.Tensor  # f32[3] 1 / the world's extent
    dims: torch.Tensor  # int32[3] resolution
    func: torch.Tensor  # f32[V, L]
    cdf: torch.Tensor  # f32[V, L+1]
    func_int: torch.Tensor  # f32[V]


class Scene(NamedTuple):
    """The whole scene: tables plus the global light distribution."""

    prims: Primitives
    materials: Materials
    textures: Textures
    lights: Lights
    light_func: torch.Tensor  # f32[L]
    light_cdf: torch.Tensor  # f32[L+1]
    light_func_int: torch.Tensor  # f32[]
    world_center: torch.Tensor  # f32[3]
    world_radius: torch.Tensor  # f32[]
    fastinfo: Optional[FastPathInfo] = None
    # the primitive table packed for the brute intersection by the builder;
    # read through brute_intersect.scene_table, which packs again for
    # prims it was not packed from (ops/packed.py)
    brute: Optional[brute_intersect.BruteTable] = None
    # the megakernel's packed tables, where the scene fits it; read through
    # megakernel.tables_for, likewise
    kernel: Optional[megakernel.KernelTables] = None
    # the SAH BVH (accelerator="bvh" above 4 prims) packed for the walk,
    # made at build (as the reference's: a geometry edit does not reach it)
    bvh_tables: Optional[bvh_ops.BVHTable] = None
    # the mesh megakernel's packed tables, where the scene fits it: material
    # rows made at build (as the reference's), lights read through
    # mesh_megakernel.tables_for
    mesh: Optional[mesh_megakernel.MeshTables] = None
    # one global medium filling the scene (``set_medium``), or bounded media
    # (``add_medium``, with the prims' medium interfaces); each None where
    # the scene has none, and never both
    medium: Optional[HomogeneousMedium] = None
    media: Optional[MediaTable] = None
    # the row of ``media`` holding the camera, -1 vacuum
    camera_medium: int = -1
    # the spatial light distribution (light_strategy="spatial"), else None
    light_grid: Optional[LightGrid] = None

    @property
    def n_lights(self) -> int:
        return self.lights.count

    @property
    def bvh(self) -> Optional[bvh_ops.LinearBVH]:
        """The SAH BVH, or None where the scene has none."""
        return None if self.bvh_tables is None else self.bvh_tables.bvh

    @property
    def device(self) -> torch.device:
        return self.prims.params.device


# Array fields of a Scene, by table ("" = the Scene itself).  The keys of
# scene_to_arrays / scene_from_arrays are "<table>.<field>" or "<field>".
ARRAY_FIELDS = {
    "prims": ("prim_type", "obj_to_world", "world_to_obj", "params",
              "material_id", "area_light_id", "reverse_orientation"),
    "materials": ("mat_type", "kd", "kd_tex", "sigma", "kr", "kt", "eta",
                  "roughness"),
    "textures": ("tex_type", "value1", "value2", "mapping", "vs", "vt",
                 "dsdt", "atlas", "image_rect"),
    "lights": ("light_type", "p", "intensity", "two_sided", "prim_idx",
               "shape_kind", "o2w", "w2o", "params"),
    "": ("light_func", "light_cdf", "light_func_int", "world_center",
         "world_radius"),
    # only where the scene has a BVH, a global medium, bounded media, moving
    # prims, the spatial light grid
    "bvh": bvh_ops.LinearBVH._fields,
    "medium": HomogeneousMedium._fields,
    "media": MediaTable._fields,
    "prims.anim": AnimPrims._fields,
    "light_grid": LightGrid._fields,
}
OPTIONAL_GROUPS = ("bvh", "medium", "media", "prims.anim", "light_grid")
# fields of a table carried only where the table has them (not None)
OPTIONAL_FIELDS = {
    "prims": ("medium_inside", "medium_outside"),
    "materials": ("bump_tex", "bump_scale", "sss_d", "sss_cbar"),
}


def table_of(scene, name: str):
    """The table ``name`` of ARRAY_FIELDS ("" the scene, "prims.anim" a
    table's table), or None."""
    table = scene
    for part in filter(None, name.split(".")):
        table = None if table is None else getattr(table, part)
    return table


@dataclass
class SceneBuilder:
    """Accumulates primitives / materials / textures / lights, then builds."""

    # "uniform", "power" (lightdistribution.go:3-9) or "spatial" (the
    # voxel grid, ``spatial_resolution`` voxels a side)
    light_strategy: str = "uniform"
    spatial_resolution: int = 8

    _prim_type: list = field(default_factory=list)
    _o2w: list = field(default_factory=list)
    _params: list = field(default_factory=list)
    _mat_id: list = field(default_factory=list)
    _area_light: list = field(default_factory=list)
    _reverse: list = field(default_factory=list)
    _materials: list = field(default_factory=list)
    _textures: list = field(default_factory=list)
    _lights: list = field(default_factory=list)
    _medium: Optional[tuple] = None  # (sigma_a, sigma_s, g)
    _media: list = field(default_factory=list)  # bounded media rows
    _camera_medium: int = -1
    _medium_iface: dict = field(default_factory=dict)  # prim -> (inside, outside)
    _o2w_end: dict = field(default_factory=dict)  # prim -> its end keyframe

    # --- textures ---------------------------------------------------------

    def _add_texture(self, row) -> int:
        self._textures.append(row)
        return len(self._textures) - 1

    def constant_texture(self, rgb) -> int:
        return self._add_texture(
            dict(type=TEX_CONSTANT, v1=_rgb(rgb), v2=(0, 0, 0), mapping=MAP_UV,
                 vs=(1, 0, 0), vt=(0, 1, 0), dsdt=(0, 0), image=None)
        )

    def checkerboard_texture(
        self, tex1_rgb, tex2_rgb, vs=(1.0, 0, 0), vt=(0, 1.0, 0), ds=0.0,
        dt=0.0, mapping: str = "planar",
    ) -> int:
        """Checkerboard of two constant colours (checkerboard.go:15-40) with
        planar or uv mapping (texture.go:29-46)."""
        return self._add_texture(
            dict(type=TEX_CHECKERBOARD, v1=_rgb(tex1_rgb), v2=_rgb(tex2_rgb),
                 mapping=MAP_PLANAR if mapping == "planar" else MAP_UV,
                 vs=tuple(vs), vt=tuple(vt), dsdt=(ds, dt), image=None)
        )

    def uv_texture(self) -> int:
        """The (u, v) debug texture."""
        return self._add_texture(
            dict(type=TEX_UV, v1=(0, 0, 0), v2=(0, 0, 0), mapping=MAP_UV,
                 vs=(1, 0, 0), vt=(0, 1, 0), dsdt=(0, 0), image=None)
        )

    def image_texture(self, image, su=1.0, sv=1.0) -> int:
        """Image texture from an [H, W, 3] float array, uv-mapped with scales
        (su, sv) (scene.py:210-216)."""
        img = np.asarray(image, np.float32)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"an image texture is [H, W, 3], got {img.shape}")
        return self._add_texture(
            dict(type=TEX_IMAGE, v1=(0, 0, 0), v2=(0, 0, 0), mapping=MAP_UV,
                 vs=(su, 0, 0), vt=(0, sv, 0), dsdt=(0, 0), image=img)
        )

    # --- materials --------------------------------------------------------

    def _add_material(self, **kw) -> int:
        row = dict(
            mat_type=MATTE, kd=(0.5, 0.5, 0.5), kd_tex=-1, sigma=0.0,
            kr=(1.0, 1.0, 1.0), kt=(1.0, 1.0, 1.0), eta=1.5, roughness=0.0,
            bump_tex=-1, bump_scale=1.0, sss_d=(0.0, 0.0, 0.0),
        )
        row.update(kw)
        self._materials.append(row)
        return len(self._materials) - 1

    def matte(self, kd=(0.5, 0.5, 0.5), kd_tex: int = -1, sigma: float = 0.0,
              bump_tex: int = -1, bump_scale: float = 1.0) -> int:
        """Matte: Lambertian (sigma=0) or Oren-Nayar (matte.go:21-37);
        ``bump_tex`` >= 0 perturbs the shading normal by that texture's
        height times ``bump_scale`` (scene.py:232-236)."""
        return self._add_material(mat_type=MATTE, kd=_rgb(kd), kd_tex=kd_tex,
                                  sigma=sigma, bump_tex=bump_tex, bump_scale=bump_scale)

    def mirror(self, kr=(0.9, 0.9, 0.9)) -> int:
        """Perfect mirror (mirror.go:21-32)."""
        return self._add_material(mat_type=MIRROR, kr=_rgb(kr))

    def glass(self, kr=(1.0, 1.0, 1.0), kt=(1.0, 1.0, 1.0), eta=1.5,
              roughness=0.0, remap_roughness=True) -> int:
        """Glass (glass.go:27-75): smooth -> FresnelSpecular, rough -> GGX."""
        alpha = _remap(roughness) if (remap_roughness and roughness > 0) else roughness
        return self._add_material(mat_type=GLASS, kr=_rgb(kr), kt=_rgb(kt),
                                  eta=eta, roughness=alpha)

    def plastic(self, kd=(0.5, 0.5, 0.5), kd_tex=-1, ks=(0.25, 0.25, 0.25),
                roughness=0.1, remap_roughness=True) -> int:
        """Plastic: Lambert + GGX reflection (PBRT parity)."""
        alpha = _remap(roughness) if remap_roughness else roughness
        return self._add_material(mat_type=PLASTIC, kd=_rgb(kd), kd_tex=kd_tex,
                                  kr=_rgb(ks), eta=1.5, roughness=max(alpha, 1e-3))

    def metal(self, f0=(0.9, 0.6, 0.3), roughness=0.05, remap_roughness=True) -> int:
        """Metal: GGX reflection with a Schlick conductor Fresnel."""
        alpha = _remap(roughness) if remap_roughness else roughness
        return self._add_material(mat_type=METAL, kr=_rgb(f0),
                                  roughness=max(alpha, 1e-3))

    def subsurface(self, rho=(0.8, 0.5, 0.3), mfp=(0.2, 0.2, 0.2), eta=1.33) -> int:
        """Subsurface scattering: the Burley separable BSSRDF with diffuse
        albedo ``rho``, each channel's mean free path ``mfp`` (world units)
        and the interface's IOR ``eta`` (scene.py:265-280)."""
        from gopbrt_tpu_torch.ops.bssrdf import burley_scaling

        rho_t, mfp_t = _rgb(rho), _rgb(mfp)
        d = tuple(max(m, 1e-5) / float(burley_scaling(a)) for a, m in zip(rho_t, mfp_t))
        return self._add_material(mat_type=SUBSURFACE, kd=rho_t, eta=eta, sss_d=d)

    def null_material(self) -> int:
        """No BSDF: a pure medium boundary that rays pass through without
        a bounce (the reference's nil material, path.go:72-78)."""
        return self._add_material(mat_type=NULLMAT, kd=(0.0, 0.0, 0.0))

    # --- primitives -------------------------------------------------------

    def _add_prim(self, ptype, o2w, params, mat_id, reverse=False) -> int:
        self._prim_type.append(ptype)
        self._o2w.append(np.asarray(o2w, np.float32))
        p = np.zeros(9, np.float32)
        p[: len(params)] = params
        self._params.append(p)
        self._mat_id.append(mat_id)
        self._area_light.append(-1)
        self._reverse.append(bool(reverse))
        return len(self._prim_type) - 1

    def sphere(self, o2w, radius, material: int, z_min=None, z_max=None,
               phi_max_deg=360.0, reverse_orientation=False) -> int:
        """Sphere primitive (pbrt.NewSphereShape, sphere.go:189-228)."""
        z_min = -radius if z_min is None else z_min
        z_max = radius if z_max is None else z_max
        return self._add_prim(
            SPHERE, o2w, [radius, z_min, z_max, math.radians(phi_max_deg)],
            material, reverse_orientation,
        )

    def disk(self, o2w, radius, material: int, height=0.0, inner_radius=0.0,
             phi_max_deg=360.0, reverse_orientation=False) -> int:
        """Disk primitive (shapes.NewDisk, disk.go:17-40)."""
        return self._add_prim(
            DISK, o2w, [height, radius, inner_radius, math.radians(phi_max_deg)],
            material, reverse_orientation,
        )

    def triangle(self, p0, p1, p2, material: int, reverse_orientation=False) -> int:
        """Single world-space triangle (PBRT parity; the reference has none)."""
        return self._add_prim(TRIANGLE, np.eye(4, dtype=np.float32),
                              list(p0) + list(p1) + list(p2), material,
                              reverse_orientation)

    def triangle_mesh(self, o2w, vertices, indices, material: int,
                      reverse_orientation=False) -> list:
        """Triangle mesh: the vertices moved to world space at build, one
        triangle prim per face (scene.py:323-338)."""
        verts = np.asarray(vertices, np.float32)
        m = np.asarray(o2w, np.float32)
        verts = verts @ m[:3, :3].T + m[:3, 3]
        return [self.triangle(verts[a], verts[b], verts[c], material,
                              reverse_orientation)
                for a, b, c in np.asarray(indices, np.int64).reshape(-1, 3)]

    def animate(self, prim_id: int, o2w_end) -> None:
        """Two-keyframe motion: the prim moves from its build transform to
        ``o2w_end`` across the shutter ([0, 1] ray time; scene.py:340-350,
        primitive.go:82-129).  Camera rays get per-sample times
        (``render.camera_time``), and every intersection interpolates this
        prim's transform at its lane's time.  Spheres and disks only: a
        triangle's vertices are stored in world space."""
        if self._prim_type[prim_id] not in (SPHERE, DISK):
            raise ValueError("animated triangles are not supported (world-space vertices)")
        self._o2w_end[prim_id] = np.asarray(o2w_end, np.float32)

    # --- media ------------------------------------------------------------

    def set_medium(self, sigma_a, sigma_s=(0.0, 0.0, 0.0), g: float = 0.0) -> None:
        """A global homogeneous medium filling the scene (scene.py:355-363):
        Beer-Lambert attenuation on every path and shadow segment, HG
        in-scattering where sigma_s > 0."""
        self._medium = (_rgb(sigma_a), _rgb(sigma_s), float(g))

    def add_medium(self, sigma_a, sigma_s=(0.0, 0.0, 0.0), g: float = 0.0) -> int:
        """A bounded homogeneous medium; its id goes to
        ``set_medium_interface`` and ``set_camera_medium`` (scene.py:365-373)."""
        self._media.append((_rgb(sigma_a), _rgb(sigma_s), float(g)))
        return len(self._media) - 1

    def set_camera_medium(self, medium_id: int) -> None:
        """The medium holding the camera (-1 vacuum)."""
        self._camera_medium = int(medium_id)

    def set_medium_interface(self, prim_id: int, inside: int, outside: int = -1) -> None:
        """The media inside and outside a prim (-1 vacuum): with a null
        material a pure medium boundary, with glass a filled shell."""
        self._medium_iface[prim_id] = (int(inside), int(outside))

    # --- lights -----------------------------------------------------------

    def _add_light(self, **row) -> int:
        base = dict(two_sided=False, prim=-1, shape=SHAPE_SPHERE,
                    o2w=np.eye(4, dtype=np.float32),
                    params=np.zeros(9, np.float32))
        base.update(row)
        self._lights.append(base)
        return len(self._lights) - 1

    def point_light(self, p, intensity) -> int:
        """Point light (lights.NewPoint, point.go:19-42)."""
        return self._add_light(type=LIGHT_POINT, p=_rgb(p),
                               intensity=_rgb(intensity))

    def distant_light(self, direction, radiance) -> int:
        """Distant light; ``direction`` points toward the light."""
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        return self._add_light(type=LIGHT_DISTANT, p=tuple(d),
                               intensity=_rgb(radiance))

    def area_light(self, prim_id: int, radiance, two_sided=False) -> int:
        """Diffuse-area emission on an existing sphere or disk
        (diffuse.go:12-34, primitive.go:24-44)."""
        ptype = self._prim_type[prim_id]
        if ptype not in (SPHERE, DISK):
            raise ValueError("area lights need sphere or disk shapes")
        o2w = self._o2w[prim_id]
        lid = self._add_light(
            type=LIGHT_AREA, p=tuple(o2w[:3, 3]), intensity=_rgb(radiance),
            two_sided=bool(two_sided), prim=prim_id,
            shape=SHAPE_SPHERE if ptype == SPHERE else SHAPE_DISK,
            o2w=o2w, params=self._params[prim_id],
        )
        self._area_light[prim_id] = lid
        return lid

    # --- world bounds (host) ---------------------------------------------

    def _prim_world_bounds(self, i) -> tuple[np.ndarray, np.ndarray]:
        """World bounds of prim i; of a moving prim, the union of its bounds
        at 9 shutter times padded by 5% (scene.py:436-450, the role of
        AnimatedTransform.MotionBounds)."""
        if i in self._o2w_end:
            from gopbrt_tpu_torch.ops import quaternion as quat

            at = quat.animated_transform(self._o2w[i], self._o2w_end[i])
            los, his = zip(*[self._prim_world_bounds_static(i, quat.interpolate(at, t).numpy())
                             for t in np.linspace(0.0, 1.0, 9)])
            pad = 0.05 * (np.max(his, axis=0) - np.min(los, axis=0))
            return np.min(los, axis=0) - pad, np.max(his, axis=0) + pad
        return self._prim_world_bounds_static(i, self._o2w[i])

    def _prim_world_bounds_static(self, i, m) -> tuple[np.ndarray, np.ndarray]:
        pt = self._prim_type[i]
        pr = self._params[i]
        if pt == SPHERE:
            r = pr[0]
            lo, hi = np.array([-r, -r, pr[1]]), np.array([r, r, pr[2]])
        elif pt == DISK:
            r = pr[1]
            lo, hi = np.array([-r, -r, pr[0] - 1e-3]), np.array([r, r, pr[0] + 1e-3])
        else:
            v = pr.reshape(3, 3)
            return v.min(axis=0), v.max(axis=0)
        corners = np.array(
            [[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]], [lo[0], hi[1], lo[2]],
             [hi[0], hi[1], lo[2]], [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
             [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]]]
        )
        tc = corners @ m[:3, :3].T + m[:3, 3]
        return tc.min(axis=0), tc.max(axis=0)

    def world_bounds(self):
        los, his = zip(*[self._prim_world_bounds(i)
                         for i in range(len(self._prim_type))])
        return np.min(los, axis=0), np.max(his, axis=0)

    # --- build ------------------------------------------------------------

    def build(self, accelerator: str = "bvh", device=None) -> Scene:
        """Upload the tables to ``device`` (None = the card).  accelerator:
        "bvh" builds the SAH BVH where the scene has more than 4 prims
        (scene.py:664-668); "none" builds none.  Scenes above 64 prims
        intersect through the BVH when they have one, by brute force
        otherwise."""
        device = resolve_device(device)
        if accelerator not in ("bvh", "none"):
            raise ValueError(f"accelerator must be 'bvh' or 'none', got {accelerator!r}")
        n = len(self._prim_type)
        if n == 0:
            raise ValueError("empty scene")
        if self.light_strategy not in ("uniform", "power", "spatial"):
            raise ValueError(f"unknown light strategy {self.light_strategy!r}")
        if not self._materials:
            self.matte()
        if not self._textures:
            self.constant_texture((0.0, 0.0, 0.0))

        o2w = np.stack(self._o2w)
        w2o = np.linalg.inv(o2w.astype(np.float64)).astype(np.float32)
        ptypes = np.asarray(self._prim_type, np.int32)
        params = np.stack(self._params)
        two_pi = 2.0 * math.pi - 1e-6
        sph = params[ptypes == SPHERE]
        dsk = params[ptypes == DISK]
        pinfo = PrimInfo(
            types=tuple(sorted(set(int(t) for t in ptypes))),
            all_full_spheres=bool(
                sph.size == 0
                or np.all((sph[:, 1] <= -sph[:, 0]) & (sph[:, 2] >= sph[:, 0])
                          & (sph[:, 3] >= two_pi))
            ),
            all_full_disks=bool(
                dsk.size == 0
                or np.all((dsk[:, 2] <= 0.0) & (dsk[:, 3] >= two_pi))
            ),
        )
        glass_alphas = [m["roughness"] for m in self._materials
                        if m["mat_type"] == GLASS]
        mat_types = set(m["mat_type"] for m in self._materials)
        if SUBSURFACE in mat_types:
            # the BSSRDF's entry turns Fresnel-reflected lanes into unit
            # mirrors (integrators._subsurface_transport)
            mat_types.add(MIRROR)
        if self._medium is not None or self._media:
            # medium vertices ride the wavefront as MATTE lanes
            mat_types.add(MATTE)
        minfo = MatInfo(
            mat_types=tuple(sorted(mat_types)),
            any_rough_glass=any(a > 1e-4 for a in glass_alphas),
            any_smooth_glass=any(a <= 1e-4 for a in glass_alphas),
            any_oren_nayar=any(m["mat_type"] == MATTE and m["sigma"] > 0.0
                               for m in self._materials),
        )
        mats, texs, lights = self._materials, self._textures, self._lights
        if not lights:
            # one dark point light keeps the table shapes static
            lights = [dict(type=LIGHT_POINT, p=(0, 0, 0), intensity=(0, 0, 0),
                           two_sided=False, prim=-1, shape=SHAPE_SPHERE,
                           o2w=np.eye(4, dtype=np.float32),
                           params=np.zeros(9, np.float32))]
        l_o2w = np.stack([r["o2w"] for r in lights])
        lo, hi = self.world_bounds()
        center = 0.5 * (lo + hi)
        radius = float(np.linalg.norm(hi - center))
        arrays = {
            "prims.prim_type": ptypes,
            "prims.obj_to_world": o2w,
            "prims.world_to_obj": w2o,
            "prims.params": params,
            "prims.material_id": np.asarray(self._mat_id, np.int32),
            "prims.area_light_id": np.asarray(self._area_light, np.int32),
            "prims.reverse_orientation": np.asarray(self._reverse, bool),
            "materials.mat_type": [m["mat_type"] for m in mats],
            "materials.kd": [m["kd"] for m in mats],
            "materials.kd_tex": [m["kd_tex"] for m in mats],
            "materials.sigma": [m["sigma"] for m in mats],
            "materials.kr": [m["kr"] for m in mats],
            "materials.kt": [m["kt"] for m in mats],
            "materials.eta": [m["eta"] for m in mats],
            "materials.roughness": [m["roughness"] for m in mats],
            "textures.tex_type": [r["type"] for r in texs],
            "textures.value1": [r["v1"] for r in texs],
            "textures.value2": [r["v2"] for r in texs],
            "textures.mapping": [r["mapping"] for r in texs],
            "textures.vs": [r["vs"] for r in texs],
            "textures.vt": [r["vt"] for r in texs],
            "textures.dsdt": [r["dsdt"] for r in texs],
            **_atlas(texs),
            "lights.light_type": [r["type"] for r in lights],
            "lights.p": [r["p"] for r in lights],
            "lights.intensity": [r["intensity"] for r in lights],
            "lights.two_sided": np.asarray([r["two_sided"] for r in lights], bool),
            "lights.prim_idx": [r["prim"] for r in lights],
            "lights.shape_kind": [r["shape"] for r in lights],
            "lights.o2w": l_o2w,
            "lights.w2o": np.linalg.inv(l_o2w.astype(np.float64)).astype(np.float32),
            "lights.params": np.stack([r["params"] for r in lights]),
            "world_center": center,
            "world_radius": radius,
            **self._feature_arrays(n),
        }
        # the light distribution (lightdistribution.go:3-9, 46-68)
        if self.light_strategy == "power" and self._lights:
            table = {k.split(".", 1)[1]: _as_table(arrays[k], "cpu")
                     for k in arrays if k.startswith("lights.")}
            weights = lights_ops.power(Lights(**table), radius)
        else:
            weights = torch.ones((len(lights),), dtype=torch.float32)
        lf, lcdf, lint = sampling.distribution_1d(weights)
        arrays.update(light_func=lf.numpy(), light_cdf=lcdf.numpy(),
                      light_func_int=lint.numpy())
        if self.light_strategy == "spatial" and self._lights:
            arrays.update(self._light_grid_arrays(lo, hi))
        if self._o2w_end:
            arrays.update(self._anim_arrays(o2w))
        infos = dict(pinfo=asdict(pinfo), minfo=asdict(minfo),
                     fastinfo=asdict(self._fast_path_info(o2w)),
                     camera_medium=self._camera_medium)
        if accelerator == "bvh" and n > 4:
            tree, backend, _, ms = bvh_ops.build_timed(*bvh_ops._prim_bounds_np(self))
            arrays.update({f"bvh.{f}": getattr(tree, f).numpy() for f in tree._fields})
            infos["bvh_build"] = {"backend": backend, "build_ms": ms}
        return scene_from_arrays(arrays, infos, device)

    def _light_grid_arrays(self, wlo: np.ndarray, whi: np.ndarray) -> dict:
        """The spatial light grid (scene.py:836-890): per voxel v and light l
        the weight lum(power_l) / max(d(v, l)^2, r_v^2), distant lights
        independent of distance, floored at 0.1% of the voxel's largest so
        every light stays sampleable; keyed ``light_grid.*``."""
        g = int(self.spatial_resolution)
        extent = np.maximum(whi - wlo, 1e-6)
        centers = np.stack(np.meshgrid(
            *(wlo[k] + (np.arange(g) + 0.5) / g * extent[k] for k in range(3)),
            indexing="ij"), axis=-1).reshape(-1, 3)
        w = np.zeros((centers.shape[0], len(self._lights)), np.float32)
        r_v2 = float(np.sum((0.5 * extent / g) ** 2))
        for li, row in enumerate(self._lights):
            inten = float(np.mean(row["intensity"]))
            if row["type"] == LIGHT_DISTANT:
                w[:, li] = inten
                continue
            if row["type"] == LIGHT_AREA:
                # the emitter's power, L * area * pi
                pr = row["params"]
                scale = float(np.linalg.norm(row["o2w"][:3, 0]))
                if row["shape"] == SHAPE_DISK:
                    area = pr[3] * 0.5 * (pr[1] ** 2 - pr[2] ** 2) * scale * scale
                else:
                    area = 4.0 * math.pi * (pr[0] * scale) ** 2
                inten = inten * float(area) * math.pi
            else:
                inten = inten * 4.0 * math.pi
            d2 = np.sum((centers - np.asarray(row["p"])) ** 2, axis=-1)
            w[:, li] = inten / np.maximum(d2, r_v2)
        w = np.maximum(w, 1e-3 * w.max(axis=-1, keepdims=True))
        func, cdf, func_int = sampling.distribution_1d(torch.as_tensor(w))
        return {"light_grid.lo": np.asarray(wlo, np.float32),
                "light_grid.inv_extent": np.asarray(1.0 / extent, np.float32),
                "light_grid.dims": np.asarray([g, g, g], np.int32),
                "light_grid.func": func.numpy(), "light_grid.cdf": cdf.numpy(),
                "light_grid.func_int": func_int.numpy()}

    def _anim_arrays(self, o2w: np.ndarray) -> dict:
        """The two-keyframe table (scene.py:511-535): each prim's keyframes
        decomposed (static prims carry equal ones), the end rotation
        sign-aligned to the start's; keyed ``prims.anim.*``."""
        from gopbrt_tpu_torch.ops import quaternion as quat

        n = o2w.shape[0]
        end = np.stack([self._o2w_end.get(i, o2w[i]) for i in range(n)]).astype(np.float32)
        t0, q0, s0 = quat.decompose(torch.as_tensor(o2w))
        t1, q1, s1 = quat.decompose(torch.as_tensor(end))
        q1 = torch.where((torch.sum(q0 * q1, dim=-1) < 0.0)[:, None], -q1, q1)
        rows = dict(t0=t0, t1=t1, q0=q0, q1=q1, s0=s0, s1=s1)
        out = {f"prims.anim.{k}": v.numpy() for k, v in rows.items()}
        out["prims.anim.animated"] = np.any(np.abs(end - o2w) > 1e-7, axis=(1, 2))
        return out

    def _feature_arrays(self, n: int) -> dict:
        """The optional tables of bump mapping, subsurface materials, medium
        interfaces and media (scene.py:535-555, 592-611, 624-641), keyed as
        ``ARRAY_FIELDS`` / ``OPTIONAL_FIELDS``; only those the scene uses."""
        mats, out = self._materials, {}
        if any(m["bump_tex"] >= 0 for m in mats):
            out["materials.bump_tex"] = [m["bump_tex"] for m in mats]
            out["materials.bump_scale"] = [m["bump_scale"] for m in mats]
        if any(m["mat_type"] == SUBSURFACE for m in mats):
            from gopbrt_tpu_torch.ops.bssrdf import sw_normalization

            out["materials.sss_d"] = [m["sss_d"] for m in mats]
            out["materials.sss_cbar"] = sw_normalization(
                torch.tensor([m["eta"] for m in mats], dtype=torch.float32)).numpy()
        if self._medium_iface:
            # -2: no transition (a prim without an interface keeps the ray's
            # medium)
            mi, mo = np.full((n,), -2, np.int32), np.full((n,), -2, np.int32)
            for pid, (i_in, i_out) in self._medium_iface.items():
                mi[pid], mo[pid] = i_in, i_out
            out.update({"prims.medium_inside": mi, "prims.medium_outside": mo})
        if self._media and self._medium is not None:
            raise ValueError("bounded media (add_medium) and the global medium "
                             "(set_medium) are mutually exclusive")
        if self._medium is not None:
            out.update({f"medium.{f}": np.asarray(v, np.float32)
                        for f, v in zip(HomogeneousMedium._fields, self._medium)})
        elif self._media:
            out.update({f"media.{f}": np.asarray([r[k] for r in self._media], np.float32)
                        for k, f in enumerate(MediaTable._fields)})
        return out

    def _fast_path_info(self, o2w: np.ndarray) -> FastPathInfo:
        """Eligibility for the bounce megakernel (scene.py:749-830); see
        static_info.FastPathInfo for the closed feature set."""
        common = True
        for m in self._materials:
            if m["bump_tex"] >= 0:
                common = False
            if m["mat_type"] == MATTE and m["sigma"] != 0.0:
                common = False
            t = m["kd_tex"]
            if t >= 0:
                row = self._textures[t]
                if not (row["type"] == TEX_CONSTANT
                        or (row["type"] == TEX_CHECKERBOARD
                            and row["mapping"] == MAP_PLANAR)):
                    common = False
        if not (1 <= len(self._lights) <= 16) or self.light_strategy == "spatial":
            common = False
        for r in self._lights:
            if r["type"] == LIGHT_AREA and r["shape"] != SHAPE_SPHERE:
                common = False
        if self._medium is not None or any(self._reverse) or self._o2w_end:
            common = False
        # bounded media and null boundaries: the general chain only
        if self._media or self._medium_iface or any(
                m["mat_type"] == NULLMAT for m in self._materials):
            common = False
        lin = np.asarray(o2w, np.float64)[:, :3, :3]
        gram = np.einsum("pij,pkj->pik", lin, lin)
        scale2 = np.maximum(np.einsum("pii->p", gram) / 3.0, 1e-30)
        if not (np.all(np.linalg.det(lin) > 0.0)
                and np.allclose(gram / scale2[:, None, None], np.eye(3)[None],
                                atol=1e-4)):
            common = False

        ok = common
        if any(t not in (SPHERE, DISK) for t in self._prim_type):
            ok = False
        if any(m["mat_type"] not in (MATTE, MIRROR, GLASS) for m in self._materials):
            ok = False
        has_rough_glass = any(m["mat_type"] == GLASS and m["roughness"] > 1e-4
                              for m in self._materials)
        # every prim sits in the one BVH, so the mesh megakernel takes any
        # mix of triangles, spheres and disks
        mesh_ok = common and len(self._materials) <= 16 and not has_rough_glass
        if any(m["mat_type"] not in (MATTE, MIRROR, GLASS, PLASTIC)
               for m in self._materials):
            mesh_ok = False
        has_glass = any(m["mat_type"] == GLASS and m["roughness"] <= 1e-4
                        for m in self._materials)
        return FastPathInfo(ok=ok, mesh_ok=mesh_ok, has_glass=has_glass,
                            has_rough_glass=has_rough_glass)


def _atlas(texs: list) -> dict:
    """The images of the texture rows stacked vertically into one atlas,
    and each row's window (y0, x0, h, w) in it; (0, 0, 1, 1) and a 1x1 black
    atlas where there are none (scene.py:693-725)."""
    images = [r["image"] for r in texs if r["image"] is not None]
    if not images:
        return {"textures.atlas": np.zeros((1, 1, 3), np.float32),
                "textures.image_rect": [(0, 0, 1, 1)] * len(texs)}
    atlas = np.zeros((sum(im.shape[0] for im in images),
                      max(im.shape[1] for im in images), 3), np.float32)
    rects, y = [], 0
    for r in texs:
        im = r["image"]
        if im is None:
            rects.append((0, 0, 1, 1))
            continue
        atlas[y:y + im.shape[0], :im.shape[1]] = im
        rects.append((y, 0, im.shape[0], im.shape[1]))
        y += im.shape[0]
    return {"textures.atlas": atlas, "textures.image_rect": rects}


def _as_table(value, device) -> torch.Tensor:
    a = np.array(value)  # a writable copy
    if a.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dtype = torch.int32
    else:
        dtype = torch.float32
    return torch.as_tensor(a, dtype=dtype, device=device)


def scene_from_arrays(arrays: dict, infos: dict, device=None) -> Scene:
    """Build a Scene from NumPy tables keyed as in ``ARRAY_FIELDS``.

    infos: {"pinfo": {...}, "minfo": {...}, "fastinfo": {...}} — the field
    values of PrimInfo, MatInfo and FastPathInfo as plain dicts — the
    camera's medium ("camera_medium", -1 where absent) and, where the
    builder built the tree, "bvh_build": {"backend", "build_ms"}.
    """
    device = resolve_device(device)

    def group(name):
        fields = ARRAY_FIELDS[name] + tuple(f for f in OPTIONAL_FIELDS.get(name, ())
                                            if f"{name}.{f}" in arrays)
        return {f: _as_table(arrays[f"{name}.{f}"], device) for f in fields}

    def optional(cls, name):
        return cls(**group(name)) if f"{name}.{cls._fields[0]}" in arrays else None

    pinfo = PrimInfo(**{**infos["pinfo"], "types": tuple(infos["pinfo"]["types"])})
    minfo = MatInfo(**{**infos["minfo"],
                       "mat_types": tuple(infos["minfo"]["mat_types"])})
    top = {f: _as_table(arrays[f], device) for f in ARRAY_FIELDS[""]}
    scene = Scene(
        prims=Primitives(**group("prims"), pinfo=pinfo, anim=optional(AnimPrims, "prims.anim")),
        materials=Materials(**group("materials"), info=minfo),
        textures=Textures(**group("textures"), has_image=TEX_IMAGE in np.asarray(
            arrays["textures.tex_type"]).tolist()),
        lights=Lights(**group("lights")),
        fastinfo=FastPathInfo(**infos["fastinfo"]),
        medium=optional(HomogeneousMedium, "medium"),
        media=optional(MediaTable, "media"),
        camera_medium=int(infos.get("camera_medium", -1)),
        light_grid=optional(LightGrid, "light_grid"),
        **top,
    )
    scene = scene._replace(brute=brute_intersect.brute_table(scene.prims))
    if megakernel.fits(scene):
        scene = scene._replace(kernel=megakernel.kernel_tables(scene))
    if "bvh.node_lo" in arrays:
        tree = bvh_ops.LinearBVH(**group("bvh"))
        scene = scene._replace(bvh_tables=bvh_ops.bvh_table(tree, scene.prims,
                                                            **infos.get("bvh_build", {})))
        if mesh_megakernel.fits(scene):
            scene = scene._replace(mesh=mesh_megakernel.mesh_tables(scene))
    return scene


def scene_to_arrays(scene: Scene) -> dict:
    """The Scene's tables as NumPy arrays, keyed as in ``ARRAY_FIELDS``; an
    optional group only where the scene has it."""
    out = {}
    for name, fields in ARRAY_FIELDS.items():
        table = table_of(scene, name)
        if table is None and name in OPTIONAL_GROUPS:
            continue
        for f in fields + OPTIONAL_FIELDS.get(name, ()):
            v = getattr(table, f)
            if v is not None:
                out[f"{name}.{f}" if name else f] = v.cpu().numpy()
    return out


def _rgb(v) -> tuple:
    if isinstance(v, (int, float)):
        return (float(v),) * 3
    v = tuple(float(x) for x in v)
    if len(v) != 3:
        raise ValueError(f"expected an RGB triple, got {v}")
    return v


def _remap(roughness: float) -> float:
    """Host-side RoughnessToAlpha (microfacet.go:186-190)."""
    x = math.log(max(roughness, 1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x**3
            + 0.000640711 * x**4)
