"""Scene construction: a host-side builder producing device SoA tables.

Counterpart of ``gopbrt_tpu/models/scene.py``: ``Scene``, ``Materials`` and
the subset of ``SceneBuilder`` that the port runs — spheres, disks and
world-space triangles; matte (Lambert and Oren-Nayar), mirror, glass
(smooth and rough), plastic and metal; constant, checkerboard (planar and
uv mapping) and uv textures; point, distant, and sphere- and disk-area
lights under the uniform or the power light distribution; triangle meshes
and the SAH BVH (``accelerator="bvh"``, built on the host by
``ops/bvh.build_from_bounds``).  The builder runs in NumPy on the host and
``build`` ends in ``torch.as_tensor(..., device=device)``.  Image textures,
bump mapping, subsurface and null materials, media, animation and the
spatial light grid raise ``NotImplementedError`` naming their ROADMAP item.

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
from gopbrt_tpu_torch.ops.bsdf import GLASS, MATTE, METAL, MIRROR, NULLMAT, PLASTIC
from gopbrt_tpu_torch.ops.intersect import DISK, SPHERE, TRIANGLE, Primitives
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
    # only where the scene has a BVH
    "bvh": bvh_ops.LinearBVH._fields,
}
OPTIONAL_GROUPS = ("bvh",)


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to gopbrt_tpu_torch yet (ROADMAP {item})"
    )


@dataclass
class SceneBuilder:
    """Accumulates primitives / materials / textures / lights, then builds."""

    light_strategy: str = "uniform"  # or "power" (lightdistribution.go:3-9)

    _prim_type: list = field(default_factory=list)
    _o2w: list = field(default_factory=list)
    _params: list = field(default_factory=list)
    _mat_id: list = field(default_factory=list)
    _area_light: list = field(default_factory=list)
    _reverse: list = field(default_factory=list)
    _materials: list = field(default_factory=list)
    _textures: list = field(default_factory=list)
    _lights: list = field(default_factory=list)

    # --- textures ---------------------------------------------------------

    def _add_texture(self, row) -> int:
        self._textures.append(row)
        return len(self._textures) - 1

    def constant_texture(self, rgb) -> int:
        return self._add_texture(
            dict(type=TEX_CONSTANT, v1=_rgb(rgb), v2=(0, 0, 0), mapping=MAP_UV,
                 vs=(1, 0, 0), vt=(0, 1, 0), dsdt=(0, 0))
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
                 vs=tuple(vs), vt=tuple(vt), dsdt=(ds, dt))
        )

    def uv_texture(self) -> int:
        """The (u, v) debug texture."""
        return self._add_texture(
            dict(type=TEX_UV, v1=(0, 0, 0), v2=(0, 0, 0), mapping=MAP_UV,
                 vs=(1, 0, 0), vt=(0, 1, 0), dsdt=(0, 0))
        )

    def image_texture(self, image, su=1.0, sv=1.0) -> int:
        _not_ported("image textures", "open item 1.7")

    # --- materials --------------------------------------------------------

    def _add_material(self, **kw) -> int:
        row = dict(
            mat_type=MATTE, kd=(0.5, 0.5, 0.5), kd_tex=-1, sigma=0.0,
            kr=(1.0, 1.0, 1.0), kt=(1.0, 1.0, 1.0), eta=1.5, roughness=0.0,
        )
        row.update(kw)
        self._materials.append(row)
        return len(self._materials) - 1

    def matte(self, kd=(0.5, 0.5, 0.5), kd_tex: int = -1, sigma: float = 0.0,
              bump_tex: int = -1) -> int:
        """Matte: Lambertian (sigma=0) or Oren-Nayar (matte.go:21-37)."""
        if bump_tex >= 0:
            _not_ported("bump mapping", "open item 1.7")
        return self._add_material(mat_type=MATTE, kd=_rgb(kd), kd_tex=kd_tex,
                                  sigma=sigma)

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

    def subsurface(self, *args, **kwargs) -> int:
        _not_ported("subsurface scattering", "open item 1.7")

    def null_material(self) -> int:
        _not_ported("null materials / bounded media", "open item 1.7")

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

    def animate(self, *args, **kwargs) -> None:
        _not_ported("animation", "open item 1.7")

    def set_medium(self, *args, **kwargs) -> None:
        _not_ported("participating media", "open item 1.7")

    def add_medium(self, *args, **kwargs) -> int:
        _not_ported("participating media", "open item 1.7")

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
        """World bounds of prim i (static prims: ``animate`` raises)."""
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
        if self.light_strategy not in ("uniform", "power"):
            _not_ported(f"the {self.light_strategy!r} light distribution",
                        "open item 1.6")
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
        minfo = MatInfo(
            mat_types=tuple(sorted(set(m["mat_type"] for m in self._materials))),
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
            "textures.atlas": np.zeros((1, 1, 3), np.float32),
            "textures.image_rect": [(0, 0, 1, 1)] * len(texs),
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
        infos = dict(pinfo=asdict(pinfo), minfo=asdict(minfo),
                     fastinfo=asdict(self._fast_path_info(o2w)))
        if accelerator == "bvh" and n > 4:
            tree, backend, ms = bvh_ops.build_timed(*bvh_ops._prim_bounds_np(self))
            arrays.update({f"bvh.{f}": getattr(tree, f).numpy() for f in tree._fields})
            infos["bvh_build"] = {"backend": backend, "build_ms": ms}
        return scene_from_arrays(arrays, infos, device)

    def _fast_path_info(self, o2w: np.ndarray) -> FastPathInfo:
        """Eligibility for the bounce megakernel (scene.py:749-830); see
        static_info.FastPathInfo for the closed feature set."""
        common = True
        for m in self._materials:
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
        if any(self._reverse):
            common = False
        if any(m["mat_type"] == NULLMAT for m in self._materials):
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
        mesh_ok = common and len(self._materials) <= 16 and not has_rough_glass
        n_extras = sum(1 for t in self._prim_type if t != TRIANGLE)
        if not any(t == TRIANGLE for t in self._prim_type) or n_extras > 32:
            mesh_ok = False
        if any(m["mat_type"] not in (MATTE, MIRROR, GLASS, PLASTIC)
               for m in self._materials):
            mesh_ok = False
        has_glass = any(m["mat_type"] == GLASS and m["roughness"] <= 1e-4
                        for m in self._materials)
        return FastPathInfo(ok=ok, mesh_ok=mesh_ok, has_glass=has_glass,
                            has_rough_glass=has_rough_glass)


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
    values of PrimInfo, MatInfo and FastPathInfo as plain dicts — and,
    where the builder built the tree, "bvh_build": {"backend", "build_ms"}.
    """
    device = resolve_device(device)

    def group(name):
        return {f: _as_table(arrays[f"{name}.{f}"], device)
                for f in ARRAY_FIELDS[name]}

    if TEX_IMAGE in np.asarray(arrays["textures.tex_type"]).tolist():
        _not_ported("image textures", "open item 1.7")
    pinfo = PrimInfo(**{**infos["pinfo"], "types": tuple(infos["pinfo"]["types"])})
    minfo = MatInfo(**{**infos["minfo"],
                       "mat_types": tuple(infos["minfo"]["mat_types"])})
    top = {f: _as_table(arrays[f], device) for f in ARRAY_FIELDS[""]}
    scene = Scene(
        prims=Primitives(**group("prims"), pinfo=pinfo),
        materials=Materials(**group("materials"), info=minfo),
        textures=Textures(**group("textures")),
        lights=Lights(**group("lights")),
        fastinfo=FastPathInfo(**infos["fastinfo"]),
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
        table = getattr(scene, name) if name else scene
        if table is None and name in OPTIONAL_GROUPS:
            continue
        for f in fields:
            out[f"{name}.{f}" if name else f] = getattr(table, f).cpu().numpy()
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
