"""The independent C++ tracer (``cpu_baseline.cpp``): its build, its scene
dumps, its two modes, and the comparison of a render with it.

``cpu_baseline.cpp`` is the port's copy of the JAX package's scalar
tracer.  It shares no code with either renderer: its own BVH, path and
direct integrators, BSDFs and PCG32 sampler.  It has two modes:

* demo mode traces the reference's demo workload (``trace_demo``), the
  CPU baseline the benchmarks divide by (BASELINE.md);
* ``--scene`` mode traces a ``GOPBRT-SCENE-1`` text dump of a scene's
  flattened tables (``export_scene``, ``trace_scene``).  Each pixel's RNG
  is seeded from its index, so the image does not depend on the thread
  count.

``check_config``, ``render_for_check`` and ``compare`` hold a golden
config's render against the tracer's image, at the sizes and tolerances
of ``VAL_CONFIGS`` (the counterpart of ``benchmarks/cross_validate.py``).

The executable builds at first use with the host ``g++`` into
``build/gopbrt_tpu_torch/native/<hash of the source and flags>/``.  A
failed build raises.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import subprocess
import tempfile
from typing import NamedTuple

import numpy as np
import torch

from gopbrt_tpu_torch._build import BUILD_ROOT
from gopbrt_tpu_torch.models import film as film_mod
from gopbrt_tpu_torch.models import gallery, render
from gopbrt_tpu_torch.models.demo import build_demo_camera
from gopbrt_tpu_torch.ops import filters
from gopbrt_tpu_torch.ops.intersect import DISK, SPHERE, TRIANGLE
from gopbrt_tpu_torch.ops.megakernel import light_tables

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpu_baseline.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-pthread"]

# the dump's prim type codes (cpu_baseline.cpp: 0 sphere, 1 disk, 2 triangle)
_TYPE_CODE = {SPHERE: 0, DISK: 1, TRIANGLE: 2}

# per-material shade columns of the dump, the layout cpu_baseline.cpp reads
# (the reference's mesh megakernel rows, pallas_mesh_megakernel.py:125-140)
MS_C1 = 0       # 0-2  kd constant / checker colour 1
MS_C2 = 3       # 3-5  checker colour 2
MS_CHK = 6      # is_checker flag
MS_VS = 7       # 7-9  planar mapping s axis
MS_VT = 10      # 10-12 planar mapping t axis
MS_DS = 13      # 13-14 mapping offsets
MS_TSS = 15     # |vs|
MS_TST = 16     # |vt|
MS_MIR = 17     # mirror flag
MS_KS = 18      # 18-20 kr (mirror) / ks (plastic GGX) / kr (glass)
MS_GLS = 21     # glass flag
MS_KT = 22      # 22-24 glass transmittance
MS_ETA = 25     # dielectric IOR
MS_PLA = 26     # plastic flag
MS_ALPHA = 27   # GGX alpha
MS_K = 28


class ValConfig(NamedTuple):
    """A golden config's cross-check: its size, samples, depth,
    integrator, and the tolerances of the mean and of the region means."""

    name: str
    width: int
    height: int
    spp: int
    depth: int
    mode: str
    mean_tol: float
    region_tol: float


# benchmarks/cross_validate.py:144-150; tolerances are Monte Carlo noise
# bounds, loosest for config 4, whose glass caustics converge slowest
VAL_CONFIGS = [
    ValConfig("config1_demo_direct", 480, 270, 32, 3, "direct", 0.02, 0.05),
    ValConfig("config2_cornell_mirror", 480, 480, 32, 5, "path", 0.02, 0.04),
    ValConfig("config3_mesh_bvh", 480, 270, 32, 3, "path", 0.02, 0.05),
    ValConfig("config4_arealights_glass", 480, 480, 48, 8, "path", 0.03, 0.08),
]
VAL_BY_NAME = {c.name: c for c in VAL_CONFIGS}


@functools.lru_cache(maxsize=None)
def build() -> str:
    """Compile ``cpu_baseline.cpp`` where it is not built yet -> the
    executable's path.  Raises where the compiler fails or is missing."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / "native" / digest
    exe = out_dir / "cpu_baseline"
    if not exe.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = exe.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, _SRC, "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
        os.replace(tmp, exe)
    return str(exe)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _mat_shade_np(scene) -> np.ndarray:
    """Per-material shade rows f32[M, MS_K] (pallas_mesh_megakernel.py:188-242)."""
    mats, tex = scene.materials, scene.textures
    mt, kd, kdt = _host(mats.mat_type), _host(mats.kd), _host(mats.kd_tex)
    kr, kt, eta, rough = _host(mats.kr), _host(mats.kt), _host(mats.eta), _host(mats.roughness)
    ttype, v1, v2 = _host(tex.tex_type), _host(tex.value1), _host(tex.value2)
    vs, vt, ds = _host(tex.vs), _host(tex.vt), _host(tex.dsdt)
    out = np.zeros((len(mt), MS_K), np.float32)
    for i in range(len(mt)):
        spec = mt[i] in (1, 2)  # MIRROR / GLASS: no diffuse lobe
        c1 = np.zeros(3) if spec else kd[i]
        c2 = c1
        chk = 0.0
        mvs, mvt, mds = np.zeros(3), np.zeros(3), np.zeros(2)
        t = int(kdt[i])
        if t >= 0 and not spec:
            c1 = v1[t]
            if ttype[t] == 0:  # TEX_CONSTANT
                c2 = c1
            else:  # TEX_CHECKERBOARD (planar)
                c2, chk, mvs, mvt, mds = v2[t], 1.0, vs[t], vt[t], ds[t]
        out[i, MS_C1:MS_C1 + 3] = c1
        out[i, MS_C2:MS_C2 + 3] = c2
        out[i, MS_CHK] = chk
        out[i, MS_VS:MS_VS + 3] = mvs
        out[i, MS_VT:MS_VT + 3] = mvt
        out[i, MS_DS:MS_DS + 2] = mds
        out[i, MS_TSS] = float(np.linalg.norm(mvs))
        out[i, MS_TST] = float(np.linalg.norm(mvt))
        out[i, MS_MIR] = 1.0 if mt[i] == 1 else 0.0
        out[i, MS_KS:MS_KS + 3] = kr[i]
        out[i, MS_GLS] = 1.0 if mt[i] == 2 else 0.0
        out[i, MS_KT:MS_KT + 3] = kt[i]
        out[i, MS_ETA] = eta[i]
        out[i, MS_PLA] = 1.0 if mt[i] == 3 else 0.0
        out[i, MS_ALPHA] = max(float(rough[i]), 1e-3)
    return out


def world_bounds(prims):
    """Each prim's world AABB (lo, hi) f64[P, 3]: an object box's corners
    through obj_to_world in float64; triangles their vertices +- 1e-4,
    disks z = h +- 1e-3 (cross_validate.py:71-96)."""
    ptype = _host(prims.prim_type)
    o2w = _host(prims.obj_to_world).astype(np.float64)
    par = _host(prims.params).astype(np.float32)
    lo = np.zeros((len(ptype), 3), np.float64)
    hi = np.zeros((len(ptype), 3), np.float64)
    for i in range(len(ptype)):
        if ptype[i] == TRIANGLE:
            v = par[i].reshape(3, 3).astype(np.float64)
            lo[i], hi[i] = v.min(0) - 1e-4, v.max(0) + 1e-4
            continue
        if ptype[i] == SPHERE:
            r = float(par[i, 0])
            olo, ohi = np.array([-r, -r, -r]), np.array([r, r, r])
        else:  # DISK: z = height, radius par[1]
            h, r = float(par[i, 0]), float(par[i, 1])
            olo, ohi = np.array([-r, -r, h - 1e-3]), np.array([r, r, h + 1e-3])
        corners = np.array([[(olo, ohi)[a][0], (olo, ohi)[b][1], (olo, ohi)[c][2]]
                            for a in (0, 1) for b in (0, 1) for c in (0, 1)])
        wc = corners @ o2w[i, :3, :3].T + o2w[i, :3, 3]
        lo[i], hi[i] = wc.min(0), wc.max(0)
    return lo, hi


def _fmt(a) -> str:
    return " ".join(f"{float(x):.9g}" for x in np.asarray(a).reshape(-1))


def export_scene(scene, camera, path: str) -> None:
    """Write the scene's tables and the camera's matrices as the
    ``GOPBRT-SCENE-1`` text dump ``cpu_baseline --scene`` reads
    (cross_validate.py:56-141), every float as ``%.9g``."""
    prims = scene.prims
    ptype = _host(prims.prim_type)
    w2o = _host(prims.world_to_obj).astype(np.float32)
    par = _host(prims.params).astype(np.float32)
    mat, alid = _host(prims.material_id), _host(prims.area_light_id)
    lo, hi = world_bounds(prims)
    mtypes = _host(scene.materials.mat_type)
    mshade = _mat_shade_np(scene)
    ltype, lpos, lint, laux = (_host(t) for t in light_tables(scene))
    if len(ltype) and not np.allclose(laux[:, 5], laux[0, 5]):
        raise ValueError("the C++ tracer picks lights uniformly: build the scene with "
                         "light_strategy='uniform'")
    with open(path, "w") as f:
        f.write("GOPBRT-SCENE-1\n")
        f.write(f"cam {_fmt(_host(camera.raster_to_camera))} "
                f"{_fmt(_host(camera.camera_to_world))}\n")
        f.write(f"wr {float(_host(scene.world_radius)):.9g}\n")
        f.write(f"nprims {len(ptype)}\n")
        for i in range(len(ptype)):
            f.write(f"{_TYPE_CODE[int(ptype[i])]} {_fmt(w2o[i, :3, :4])} {_fmt(par[i])} "
                    f"{int(mat[i])} {int(alid[i])} {_fmt(lo[i])} {_fmt(hi[i])}\n")
        f.write(f"nmats {len(mtypes)}\n")
        for i in range(len(mtypes)):
            f.write(f"{int(mtypes[i])} {_fmt(mshade[i])}\n")
        f.write(f"nlights {len(ltype)}\n")
        for i in range(len(ltype)):
            f.write(f"{int(ltype[i])} {_fmt(lpos[i])} {_fmt(lint[i])} {_fmt(laux[i])}\n")


def _run(args: list, env=None) -> dict:
    proc = subprocess.run(args, capture_output=True, text=True, env=env)
    if proc.returncode != 0:
        raise RuntimeError(f"cpu_baseline exited {proc.returncode}:\n{proc.stderr}")
    return json.loads(proc.stdout)


def trace_dump(path: str, width: int, height: int, spp: int, depth: int,
               threads: int, mode: str = "path"):
    """``cpu_baseline --scene`` on the dump at ``path`` -> (its radiance
    f32[H, W, 3] clipped to [0, 1] as ``film.develop`` clips, its JSON
    stats: rays, seconds, rays_per_s, threads, mean_luminance, mode)."""
    if mode not in ("path", "direct"):
        raise ValueError(f"mode must be 'path' or 'direct', got {mode!r}")
    with tempfile.TemporaryDirectory() as td:
        raw = os.path.join(td, "img.raw")
        stats = _run([build(), "--scene", path, str(width), str(height), str(spp),
                      str(depth), str(threads), mode],
                     env=dict(os.environ, GOPBRT_BASELINE_DUMP=raw))
        img = np.fromfile(raw, np.float32).reshape(height, width, 3)
    return np.clip(img, 0.0, 1.0), stats


def trace_scene(scene, camera, width: int, height: int, spp: int, depth: int,
                threads: int, mode: str = "path"):
    """``export_scene`` to a temporary file, then ``trace_dump`` of it."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "scene.txt")
        export_scene(scene, camera, path)
        return trace_dump(path, width, height, spp, depth, threads, mode)


def trace_demo(width: int, height: int, spp: int, depth: int, threads: int,
               camera=None) -> dict:
    """Demo mode: the reference's demo scene through ``camera`` (default
    ``models/demo.build_demo_camera``; any object with ``raster_to_camera``
    and ``camera_to_world``) -> the JSON stats (measure_baseline.py:42-64)."""
    if camera is None:
        camera = build_demo_camera(width, height, device="cpu")
    mats = [_host(camera.raster_to_camera), _host(camera.camera_to_world)]
    return _run([build(), str(width), str(height), str(spp), str(depth), str(threads)]
                + [f"{float(v):.9g}" for m in mats for v in m.reshape(-1)])


def check_config(name: str, device=None):
    """``gallery.CONFIGS[name]`` at its ``VAL_CONFIGS`` size -> (scene,
    camera, settings), the settings as cross_validate.py:175-183 sets them:
    its spp and depth, 4 samples a pass, and a box filter of radius 0.5,
    so each sample lands only in its own pixel, as in the C++ tracer."""
    c = VAL_BY_NAME[name]
    scene, camera, settings = gallery.CONFIGS[name](c.width, c.height, device=device)
    settings = settings._replace(width=c.width, height=c.height, spp=c.spp,
                                 max_depth=c.depth, samples_per_pass=min(4, c.spp),
                                 filter=filters.box_filter(0.5))
    return scene, camera, settings


def render_for_check(scene, camera, settings, device=None) -> torch.Tensor:
    """The port's linear render of a check: ``render_pass`` for every pass,
    then ``film.develop(gamma=False)`` -> f32[H, W, 3] on ``device``."""
    film = film_mod.new_film(settings.width, settings.height, device=device)
    for p in range(-(-settings.spp // settings.samples_per_pass)):
        film = render.render_pass(scene, camera, film, settings,
                                  p * settings.samples_per_pass, device=device)
    return film_mod.develop(film, gamma=False)


def region_means(img: np.ndarray) -> np.ndarray:
    """The mean luminance of each cell of a 3x3 grid, row by row."""
    h, w = img.shape[:2]
    lum = img.mean(-1)
    return np.array([lum[(h * r) // 3:(h * (r + 1)) // 3, (w * c) // 3:(w * (c + 1)) // 3].mean()
                     for r in range(3) for c in range(3)])


def compare(img: np.ndarray, ref: np.ndarray, mean_tol: float, region_tol: float) -> dict:
    """The port's render ``img`` against the C++ tracer's image ``ref``
    (cross_validate.py:200-217): the relative difference of the means, and
    of the nine region means over the render's, each denominator floored
    at 5% of the render's mean (near-black regions would turn noise into
    large relative errors)."""
    m_cpp, m_port = float(ref.mean()), float(img.mean())
    rel_mean = abs(m_cpp - m_port) / max(m_port, 1e-6)
    r_cpp, r_port = region_means(ref), region_means(img)
    rel_reg = np.abs(r_cpp - r_port) / np.maximum(r_port, 0.05 * m_port)
    return {"mean_cpp": m_cpp, "mean_port": m_port, "rel_mean": rel_mean,
            "max_rel_region": float(rel_reg.max()), "tol": [mean_tol, region_tol],
            "ok": bool(rel_mean < mean_tol and np.all(rel_reg < region_tol))}
