"""The mesh path: the port's mesh megakernel module and the general chain on
a BVH scene, against gopbrt_tpu's.

On the mesh scene at 16x16 (480 triangles, a checker floor disk, a sphere
lamp, a point light) and 48x48 camera rays: ``path_li_plain(accel="bvh")``
(the plain version of csrc/mesh_megakernel.cu) against the JAX wavefront
chain ``_li_jnp`` at depths 1 and 3, with the bar of
tests/test_mesh_megakernel.py:59-63 (> 98% of lanes within 1e-3, mean
within 1e-2); ``_li_wavefront`` on the BVH walk against ``_li_jnp`` at the
same bar.  Then BASELINE config 3 through the port's ``render`` against
tests/goldens/config3_mesh_bvh.npz at the gates of tests/test_goldens.TOLS.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_torch, camera_rays, carry, lane_agreement
from gopbrt_tpu.models import integrators as jint
from gopbrt_tpu.models import meshes as jmeshes
from gopbrt_tpu.ops import pallas_mesh_megakernel as jmm
from gopbrt_tpu_torch import _build
from gopbrt_tpu_torch.models import gallery as tgallery
from gopbrt_tpu_torch.models import integrators as tint
from gopbrt_tpu_torch.models import meshes as tmeshes
from gopbrt_tpu_torch.models import render as trender
from gopbrt_tpu_torch.ops import megakernel as tmk
from gopbrt_tpu_torch.ops import mesh_megakernel as tmm
from tests.test_goldens import GOLDEN_DIR, TOLS

W = H = 48
SEED = 5

_jax_li = jax.jit(jint._li_jnp, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def mesh():
    js = jmeshes.build_mesh_scene(n_lat=16, n_lon=16)
    ts = carry(js)
    assert ts.fastinfo.mesh_ok and ts.mesh is not None
    return js, ts, camera_rays(jmeshes.mesh_camera(W, H), W, H, 1, SEED)


def _check(got: np.ndarray, want: np.ndarray):
    assert np.all(np.isfinite(got))
    frac, mean_rel = lane_agreement(got, want)
    assert frac > 0.98, f"lane agreement {frac:.4f}"
    assert mean_rel < 1e-2, mean_rel
    assert want.mean() > 1e-2  # the image is not black


@pytest.mark.parametrize("depth", [1, 3])
def test_mesh_plain_matches_li_jnp(mesh, depth):
    js, ts, rays = mesh
    want = np.asarray(_jax_li(js, *rays, jnp.uint32(SEED),
                              jint.PathConfig(max_depth=depth, rr_threshold=1.0)))
    counts = {}
    bounces = torch.zeros((W * H,), dtype=torch.int64)
    got = tmk.path_li_plain(ts, *as_torch(*rays), SEED, tint.PathConfig(max_depth=depth),
                            counts=counts, accel="bvh", bounces=bounces).numpy()
    _check(got, want)
    # the walk, the triangle winners and the plastic lobe all ran, and the
    # events the kernel's bound counts add up
    assert set(counts) <= set(tmk.OPS_PER_EVENT)
    assert int(bounces.min()) >= 1 and int(bounces.max()) <= depth
    assert counts["bvh_roots"] >= int(bounces.sum())  # a closest-hit walk per bounce
    assert counts["bvh_nodes"] > 0 and counts["triangle_hits"] > 0
    assert 0 < counts["bvh_pops"] <= counts["bvh_nodes"]
    assert counts["plastic_samples"] > 0 and counts["nee_plastic"] > 0
    assert counts["lambert_samples"] + counts["plastic_ggx"] == counts["hits"] + counts[
        "triangle_hits"]
    assert counts["nee_plastic"] == counts["triangle_hits"]  # the mesh is plastic


def test_li_wavefront_on_the_bvh_matches_li_jnp(mesh):
    """The general chain with the BVH walk as its intersector."""
    js, ts, rays = mesh
    cone = (0.0, 0.003)
    want = np.asarray(_jax_li(js, *rays, jnp.uint32(SEED), jint.PathConfig(max_depth=3),
                              cone=cone))
    before = dict(_build.LAUNCHES)
    got = tint._li_wavefront(ts, *as_torch(*rays), SEED, tint.PathConfig(max_depth=3),
                             cone=cone).numpy()
    assert dict(_build.LAUNCHES) == before  # CPU tensors: the plain walk
    _check(got, want)


def test_li_sends_mesh_scenes_to_the_mesh_megakernel(mesh):
    """Mesh fast-path scenes above the cutoff run the mesh megakernel (its
    plain version on CPU tensors, no launch); early_exit runs the chain."""
    _, ts, rays = mesh
    args = (ts, *as_torch(*rays), SEED)
    cfg = tint.PathConfig(max_depth=2)
    before = dict(_build.LAUNCHES)
    got = tint.li(*args, cfg)
    assert torch.equal(got, tmk.path_li_plain(*args, cfg, accel="bvh"))
    assert torch.equal(tint.li_fused(tmm.MESH, *args, cfg), got)
    assert dict(_build.LAUNCHES) == before
    early = tint.PathConfig(max_depth=2, early_exit=True)
    assert torch.equal(tint.li(*args, early), tint._li_wavefront(*args, early))


def test_metal_mesh_runs_the_general_chain_on_the_bvh():
    """Metal lies outside the mesh fast path: the same scene runs
    _li_wavefront with the BVH walk."""
    ts = tmeshes.build_mesh_scene(n_lat=8, n_lon=8, device="cpu", mesh_material="metal")
    assert not ts.fastinfo.mesh_ok and ts.mesh is None and ts.prims.count > 64
    cam = tmeshes.mesh_camera(16, 16, device="cpu")
    st = trender.RenderSettings(width=16, height=16, spp=1, max_depth=3, seed=SEED)
    _, o, d, pix, smp = trender.band_rays(cam, st, 0, 16, 0)
    cfg = trender.path_config(st)
    got = tint.li(ts, o, d, pix, smp, SEED, cfg)
    assert torch.equal(got, tint._li_wavefront(ts, o, d, pix, smp, SEED, cfg))
    assert bool(torch.isfinite(got).all()) and float(got.mean()) > 1e-2


def test_material_table_matches_jax(mesh):
    """The mesh instance's material rows hold _mat_shade_np's columns
    (pallas_mesh_megakernel.py:188-242) in the shade layout; the checker
    mapping only on checker rows (the kernels read it nowhere else)."""
    js, ts, _ = mesh
    want = jmm._mat_shade_np(js)
    got = tmk.material_table(ts).numpy()
    chk = want[:, jmm._MS_CHK] > 0.5
    cols = [(tmk.SH_C1, jmm._MS_C1, 3, None), (tmk.SH_C2, jmm._MS_C2, 3, None),
            (tmk.SH_CHK, jmm._MS_CHK, 1, None), (tmk.SH_VS, jmm._MS_VS, 3, chk),
            (tmk.SH_VT, jmm._MS_VT, 3, chk), (tmk.SH_DS, jmm._MS_DS, 2, chk),
            (tmk.SH_TSS, jmm._MS_TSS, 2, chk), (tmk.SH_MIR, jmm._MS_MIR, 1, None),
            (tmk.SH_KR, jmm._MS_KS, 3, None), (tmk.SH_GLS, jmm._MS_GLS, 1, None),
            (tmk.SH_KT, jmm._MS_KT, 3, None), (tmk.SH_ETA, jmm._MS_ETA, 1, None),
            (tmk.SH_PLA, jmm._MS_PLA, 1, None), (tmk.SH_ALPHA, jmm._MS_ALPHA, 1, None)]
    for ours, theirs, k, rows in cols:
        rows = slice(None) if rows is None else rows
        np.testing.assert_allclose(got[rows, ours:ours + k], want[rows, theirs:theirs + k],
                                   rtol=1e-6, err_msg=str(ours))
    assert chk.sum() == 1
    assert got.shape == (want.shape[0], tmk.MAT_K) and got[:, tmk.SH_PLA].sum() == 1


def test_mesh_tables_follow_the_layout(mesh):
    _, ts, _ = mesh
    packed = ts.mesh.tables
    assert packed.shape == (tmm.MESH_TABLE_WORDS,) and tmm.MESH_TABLE_WORDS == 769
    m = ts.mesh.n_mats
    mat = packed[:tmk.MAX_MATS * tmk.MAT_K].reshape(tmk.MAX_MATS, tmk.MAT_K)
    assert torch.equal(mat[:m], tmk.material_table(ts)) and not bool(mat[m:].any())
    light_layout = [(k, w) for k, w in tmk.TABLE_LAYOUT if k[0] == "l"]
    lights = tmk.pack_layout(tmk.light_parts(ts), light_layout)
    assert lights.numel() == sum(w for _, w in light_layout) == 257
    assert torch.equal(packed[tmk.MAX_MATS * tmk.MAT_K:], lights)
    assert ts.mesh.func_int == float(ts.light_func_int)


def test_config3_render_matches_its_golden():
    name = "config3_mesh_bvh"
    ref = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))["img"].astype(np.float32)
    scene, cam, settings = tgallery.config3(device="cpu")
    assert scene.prims.count == 1106 and scene.mesh is not None
    img = trender.render(scene, cam, settings, device="cpu").numpy()
    assert img.shape == ref.shape
    diff = np.abs(img - ref)
    mean_tol, pix_tol, frac = TOLS[name]
    assert diff.mean() < mean_tol, f"mean drift {diff.mean():.2e}"
    assert (diff < pix_tol).mean() > frac, f"pixels off: {(diff >= pix_tol).mean():.4f}"
