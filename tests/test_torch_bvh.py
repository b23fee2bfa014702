"""The port's BVH against gopbrt_tpu's: the host builders, the tree carried
across, and the plain walk (the plain version of csrc/bvh_intersect.cu).

The builders must give the JAX package's tree array for array, from the
same bounds (the native C++ builders are the same source built with the
same flags).  Each triangle's record holds the Havel-Herout planes of the
JAX mesh megakernel's records (``build_mesh_tables``), and the plain
plane-form test (the mesh megakernel's) gives ``_tri_test_h``'s answers.
The walk is held against the JAX lockstep walk
(``ops/bvh.bvh_intersect``) and the TPU cluster kernel in interpret mode
(``pallas_cluster.cluster_intersect``) on the mesh scene at 16x16 (480
triangles, a floor disk and a lamp sphere), at the bars of
tests/test_pallas_cluster.py:41-45: hit agreement > 0.999, t within
2e-4, prim ids equal on > 0.995 of the lanes both hit; any hit > 0.999;
dead lanes (t_max <= 2e-4) unoccluded.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_tables_equal, bvh_backend, carry,  # noqa: F401
                           jax_scene_arrays, load_jax_native)
from gopbrt_tpu.models import meshes as jmeshes
from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
from gopbrt_tpu.ops import bvh as jbvh
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu.ops import pallas_cluster as pc
from gopbrt_tpu.ops import pallas_mesh_megakernel as jmm
from gopbrt_tpu_torch import _build
from gopbrt_tpu_torch import native as tnative
from gopbrt_tpu_torch.models import meshes as tmeshes
from gopbrt_tpu_torch.models.scene import SceneBuilder, scene_to_arrays
from gopbrt_tpu_torch.ops import brute_intersect as tbi
from gopbrt_tpu_torch.ops import bvh as tbvh
from gopbrt_tpu_torch.ops import geom as tgeom
from gopbrt_tpu_torch.ops.intersect import DISK, SPHERE, TRIANGLE


def spheres_65(cls, geom):
    """65 spheres in a grid: above the brute-force cutoff."""
    b = cls()
    m = b.matte()
    for i in range(65):
        b.sphere(np.asarray(geom.translate([3.0 * (i % 9), 2.5 * (i // 9), 0.3 * i])),
                 1.0 + 0.01 * i, m)
    b.point_light(p=(0.0, 5.0, 0.0), intensity=(1.0, 1.0, 1.0))
    return b


def _builders(name):
    if name == "mesh":
        jb, tb = [], []
        for cls, geom, mod, out in ((JaxBuilder, jgeom, jmeshes, jb),
                                    (SceneBuilder, tgeom, tmeshes, tb)):
            b = cls()
            verts, idx = mod.uv_sphere(16, 16)
            mat = b.plastic(kd=(0.25, 0.45, 0.8), ks=(0.6, 0.6, 0.6), roughness=0.12)
            b.triangle_mesh(np.asarray(geom.matmul(geom.translate([0.0, 1.0, 0.0]),
                                                   geom.rotate_x(-90.0))), verts, idx, mat)
            b.disk(np.asarray(geom.rotate_x(-90.0)), radius=50.0, material=b.matte())
            b.sphere(np.asarray(geom.translate([-3.0, 4.0, 2.0])), 0.6, b.matte())
            out.append(b)
        return jb[0], tb[0]
    return spheres_65(JaxBuilder, jgeom), spheres_65(SceneBuilder, tgeom)


@pytest.mark.parametrize("backend", ["native", "numpy"])
@pytest.mark.parametrize("name", ["mesh", "spheres_65"])
def test_builders_match_jax_array_for_array(name, backend):
    """The prims' world bounds, then the tree of each builder."""
    if backend == "native" and tnative.load() is None:
        pytest.skip("no C++ compiler for the native builder on this machine")
    if backend == "native":
        # the reference's loader may have failed in this worker (a library
        # another worker was still writing): load it again once complete
        assert load_jax_native(), "the JAX package's native builder does not load"
    jb, tb = _builders(name)
    jlo, jhi = jbvh._prim_bounds_np(jb)
    tlo, thi = tbvh._prim_bounds_np(tb)
    np.testing.assert_array_equal(tlo, jlo)
    np.testing.assert_array_equal(thi, jhi)
    want = jbvh.build_from_bounds(jlo, jhi, backend=backend)
    got, used, method, ms = tbvh.build_timed(tlo, thi, backend=backend)
    assert used == backend and method == "sah" and ms > 0.0
    assert got.prim_order.shape == (jlo.shape[0],)
    for f in tbvh.LinearBVH._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_unknown_backend_raises():
    lo = np.zeros((8, 3), np.float32)
    with pytest.raises(ValueError, match="backend"):
        tbvh.build_from_bounds(lo, lo + 1.0, backend="cuda")


def _native_bvh_case(case):
    """tests/test_native_bvh.py's inputs: the bounds of its random sphere
    scenes of n prims (seed n), or its 37 prims with one centroid."""
    from tests.test_bvh import prim_bounds, random_sphere_scene

    if case == "duplicate":
        lo = np.zeros((37, 3), np.float32)
        return lo, np.ones((37, 3), np.float32)
    return prim_bounds(random_sphere_scene(case, seed=case))


@pytest.mark.parametrize("case", [1, 2, 5, 64, 333, "duplicate"])
def test_hlbvh_matches_jax_array_for_array(case):
    """The native HLBVH build (Morton radix sort, treelets, an SAH over
    them; SAH at <= 4 prims, as the source does) gives the JAX package's
    tree array for array."""
    if tnative.load() is None:
        pytest.skip("no C++ compiler for the native builder on this machine")
    assert load_jax_native(), "the JAX package's native builder does not load"
    lo, hi = _native_bvh_case(case)
    want = jbvh.build_from_bounds(lo, hi, backend="native", method="hlbvh")
    got, used, method, _ = tbvh.build_timed(lo, hi, backend="native", method="hlbvh")
    assert (used, method) == ("native", "hlbvh")
    for f in tbvh.LinearBVH._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("method", ["sah", "hlbvh"])
def test_native_tree_does_not_depend_on_the_thread_count(method):
    """One thread builds the tree every host core builds, array for array:
    on the 16x16 mesh scene's 482 prims and the 10,224-triangle mesh
    scene's 10,226."""
    if tnative.load() is None:
        pytest.skip("no C++ compiler for the native builder on this machine")
    for b in (tmeshes.mesh_builder(16, 16), tmeshes.mesh_builder()):
        lo, hi = tbvh._prim_bounds_np(b)
        one = tnative.bvh_build(lo, hi, n_threads=1, method=method)
        every = tnative.bvh_build(lo, hi, method=method)
        for f, x, y in zip(tbvh.LinearBVH._fields, one, every):
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("backend, method, error", [
    ("numpy", "hlbvh", "SAH only"), ("auto", "octree", "method"),
    ("native", "octree", "method"), ("numpy", "octree", "method")])
def test_build_refuses_an_unknown_or_unbuildable_method(backend, method, error):
    lo = np.zeros((8, 3), np.float32)
    with pytest.raises(ValueError, match=error):
        tbvh.build_from_bounds(lo, lo + 1.0, backend=backend, method=method)


def test_native_binding_refuses_an_unknown_method():
    lo = np.zeros((8, 3), np.float32)
    with pytest.raises(ValueError, match="method"):
        tnative.bvh_build(lo, lo + 1.0, method="octree")


def test_hlbvh_without_the_library_builds_sah_and_says_so(monkeypatch):
    """backend="auto" where the native library is missing builds NumPy's
    SAH tree, as the reference does; build_timed reports it."""
    monkeypatch.setattr(tnative, "load", lambda: None)
    lo, hi = _native_bvh_case(64)
    got, used, method, _ = tbvh.build_timed(lo, hi, method="hlbvh")
    assert (used, method) == ("numpy", "sah")
    want = tbvh.build_from_bounds(lo, hi, backend="numpy")
    for f in tbvh.LinearBVH._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(RuntimeError, match="unavailable"):
        tbvh.build_from_bounds(lo, hi, backend="native", method="hlbvh")


@pytest.fixture(scope="module")
def mesh():
    js = jmeshes.build_mesh_scene(n_lat=16, n_lon=16)
    assert js.clusters is not None and js.bvh is not None
    return js, carry(js)


def test_mesh_scene_builds_and_carries_the_jax_tree(mesh, bvh_backend):
    """The port's builder gives the JAX scene's tables, the tree included,
    each side's tree built by the builder the JAX side uses in this process
    (its scene built here, after ``bvh_backend`` read which); scene_from_arrays
    carries a JAX-built tree across exactly and packs the walk's and the
    mesh kernel's tables."""
    js, ts = mesh
    got = tmeshes.build_mesh_scene(n_lat=16, n_lon=16, device="cpu")
    want = jax_scene_arrays(jmeshes.build_mesh_scene(n_lat=16, n_lon=16))
    assert "bvh.node_lo" in want
    assert got.bvh_tables.backend == bvh_backend
    assert_tables_equal(scene_to_arrays(got), want, rtol=1e-6)
    assert_tables_equal(scene_to_arrays(ts), jax_scene_arrays(js))
    for s in (got, ts):
        assert s.prims.count == 482 and s.fastinfo.mesh_ok and not s.fastinfo.ok
        assert s.bvh_tables.records.shape == (482, tbvh.REC_K)
        n_inner = int((s.bvh.node_count == 0).sum())
        assert s.bvh_tables.nodes.shape == (1 + n_inner, tbvh.NODE_K)
        assert s.mesh is not None and s.bvh is s.bvh_tables.bvh
    # the builder records how it built the tree; a carried tree says nothing
    assert got.bvh_tables.backend in ("native", "numpy") and got.bvh_tables.build_ms > 0.0
    assert ts.bvh_tables.backend is None and ts.bvh_tables.build_ms is None


def _decode(code: int):
    """A child's code in the packed tree -> ("inner", node) or ("leaf",
    first, count)."""
    if code >= 0:
        return ("inner", code)
    leaf = -1 - code
    return ("leaf", leaf >> tbvh.LEAF_SHIFT, leaf & ((1 << tbvh.LEAF_SHIFT) - 1))


def _child_code(tree, c: int, index: dict):
    """What the packed tree must hold as node c's code."""
    if int(tree.node_count[c]) > 0:
        return ("leaf", int(tree.node_first[c]), int(tree.node_count[c]))
    return ("inner", index[c])


def test_packed_tables_hold_the_tree_and_the_leaf_order(mesh):
    """The header holds the root; each packed interior node holds its
    split axis and its two children's codes (interior: the packed index,
    in depth-first order; leaf: first record and count); the records are in
    leaf order."""
    _, ts = mesh
    bt, tree, prims = ts.bvh_tables, ts.bvh, ts.prims
    bits = bt.nodes.view(torch.int32)
    inner = torch.nonzero(tree.node_count == 0).flatten().tolist()
    index = {c: k + 1 for k, c in enumerate(inner)}
    assert _decode(int(bits[0, 3])) == _child_code(tree, 0, index)
    assert not bool(bt.nodes[0, 7:].any())
    for c in inner:
        row = bits[index[c]]
        assert _decode(int(row[3])) == _child_code(tree, c + 1, index)
        assert _decode(int(row[11])) == _child_code(tree, int(tree.node_right[c]), index)
        assert int(row[7]) == int(tree.node_axis[c]) and int(row[15]) == 0
    order = tree.prim_order.long()
    rec = bt.records
    assert torch.equal(rec[:, tbvh.REC_PARAMS:tbvh.REC_PARAMS + 9], prims.params[order])
    assert torch.equal(rec[:, tbvh.REC_TYPE].int(), prims.prim_type[order])
    assert torch.equal(rec[:, tbvh.REC_MAT].int(), prims.material_id[order])
    assert torch.equal(rec[:, tbvh.REC_ALID].int(), prims.area_light_id[order])


@pytest.mark.parametrize("name", ["mesh", "spheres_65"])
def test_packed_nodes_hold_both_child_boxes(name, mesh):
    """Decoding bvh_table's nodes: the header's box is the root's, and each
    interior node's two boxes are its children's node_lo / node_hi."""
    if name == "mesh":
        tree, nodes = mesh[1].bvh, mesh[1].bvh_tables.nodes
    else:
        tree = tbvh.build_from_bounds(*tbvh._prim_bounds_np(_builders(name)[1]),
                                      backend="numpy")
        nodes = tbvh.pack_nodes(tree)
    inner = torch.nonzero(tree.node_count == 0).flatten()
    assert nodes.shape == (1 + inner.numel(), tbvh.NODE_K)
    assert torch.equal(nodes[0, 0:3], tree.node_lo[0])
    assert torch.equal(nodes[0, 4:7], tree.node_hi[0])
    left, right = inner + 1, tree.node_right[inner].long()
    body = nodes[1:]
    assert torch.equal(body[:, 0:3], tree.node_lo[left])
    assert torch.equal(body[:, 4:7], tree.node_hi[left])
    assert torch.equal(body[:, 8:11], tree.node_lo[right])
    assert torch.equal(body[:, 12:15], tree.node_hi[right])
    assert nodes.data_ptr() % 64 == 0  # a node is one 64-byte fetch


def _rays(n, seed):
    """Rays from a shell around the scene toward points near the mesh
    (tests/test_pallas_cluster.py:19-28)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0.0, 4.0, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.2
    target = rng.normal(0.0, 1.2, (n, 3)).astype(np.float32)
    target[:, 1] = np.abs(target[:, 1])
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _check_closest(want, got):
    h1, t1, i1 = (np.asarray(x) for x in want)
    h2, t2, i2 = (x.numpy() for x in got)
    assert (h1 == h2).mean() > 0.999, f"hit mismatch {(h1 != h2).sum()}"
    both = h1 & h2
    np.testing.assert_allclose(t2[both], t1[both], rtol=2e-4, atol=2e-4)
    assert (i1[both] == i2[both]).mean() > 0.995


@pytest.mark.parametrize("reference", ["lockstep", "cluster_interpret"])
def test_walk_matches_jax_closest_hit(mesh, reference):
    js, ts = mesh
    o, d = _rays(2048, seed=0)
    t_max = np.full((2048,), 1e30, np.float32)
    args = (js.prims, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    if reference == "lockstep":
        want = jbvh.bvh_intersect(js.bvh, *args)
    else:
        want = pc.cluster_intersect(js.clusters, *args, interpret=True)
    got = tbvh.bvh_intersect(ts.bvh_tables, torch.tensor(o), torch.tensor(d),
                             torch.tensor(t_max))
    _check_closest(want, got)
    assert float(got[0].float().mean()) > 0.5


@pytest.mark.parametrize("reference", ["lockstep", "cluster_interpret"])
def test_walk_matches_jax_any_hit(mesh, reference):
    js, ts = mesh
    o, d = _rays(1024, seed=2)
    _, t_first, _ = tbvh.bvh_intersect(ts.bvh_tables, torch.tensor(o), torch.tensor(d),
                                       torch.full((1024,), 1e30))
    # half the lanes' first hits in range, half out; t_max stays <= 1e30,
    # the miss value of the shape tests
    t_first = t_first.numpy()
    t_max = np.where(np.arange(1024) % 2 == 0, np.minimum(t_first * 1.5, 1e30), t_first * 0.5)
    t_max = t_max.astype(np.float32)
    args = (js.prims, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    if reference == "lockstep":
        want = np.asarray(jbvh.bvh_intersect_p(js.bvh, *args))
    else:
        want = np.asarray(pc.cluster_intersect_p(js.clusters, *args, interpret=True))
    got = tbvh.bvh_intersect_p(ts.bvh_tables, torch.tensor(o), torch.tensor(d),
                               torch.tensor(t_max)).numpy()
    assert (got == want).mean() > 0.999
    assert 0.3 < got.mean() < 0.7


def test_any_hit_dead_lanes_and_t_max(mesh):
    """Dead lanes (t_max <= 2e-4) read unoccluded; hits beyond t_max do not
    occlude (tests/test_pallas_cluster.py:75-94)."""
    js, ts = mesh
    o, d = _rays(768, seed=3)
    _, t_ref, _ = tbvh.bvh_intersect(ts.bvh_tables, torch.tensor(o), torch.tensor(d),
                                     torch.full((768,), 1e30))
    t_max = t_ref.numpy() * 0.5
    dead = np.arange(768) % 4 == 0
    t_max[dead] = np.where(np.arange(768)[dead] % 8 == 0, 1e-4, 2e-4)
    got = tbvh.bvh_intersect_p(ts.bvh_tables, torch.tensor(o), torch.tensor(d),
                               torch.tensor(t_max)).numpy()
    oracle = np.asarray(jbvh.bvh_intersect_p(js.bvh, js.prims, jnp.asarray(o),
                                             jnp.asarray(d), jnp.asarray(t_max)))
    assert not got[dead].any()
    assert (got[~dead] == oracle[~dead]).mean() > 0.999


def test_walk_respects_t_max(mesh):
    _, ts = mesh
    o, d = (torch.tensor(a) for a in _rays(512, seed=1))
    hit, t_ref, _ = tbvh.bvh_intersect(ts.bvh_tables, o, d, torch.full((512,), 1e30))
    h, t, p = tbvh.bvh_intersect(ts.bvh_tables, o, d, t_ref * 0.5)
    assert bool(hit.any()) and not bool(h.any())
    assert torch.equal(t, t_ref * 0.5) and not bool(p.any())  # t_max and prim 0


def test_walk_tally_counts_nodes_and_tests(mesh):
    """tally counts the events of csrc/bvh.cuh's walk (a root test per
    lane, interior nodes expanded, pops, each leaf test by kind) and steps
    each lane's steps; the any hit walks no dead lane."""
    _, ts = mesh
    o, d = (torch.tensor(a) for a in _rays(256, seed=4))
    tally, steps = {}, torch.zeros((256,), dtype=torch.int64)
    _, slot = tbvh.walk(ts.bvh_tables, o, d, torch.full((256,), 1e30), tally=tally,
                        steps=steps)
    assert tally["bvh_roots"] == 256
    # a step is an interior node or a leaf; a lane that hits visits a leaf
    leaves = int(steps.sum()) - tally["bvh_nodes"]
    assert 0 < leaves and bool((steps[slot >= 0] >= 1).all())
    leaf_tests = tally["triangle_tests"] + tally.get("disk_tests", 0) + tally.get(
        "sphere_tests", 0)
    assert leaves <= leaf_tests <= tbvh.MAX_LEAF * leaves
    # only a node whose two children were both hit pushes
    assert 0 < tally["bvh_pops"] <= tally["bvh_nodes"]
    dead, dead_steps = {}, torch.zeros((256,), dtype=torch.int64)
    tbvh.walk(ts.bvh_tables, o, d, torch.full((256,), 1e-4), any_hit=True, tally=dead,
              steps=dead_steps)
    assert dead == {} and not bool(dead_steps.any())


def test_fused_on_cpu_runs_the_plain_walk_without_a_launch(mesh):
    _, ts = mesh
    o, d = (torch.tensor(a) for a in _rays(256, seed=5))
    t_max = torch.full((256,), 1e30)
    before = dict(_build.LAUNCHES)
    got = tbvh.bvh_intersect_fused(ts.bvh_tables, o, d, t_max)
    want = tbvh.bvh_intersect(ts.bvh_tables, o, d, t_max)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(tbvh.bvh_intersect_p_fused(ts.bvh_tables, o, d, t_max),
                       tbvh.bvh_intersect_p(ts.bvh_tables, o, d, t_max))
    assert dict(_build.LAUNCHES) == before


def _random_prims(n, seed):
    """Records of every shape kind: full and clipped spheres, annulus and
    wedge disks, triangles."""
    r = np.random.default_rng(seed)
    rec = np.zeros((n, tbvh.REC_K), np.float32)
    for i in range(n):
        kind = i % 3
        rec[i, tbvh.REC_TYPE] = kind
        if kind == TRIANGLE:
            rec[i, 0:9] = (r.uniform(-2, 2, 3) + r.normal(size=(3, 3))).reshape(-1)
            continue
        m = np.eye(4)
        m[:3, :3] *= r.uniform(0.5, 1.5)
        m[:3, 3] = r.uniform(-2, 2, 3)
        rec[i, tbvh.REC_W2O:tbvh.REC_W2O + 12] = np.linalg.inv(m)[:3].reshape(-1)
        rad = r.uniform(0.5, 2.0)
        phi = 2.0 * math.pi if i % 2 else r.uniform(0.5, 6.0)
        if kind == SPHERE:
            rec[i, 0:4] = (rad, -rad * r.uniform(0.3, 1.0), rad * r.uniform(0.3, 1.0), phi)
        else:
            rec[i, 0:4] = (r.uniform(-1, 1), rad, rad * r.uniform(0.0, 0.5), phi)
    return rec


def test_record_test_matches_the_brute_prim_test():
    """The walk's leaf test, one record per lane with the kinds mixed, gives
    on every lane the t of ``prim_test`` sweeping that record's row over all
    lanes, for every shape kind and clip."""
    rec = _random_prims(60, seed=8)
    r = np.random.default_rng(9)
    n = 2048
    pick = r.integers(0, rec.shape[0], n)
    # each lane aims near its record's centre: a triangle's centroid, a
    # quadric's object origin
    centre = np.zeros((rec.shape[0], 3))
    for p in range(rec.shape[0]):
        if rec[p, tbvh.REC_TYPE] == TRIANGLE:
            centre[p] = rec[p, 0:9].reshape(3, 3).mean(axis=0)
        else:
            w2o = rec[p, tbvh.REC_W2O:tbvh.REC_W2O + 12].reshape(3, 4).astype(np.float64)
            centre[p] = -np.linalg.solve(w2o[:, :3], w2o[:, 3])
    o = torch.tensor(r.normal(size=(n, 3)).astype(np.float32) * 6.0)
    d = torch.nn.functional.normalize(torch.tensor(
        (centre[pick] + r.normal(size=(n, 3)) * 0.5).astype(np.float32)) - o, dim=-1)
    t_max = torch.tensor(np.where(r.random(n) < 0.5, 1e30, r.uniform(0.1, 10.0, n)).astype(
        np.float32))
    tally = {}
    got = tbvh.prim_test_records(torch.tensor(rec[pick]), o, d, t_max, tally=tally)
    want = torch.empty(n)
    for p in range(rec.shape[0]):
        pr, m = rec[p, 0:9].tolist(), rec[p, tbvh.REC_W2O:tbvh.REC_W2O + 12].tolist()
        row = tbi.prim_test(int(rec[p, tbvh.REC_TYPE]), m, pr, *o.unbind(-1), *d.unbind(-1),
                            t_max)
        want[pick == p] = row[torch.tensor(pick == p)]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    assert int((want < tbi.BIG).sum()) > 300
    kinds = rec[pick, tbvh.REC_TYPE]
    assert tally["triangle_tests"] == int((kinds == TRIANGLE).sum())
    assert tally["sphere_tests"] + tally["disk_tests"] == int((kinds != TRIANGLE).sum())
    assert {int(k) for k in kinds} == {SPHERE, DISK, TRIANGLE}


def test_triangle_records_hold_the_jax_planes(mesh):
    """Each triangle's record columns 12-23 hold the N, d_n, U, d_u, V, d_v
    columns of the JAX mesh megakernel's record of the same triangle
    (pallas_mesh_megakernel.py build_mesh_tables, host numpy) within 1e-6
    relative; spheres and disks keep their world->object rows."""
    js, ts = mesh
    mt = js.meshkernel
    jrec = np.asarray(mt.tri)
    slot_prim = np.asarray(mt.order)
    nt = int((slot_prim[:jrec.shape[0]] >= 0).sum())
    want = {int(p): jrec[k] for k, p in enumerate(slot_prim[:nt])}
    rec = ts.bvh_tables.records.numpy()
    order = ts.bvh.prim_order.numpy()
    tri = np.nonzero(rec[:, tbvh.REC_TYPE] == TRIANGLE)[0]
    assert tri.size == nt == 480
    cols = [(0, jmm._RC_N, 3), (3, jmm._RC_DN, 1), (4, jmm._RC_U, 3), (7, jmm._RC_DU, 1),
            (8, jmm._RC_V3, 3), (11, jmm._RC_DV, 1)]
    got = rec[tri, tbvh.REC_W2O:tbvh.REC_W2O + 12]
    ref = np.stack([want[int(order[k])] for k in tri])
    for ours, theirs, k in cols:
        want_cols = ref[:, theirs:theirs + k]
        np.testing.assert_allclose(got[:, ours:ours + k], want_cols, rtol=1e-6,
                                   atol=1e-6 * np.abs(want_cols).max(), err_msg=str(theirs))
    quad = np.nonzero(rec[:, tbvh.REC_TYPE] != TRIANGLE)[0]
    w2o = ts.prims.world_to_obj[torch.as_tensor(order[quad]).long(), :3, :].reshape(-1, 12)
    np.testing.assert_array_equal(rec[quad, tbvh.REC_W2O:tbvh.REC_W2O + 12], w2o.numpy())


def _plane_cases(n, seed):
    """Triangles and rays for the plane-form test: rays aimed at points
    inside, on and just outside the edges, rays from behind and through the
    origin's side of the plane, rays parallel to the plane, degenerate
    (collinear) triangles, and t limits below the hit."""
    r = np.random.default_rng(seed)
    v = r.normal(0.0, 2.0, (n, 3, 3)).astype(np.float32)
    kind = np.arange(n) % 8
    v[kind == 7, 2] = v[kind == 7, 0] + 0.5 * (v[kind == 7, 1] - v[kind == 7, 0])  # collinear
    b = r.uniform(-0.2, 1.0, (n, 2))
    on_edge = kind == 2
    b[on_edge, 1] = 1.0 - b[on_edge, 0]  # u + v = 1
    b[kind == 3, 0] = 0.0  # u = 0
    target = v[:, 0] + b[:, :1] * (v[:, 1] - v[:, 0]) + b[:, 1:] * (v[:, 2] - v[:, 0])
    o = r.normal(0.0, 6.0, (n, 3)).astype(np.float32)
    d = target - o
    d[kind == 4] *= -1.0  # the triangle lies behind the origin
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    nrm = np.cross(e1, e2)
    par = kind == 5  # parallel to the triangle's plane
    d[par] = np.cross(nrm[par], r.normal(size=(par.sum(), 3)))
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    t_limit = np.where(kind == 6, r.uniform(0.0, 3.0, n), 1e30).astype(np.float32)
    return v.reshape(n, 9), o.astype(np.float32), d.astype(np.float32), t_limit


def test_plane_test_matches_jax_tri_test_h():
    """The plain plane-form test on the port's planes against the TPU
    kernel's _tri_test_h on JAX's, on seeded rays and triangles with
    degenerate, edge, behind-origin, parallel and t-limited cases: the same
    accept decision on >= 99.9% of lanes, t within 1e-5 |t| where both hit."""
    n = 8192
    verts, o, d, t_limit = _plane_cases(n, seed=11)
    planes = tbvh.triangle_planes(verts)
    got = tbvh.plane_test(torch.tensor(planes), torch.tensor(o), torch.tensor(d),
                          torch.tensor(t_limit)).numpy()
    q = [jnp.asarray(planes[:, k]) for k in range(12)]
    want = np.asarray(jmm._tri_test_h(*q, *(jnp.asarray(o[:, k]) for k in range(3)),
                                      *(jnp.asarray(d[:, k]) for k in range(3)),
                                      jnp.asarray(t_limit)))
    hit_g, hit_w = got < tbi.BIG, want < tbi.BIG
    assert (hit_g == hit_w).mean() >= 0.999, f"{(hit_g != hit_w).sum()} decisions differ"
    both = hit_g & hit_w
    np.testing.assert_allclose(got[both], want[both], rtol=1e-5)
    kind = np.arange(n) % 8
    assert 0.2 < hit_w.mean() < 0.8
    assert not hit_w[kind == 4].any() and not hit_w[kind == 7].any()
    assert hit_w[kind == 2].any() and hit_w[kind == 3].any()


def test_plane_walk_matches_jax_closest_hit(mesh):
    """The mesh megakernel's walk (plane-form triangles) against JAX's
    lockstep walk (the vertex form) at the bars of the closest hit above;
    its tally counts plane tests in place of vertex-form ones."""
    js, ts = mesh
    o, d = _rays(2048, seed=6)
    t_max = np.full((2048,), 1e30, np.float32)
    want = jbvh.bvh_intersect(js.bvh, js.prims, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t_max))
    tally = {}
    t, slot = tbvh.walk(ts.bvh_tables, torch.tensor(o), torch.tensor(d), torch.tensor(t_max),
                        tally=tally, plane=True)
    hit = slot >= 0
    prim = torch.where(hit, ts.bvh.prim_order[slot.clamp(min=0)], 0)
    _check_closest(want, (hit, torch.where(hit, t, torch.tensor(t_max)), prim))
    assert "triangle_tests" not in tally and tally["plane_tests"] > 2048
    _, slot_any = tbvh.walk(ts.bvh_tables, torch.tensor(o), torch.tensor(d),
                            torch.tensor(t_max), any_hit=True, plane=True)
    assert torch.equal(slot_any >= 0, hit)
