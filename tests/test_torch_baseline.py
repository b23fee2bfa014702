"""The port's copy of the independent C++ tracer (gopbrt_tpu_torch/native/
baseline.py, cpu_baseline.cpp) against the JAX package's script for it,
benchmarks/cross_validate.py (loaded by path).

- the scene dumps of configs 1-4 at the goldens' sizes, parsed field by
  field: header, counts, type codes and every int equal, every float
  within 1e-6 relative or 1e-7 absolute (the light radii and the world
  bounds go through float32 sums in either package);
- the tracer traces either package's dump of config 2 to a bit-equal image
  where the dumps are the same text, and on 1 and 4 threads alike;
- demo mode: the port's demo camera equals JAX's to 1e-6 and traces to the
  same mean luminance;
- ``compare`` and ``region_means`` against the script's arithmetic.

No Monte Carlo agreement is tested here: ``chip_smoke.py``'s
``[cross-validate]`` holds the port's renders against the tracer at the
published sizes.
"""

import functools
import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from _torch_parity import carry
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.models import gallery as jgallery
from gopbrt_tpu.ops import filters as jfilters
from gopbrt_tpu_torch.models import demo as tdemo
from gopbrt_tpu_torch.models import gallery as tgallery
from gopbrt_tpu_torch.models.scene import SceneBuilder
from gopbrt_tpu_torch.native import baseline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted(jgallery.CONFIGS)
# float fields of a dump: within RTOL relative or ATOL absolute
RTOL, ATOL = 1e-6, 1e-7


@functools.cache
def _cross_validate():
    """The reference's script for the tracer (benchmarks/cross_validate.py)."""
    path = os.path.join(REPO, "benchmarks", "cross_validate.py")
    spec = importlib.util.spec_from_file_location("cross_validate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def exe():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler for the tracer on this machine")
    return baseline.build()


def parse_dump(text: str) -> dict:
    """A GOPBRT-SCENE-1 dump as arrays, ints and floats apart."""
    lines = text.splitlines()
    assert lines[0] == "GOPBRT-SCENE-1"
    head = lines[1].split()
    assert head[0] == "cam" and len(head) == 33
    out = {"cam": np.array(head[1:], np.float64)}
    key, wr = lines[2].split()
    assert key == "wr"
    out["wr"] = np.array([float(wr)])
    i = 3
    for table, width in (("prims", None), ("mats", 29), ("lights", 15)):
        key, n = lines[i].split()
        assert key == "n" + table
        rows = [r.split() for r in lines[i + 1:i + 1 + int(n)]]
        i += 1 + int(n)
        out[table + ".n"] = np.array([int(n)])
        if not rows:
            continue
        if width is not None:
            assert {len(r) for r in rows} == {width}
        out[table + ".type"] = np.array([int(r[0]) for r in rows])
        if table == "prims":  # type, w2o[12], params[K], mat, alid, lo[3], hi[3]
            assert len({len(r) for r in rows}) == 1
            out["prims.ids"] = np.array([[int(r[-8]), int(r[-7])] for r in rows])
            out["prims.f"] = np.array([r[1:-8] + r[-6:] for r in rows], np.float64)
        else:
            out[table + ".f"] = np.array([r[1:] for r in rows], np.float64)
    assert i == len(lines)
    return out


def assert_dumps_match(got: str, want: str):
    g, w = parse_dump(got), parse_dump(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        if w[k].dtype.kind == "i":
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL, err_msg=k)


def _dumps(tmp_path, jscene, jcam, tscene, tcam):
    jpath, tpath = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    _cross_validate().export_scene(jscene, jcam, jpath)
    baseline.export_scene(tscene, tcam, tpath)
    with open(jpath) as f, open(tpath) as g:
        return jpath, tpath, f.read(), g.read()


@pytest.mark.parametrize("source", ["carried", "built"])
@pytest.mark.parametrize("name", NAMES)
def test_dump_matches_the_reference_script(tmp_path, name, source):
    """The port's dump of config ``name`` at its golden size (its gallery
    default) against cross_validate.export_scene of the JAX scene: of the
    scene carried from JAX, and of the scene the port's gallery builds."""
    jscene, jcam, _ = jgallery.CONFIGS[name]()
    tscene, tcam, _ = tgallery.CONFIGS[name](device="cpu")
    if source == "carried":
        tscene = carry(jscene)
    _, _, want, got = _dumps(tmp_path, jscene, jcam, tscene, tcam)
    assert_dumps_match(got, want)
    parsed = parse_dump(got)
    assert parsed["prims.n"][0] == int(tscene.prims.count)
    assert set(parsed["prims.type"]) <= {0, 1, 2}


def test_tracer_is_deterministic(tmp_path, exe):
    """Config 2 at 32x32, 4 spp, depth 5: either package's dump traces to a
    bit-equal image where the dumps are the same text, and 1 and 4 threads
    give a bit-equal image."""
    jscene, jcam, _ = jgallery.config2(32, 32)
    jpath, tpath, want, got = _dumps(tmp_path, jscene, jcam, carry(jscene),
                                     tgallery.config2(32, 32, device="cpu")[1])
    assert got == want
    img1, st1 = baseline.trace_dump(tpath, 32, 32, 4, 5, 1)
    img4, st4 = baseline.trace_dump(tpath, 32, 32, 4, 5, 4)
    imgj, _ = baseline.trace_dump(jpath, 32, 32, 4, 5, 4)
    assert img1.shape == (32, 32, 3) and img1.dtype == np.float32
    np.testing.assert_array_equal(img4, img1)
    np.testing.assert_array_equal(imgj, img1)
    assert st1["threads"] == 1 and st4["threads"] == 4
    assert st1["rays"] == st4["rays"] == 32 * 32 * 4 and st1["mode"] == "path"
    assert 0.0 < float(img1.mean()) and float(img1.max()) <= 1.0
    assert st1["mean_luminance"] > 0.0


def test_trace_scene_equals_the_trace_of_its_dump(tmp_path, exe):
    scene, cam, _ = tgallery.config1(24, 16, device="cpu")
    img, stats = baseline.trace_scene(scene, cam, 24, 16, 2, 3, 2, mode="direct")
    path = str(tmp_path / "c1.txt")
    baseline.export_scene(scene, cam, path)
    np.testing.assert_array_equal(baseline.trace_dump(path, 24, 16, 2, 3, 2, "direct")[0], img)
    assert stats["mode"] == "direct" and stats["rays"] == 24 * 16 * 2


def test_demo_camera_and_demo_mode_match_jax(exe):
    w, h = 64, 36
    jcam, tcam = jdemo.build_demo_camera(w, h), tdemo.build_demo_camera(w, h, device="cpu")
    for f in ("raster_to_camera", "camera_to_world"):
        np.testing.assert_allclose(getattr(tcam, f).numpy(), np.asarray(getattr(jcam, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    port = baseline.trace_demo(w, h, 1, 3, 2)
    ref = baseline.trace_demo(w, h, 1, 3, 2, camera=jcam)
    assert port["rays"] == w * h and port["rays_per_s"] > 0.0
    assert port["mean_luminance"] == ref["mean_luminance"] > 0.0


def test_val_configs_and_settings_match_the_script():
    cv = _cross_validate()
    assert baseline.VAL_CONFIGS == cv.VAL_CONFIGS
    for c in baseline.VAL_CONFIGS:
        _, cam, got = baseline.check_config(c.name, device="cpu")
        _, jcam, want = jgallery.CONFIGS[c.name](c.width, c.height)
        want = want._replace(width=c.width, height=c.height, spp=c.spp, max_depth=c.depth,
                             samples_per_pass=min(4, c.spp), filter=jfilters.box_filter(0.5))
        for f in ("width", "height", "spp", "max_depth", "samples_per_pass", "seed",
                  "integrator", "rr_threshold", "light_strategy"):
            assert getattr(got, f) == getattr(want, f), (c.name, f)
        assert tuple(got.filter) == tuple(want.filter)
        assert got.integrator == ("direct" if c.mode == "direct" else "path")
        np.testing.assert_allclose(cam.raster_to_camera.numpy(),
                                   np.asarray(jcam.raster_to_camera), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compare_matches_the_script(seed):
    """``compare`` of seeded images against cross_validate.py's inline
    arithmetic (lines 200-206), ``region_means`` against its function."""
    cv = _cross_validate()
    r = np.random.default_rng(seed)
    h, w = (27, 48) if seed else (30, 30)
    img = r.uniform(0.0, 0.5, (h, w, 3)).astype(np.float32)
    img[: h // 3, : w // 3] *= 1e-4  # a near-black region: the floor of the denominator
    ref = np.clip(img * r.uniform(0.9, 1.1, img.shape), 0.0, 1.0).astype(np.float32)
    np.testing.assert_array_equal(baseline.region_means(img), cv.region_means(img))
    m_cpp, m_jax = ref.mean(), img.mean()
    rel_mean = abs(m_cpp - m_jax) / max(m_jax, 1e-6)
    rel_reg = np.abs(cv.region_means(ref) - cv.region_means(img)) / np.maximum(
        cv.region_means(img), 0.05 * m_jax)
    for mtol, rtol in ((0.02, 0.05), (rel_mean * 0.5, 1.0), (1.0, rel_reg.max() * 0.5)):
        row = baseline.compare(img, ref, mtol, rtol)
        assert row["mean_cpp"] == pytest.approx(float(m_cpp), rel=1e-6)
        assert row["mean_port"] == pytest.approx(float(m_jax), rel=1e-6)
        assert row["rel_mean"] == pytest.approx(float(rel_mean), rel=1e-4)
        assert row["max_rel_region"] == pytest.approx(float(rel_reg.max()), rel=1e-4)
        assert row["tol"] == [mtol, rtol]
        assert row["ok"] == bool(rel_mean < mtol and np.all(rel_reg < rtol))


def test_export_refuses_a_light_pick_that_is_not_uniform(tmp_path):
    b = SceneBuilder(light_strategy="power")
    b.sphere(torch.eye(4), 1.0, b.matte())
    b.point_light(p=(0.0, 3.0, 0.0), intensity=(10.0,) * 3)
    b.point_light(p=(2.0, 3.0, 0.0), intensity=(1.0,) * 3)
    scene = b.build(accelerator="none", device="cpu")
    cam = tgallery.config2(8, 8, device="cpu")[1]
    with pytest.raises(ValueError, match="uniform"):
        baseline.export_scene(scene, cam, str(tmp_path / "x.txt"))


def test_trace_dump_rejects_an_unknown_mode(tmp_path):
    with pytest.raises(ValueError, match="mode"):
        baseline.trace_dump(str(tmp_path / "none.txt"), 8, 8, 1, 1, 1, mode="bdpt")
