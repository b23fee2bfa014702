"""The render options and leaves of the port against gopbrt_tpu's.

The radical inverse (bit for bit, values at and above 2^31, base 3's
wrapping digits), the sampling leaves, the filters, the geometry and
bounds leaves, the orthographic and look-at cameras and the camera
adjoints (tests/test_features.py's cases), ``lights.sample_le``, the
Halton jitter, crop windows and checkpoints (tests/test_features.py:
270-330), at small sizes; the same inputs, made from a numpy seed, go
through both packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import lane_agreement
from gopbrt_tpu.models import camera as jcam
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.models import film as jfilm
from gopbrt_tpu.models import render as jrender
from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
from gopbrt_tpu.ops import filters as jfilters
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu.ops import lights as jlights
from gopbrt_tpu.ops import sampling as jsampling
from gopbrt_tpu_torch.models import camera as tcam
from gopbrt_tpu_torch.models import demo as tdemo
from gopbrt_tpu_torch.models import film as tfilm
from gopbrt_tpu_torch.models import render as trender
from gopbrt_tpu_torch.models.scene import SceneBuilder
from gopbrt_tpu_torch.ops import filters as tfilters
from gopbrt_tpu_torch.ops import geom as tgeom
from gopbrt_tpu_torch.ops import lights as tlights
from gopbrt_tpu_torch.ops import sampling as tsampling
from gopbrt_tpu_torch.utils.progress import NullProgress, StdoutProgress


def _close(got, want, atol=1e-6, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _u32_inputs():
    r = np.random.default_rng(0)
    a = r.integers(0, 1 << 32, 2000, dtype=np.uint64)
    edge = [0, 1, 2, 3, (1 << 31) - 1, 1 << 31, (1 << 31) + 1, (1 << 32) - 1,
            3 ** 20, 3 ** 20 + 7, 2 * 3 ** 20, (1 << 32) - 3]
    return np.concatenate([np.asarray(edge, np.uint64), a]).astype(np.uint32)


def test_reverse_bits_32_bit_for_bit():
    a = _u32_inputs()
    got = tsampling.reverse_bits_32(torch.tensor(a.astype(np.int64))).numpy()
    want = np.asarray(jsampling.reverse_bits_32(jnp.asarray(a))).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    assert got.max() >= 1 << 31


@pytest.mark.parametrize("base_index", [0, 1, 2, 5, 63])
def test_radical_inverse_bit_for_bit(base_index):
    """Base 3 (index 1) wraps rev * 3 + digit past 2^32 on its 21st digit."""
    a = _u32_inputs()
    got = tsampling.radical_inverse(base_index, torch.tensor(a.astype(np.int64))).numpy()
    want = np.asarray(jsampling.radical_inverse(base_index, jnp.asarray(a)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got < 1.0).all() and (got >= 0.0).all()


def test_sampling_leaves_match():
    r = np.random.default_rng(1)
    u = r.random((500, 2)).astype(np.float32)
    tu, ju = torch.tensor(u), jnp.asarray(u)
    _close(tsampling.uniform_sample_hemisphere(tu), jsampling.uniform_sample_hemisphere(ju))
    _close(tsampling.uniform_sample_triangle(tu), jsampling.uniform_sample_triangle(ju))
    assert tsampling.uniform_hemisphere_pdf() == pytest.approx(
        jsampling.uniform_hemisphere_pdf(), rel=1e-12)
    assert tsampling.uniform_sphere_pdf() == pytest.approx(jsampling.uniform_sphere_pdf(),
                                                           rel=1e-12)
    _close(tsampling.cosine_hemisphere_pdf(tu[:, 0]),
           jsampling.cosine_hemisphere_pdf(ju[:, 0]))
    _close(tsampling.balance_heuristic(1, tu[:, 0], 2, tu[:, 1] + 0.1),
           jsampling.balance_heuristic(1, ju[:, 0], 2, ju[:, 1] + 0.1))
    w = np.asarray([0.5, 3.0, 0.0, 1.5], np.float32)
    tdist = tsampling.distribution_1d(torch.tensor(w))
    jdist = jsampling.distribution_1d(jnp.asarray(w))
    for g, j in zip(tsampling.sample_continuous(*tdist, tu[:, 0]),
                    jsampling.sample_continuous(*jdist, ju[:, 0])):
        _close(g, j)
    rows = r.random((500, 5)).astype(np.float32)
    rows[:3] = 0.0  # all-zero rows take the uniform fallback
    tf, tc, ti = tsampling.distribution_1d(torch.tensor(rows))
    jf, jc, ji = jsampling.distribution_1d(jnp.asarray(rows))
    idx_t, pmf_t = tsampling.sample_discrete_rows(tf, tc, ti, tu[:, 0])
    idx_j, pmf_j = jsampling.sample_discrete_rows(jf, jc, ji, ju[:, 0])
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(pmf_t, pmf_j)
    _close(tsampling.pmf_rows(tf, ti, idx_t), jsampling.pmf_rows(jf, ji, idx_j))


@pytest.mark.parametrize("make", [
    lambda m: m.box_filter(1.0),
    lambda m: m.triangle_filter(2.0),
    lambda m: m.gaussian_filter(2.0, 2.0),
    lambda m: m.mitchell_filter(2.0),
    lambda m: m.mitchell_filter(1.5, b=0.5, c=0.25),
    lambda m: m.lanczos_filter(4.0, 3.0),
])
def test_filters_match(make):
    r = np.random.default_rng(4)
    dx, dy = (r.random((2, 2000)) * 10.0 - 5.0).astype(np.float32)
    dx[:4] = [0.0, 1e-6, 2.0, -4.0]
    got = tfilters.evaluate(make(tfilters), torch.tensor(dx), torch.tensor(dy))
    want = jfilters.evaluate(make(jfilters), jnp.asarray(dx), jnp.asarray(dy))
    _close(got, want, atol=1e-6, rtol=0.0)


def test_geom_leaves_match():
    r = np.random.default_rng(5)
    axis = r.normal(size=3)
    _close(tgeom.rotate(37.0, axis), jgeom.rotate(37.0, axis))
    _close(tgeom.rotate_z(-63.0), jgeom.rotate_z(-63.0))
    _close(tgeom.orthographic(0.5, 3.0), jgeom.orthographic(0.5, 3.0))
    _close(tgeom.identity(), jgeom.identity())
    m = np.asarray(jgeom.matmul(jgeom.translate([1.0, -2.0, 0.5]), jgeom.rotate(20.0, axis)))
    _close(tgeom.transpose(torch.tensor(m)), jgeom.transpose(jnp.asarray(m)))
    a, b = r.normal(size=(2, 100, 3)).astype(np.float32)
    t = r.random(100).astype(np.float32)
    ta, tb, tt = torch.tensor(a), torch.tensor(b), torch.tensor(t)
    ja, jb, jt = jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)
    _close(tgeom.lerp(tt[:, None], ta, tb), jgeom.lerp(jt[:, None], ja, jb))
    _close(tgeom.distance(ta, tb), jgeom.distance(ja, jb))
    _close(tgeom.ray_at(ta, tb, tt), jgeom.ray_at(ja, jb, jt))
    for g, j in zip(tgeom.apply_ray(torch.tensor(m), ta, tb), jgeom.apply_ray(jnp.asarray(m), ja, jb)):
        _close(g, j, atol=1e-5)
    flip = np.diag([1.0, -1.0, 1.0, 1.0]).astype(np.float32)
    assert not bool(tgeom.swaps_handedness(torch.tensor(m)))
    assert bool(tgeom.swaps_handedness(torch.tensor(flip))) == bool(
        jgeom.swaps_handedness(jnp.asarray(flip)))
    lo, hi = np.sort(r.normal(size=(2, 3)), axis=0).astype(np.float32)
    tlo, thi, jlo, jhi = torch.tensor(lo), torch.tensor(hi), jnp.asarray(lo), jnp.asarray(hi)
    for g, j in zip(tgeom.bounds_empty(), jgeom.bounds_empty()):
        _close(g, j)
    for g, j in zip(tgeom.bounds_union(tlo, thi, ta[0], tb[0] + 3),
                    jgeom.bounds_union(jlo, jhi, ja[0], jb[0] + 3)):
        _close(g, j)
    for g, j in zip(tgeom.bounds_union_point(tlo, thi, ta[1]),
                    jgeom.bounds_union_point(jlo, jhi, ja[1])):
        _close(g, j)
    _close(tgeom.bounds_diagonal(tlo, thi), jgeom.bounds_diagonal(jlo, jhi))
    _close(tgeom.bounds_surface_area(tlo, thi), jgeom.bounds_surface_area(jlo, jhi))
    _close(tgeom.bounds_centroid(tlo, thi), jgeom.bounds_centroid(jlo, jhi))
    for g, j in zip(tgeom.bounds_bounding_sphere(tlo, thi),
                    jgeom.bounds_bounding_sphere(jlo, jhi)):
        _close(g, j)
    for g, j in zip(tgeom.bounds_transform(torch.tensor(m), tlo, thi),
                    jgeom.bounds_transform(jnp.asarray(m), jlo, jhi)):
        _close(g, j, atol=1e-5)


def _film_points(w, h, n=300, seed=6):
    r = np.random.default_rng(seed)
    p = (r.random((n, 2)) * [w, h]).astype(np.float32)
    return p, r.random((n, 2)).astype(np.float32)


@pytest.mark.parametrize("kind", ["orthographic", "orthographic_lens", "look_at",
                                  "look_at_lens"])
def test_camera_rays_match(kind):
    w, h = 48, 32
    eye, look, up = [1.0, 2.0, -5.0], [0.0, 0.5, 0.0], [0.0, 1.0, 0.0]
    lens = dict(lens_radius=0.2, focal_distance=4.0) if kind.endswith("_lens") else {}
    if kind.startswith("orthographic"):
        jc = jcam.orthographic_camera(jgeom.look_at(eye, look, up), w, h, **lens)
        tc = tcam.orthographic_camera(tgeom.look_at(eye, look, up), w, h, device="cpu",
                                      **lens)
    else:
        jc = jcam.look_at_camera(eye, look, up, width=w, height=h, fov_deg=50.0, **lens)
        tc = tcam.look_at_camera(eye, look, up, width=w, height=h, fov_deg=50.0,
                                 device="cpu", **lens)
    _close(tc.raster_to_camera, jc.raster_to_camera)
    p, u = _film_points(w, h)
    for g, j in zip(tcam.generate_rays(tc, torch.tensor(p), torch.tensor(u)),
                    jcam.generate_rays(jc, jnp.asarray(p), jnp.asarray(u))):
        _close(g, j, atol=1e-6, rtol=1e-6)
    assert tcam.pixel_spread(tc) == pytest.approx(
        tuple(float(x) for x in jcam.pixel_spread(jc)), rel=1e-6, abs=1e-9)


def _adjoint_cameras(w=64, h=48, lens_radius=0.0):
    """tests/test_features.py's camera, and one with a lens."""
    lens = dict(lens_radius=lens_radius, focal_distance=5.0) if lens_radius else {}
    return (jcam.perspective_camera(jgeom.look_at([0, 0, -5], [0, 0, 0], [0, 1, 0]), w, h,
                                    fov_deg=60.0, **lens),
            tcam.perspective_camera(tgeom.look_at([0, 0, -5], [0, 0, 0], [0, 1, 0]), w, h,
                                    fov_deg=60.0, device="cpu", **lens))


@pytest.mark.parametrize("lens_radius", [0.0, 0.3])
def test_camera_adjoints_match(lens_radius):
    """We, PdfWe and SampleWi against the JAX package on camera rays (inside
    the frustum), rays pointing away and rays off the film."""
    w, h = 64, 48
    jc, tc = _adjoint_cameras(w, h, lens_radius)
    p, u = _film_points(w, h, seed=8)
    p[:3] = [[10.5, 20.5], [32.0, 24.0], [63.0, 47.0]]
    jo, jd = jcam.generate_rays(jc, jnp.asarray(p), jnp.asarray(u))
    o, d = np.array(jo), np.array(jd)
    d[-20:] = -d[-20:]  # backwards
    d[-40:-20, 0] += 3.0  # off the film
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    to, td, jo, jd = torch.tensor(o), torch.tensor(d), jnp.asarray(o), jnp.asarray(d)
    w_t, r_t = tcam.we(tc, w, h, to, td)
    w_j, r_j = jcam.we(jc, w, h, jo, jd)
    _close(w_t, w_j, rtol=2e-5, atol=0.0)
    _close(r_t, r_j, atol=2e-3, rtol=1e-5)
    assert (w_t.numpy()[:3] > 0).all() and (w_t.numpy()[-20:] == 0).all()
    for g, j in zip(tcam.pdf_we(tc, w, h, to, td), jcam.pdf_we(jc, w, h, jo, jd)):
        _close(g, j, rtol=2e-5, atol=0.0)
    ref_p = np.random.default_rng(9).normal(size=(200, 3)).astype(np.float32) * 2.0
    ref_p[0] = 0.0
    for g, j in zip(tcam.sample_wi(tc, w, h, torch.tensor(ref_p), torch.tensor(u[:200])),
                    jcam.sample_wi(jc, w, h, jnp.asarray(ref_p), jnp.asarray(u[:200]))):
        _close(g, j, rtol=2e-5, atol=2e-5)


def _le_scene(builder_cls, geom, kind):
    b = builder_cls()
    b.matte()
    if kind == "point":
        b.sphere(geom.translate([0, 0, 0]), 1.0, 0)
        b.point_light(p=(1.0, 2.0, 3.0), intensity=(5.0, 5.0, 5.0))
    elif kind == "distant":
        b.sphere(geom.translate([0, 0, 0]), 1.0, 0)
        b.distant_light(direction=(0.0, 1.0, 0.0), radiance=(2.0, 2.0, 2.0))
    elif kind == "sphere":
        pid = b.sphere(geom.translate([0, 0, 0]), 2.0, 0)
        b.area_light(pid, radiance=(3.0, 3.0, 3.0))
    else:
        pid = b.disk(geom.matmul(geom.translate([0.0, 3.0, 0.0]), geom.rotate_x(70.0)), 1.5, 0)
        b.area_light(pid, radiance=(3.0, 2.0, 1.0), two_sided=True)
    return b


@pytest.mark.parametrize("kind", ["point", "distant", "sphere", "disk_two_sided"])
def test_sample_le_matches(kind):
    """Light.SampleLe against the JAX package (tests/test_features.py:23-100's
    lights, and a two-sided disk)."""
    js = _le_scene(JaxBuilder, jgeom, kind).build(accelerator="none")
    ts = _le_scene(SceneBuilder, tgeom, kind).build(device="cpu")
    r = np.random.default_rng(10)
    u1, u2 = r.random((2, 400, 2)).astype(np.float32)
    idx = np.zeros(400, np.int32)
    got = tlights.sample_le(ts.lights, torch.tensor(idx), torch.tensor(u1), torch.tensor(u2),
                            ts.world_center, ts.world_radius)
    want = jlights.sample_le(js.lights, jnp.asarray(idx), jnp.asarray(u1), jnp.asarray(u2),
                             js.world_center, js.world_radius)
    for f in got._fields:
        _close(getattr(got, f), getattr(want, f), atol=2e-5, rtol=2e-5)
    if kind == "point":  # 4 pi I: exact per sample
        est = got.le / (got.pdf_pos * got.pdf_dir)[..., None]
        _close(est.mean(dim=0), np.full(3, 4.0 * np.pi * 5.0), rtol=1e-5, atol=0.0)


def test_halton_jitter_bit_for_bit():
    """The Halton camera samples, Cranley-Patterson rotated per pixel, are
    the JAX package's bit for bit (and stratify pixel 0's 16 samples)."""
    settings = dict(width=8, height=8, spp=16, sampler="halton")
    pixel = np.repeat(np.arange(64), 16).astype(np.uint32)
    sample = np.tile(np.arange(16), 64).astype(np.uint32)
    sample[-5:] = [1 << 31, (1 << 32) - 1, 3 ** 20, 12345678, 7]
    jp, ju = jrender.camera_samples(jrender.RenderSettings(**settings), jnp.asarray(pixel),
                                    jnp.asarray(sample), jnp.uint32(3))
    tp, tu = trender.camera_samples(trender.RenderSettings(**settings),
                                    torch.tensor(pixel.astype(np.int64)),
                                    torch.tensor(sample.astype(np.int64)), 3)
    np.testing.assert_array_equal(tp.numpy().view(np.int32), np.asarray(jp).view(np.int32))
    np.testing.assert_array_equal(tu.numpy().view(np.int32), np.asarray(ju).view(np.int32))
    strata = np.floor(tp.numpy()[:16, 0] * 16).astype(int)
    assert sorted(strata.tolist()) == list(range(16))


W, H = 40, 24
KW = dict(width=W, height=H, max_depth=3, chunk_pixels=8 * W)


@pytest.fixture(scope="module")
def demo():
    return (jdemo.build_demo_scene(accelerator="none"), jdemo.build_demo_camera(W, H),
            tdemo.build_demo_scene(device="cpu"), tdemo.build_demo_camera(W, H, device="cpu"))


def test_crop_render_matches_jax_and_the_full_interior(demo):
    """A crop render against JAX's crop render (render_wave, the scatter
    splat), and against the same region of the port's full render: the
    interior pixels, whose splat taps all lie in the crop, are equal."""
    js, jc, ts, tc = demo
    crop = ((0.25, 0.25), (0.75, 0.75))
    jimg = np.asarray(jrender.render(js, jc, jrender.RenderSettings(spp=2, crop=crop, **KW)))
    timg = trender.render(ts, tc, trender.RenderSettings(spp=2, crop=crop, **KW),
                          device="cpu").numpy()
    x0, x1, y0, y1 = trender.crop_pixel_bounds(trender.RenderSettings(crop=crop, **KW))
    assert (x0, x1, y0, y1) == jrender.crop_pixel_bounds(jrender.RenderSettings(crop=crop,
                                                                                **KW))
    assert timg.shape == jimg.shape == (y1 - y0, x1 - x0, 3)
    frac, mean_rel = lane_agreement(timg.reshape(-1, 3), jimg.reshape(-1, 3))
    assert frac > 0.99 and mean_rel < 2e-3, (frac, mean_rel)
    full = trender.render(ts, tc, trender.RenderSettings(spp=2, **KW), device="cpu").numpy()
    inner = timg[1:-1, 1:-1]
    np.testing.assert_allclose(inner, full[y0 + 1:y1 - 1, x0 + 1:x1 - 1], atol=1e-6)


def _small_scene(builder_cls, geom, **kw):
    b = builder_cls()
    b.sphere(geom.translate([0, 0, 0]), 1.0, b.matte(kd=(0.7, 0.4, 0.2)))
    b.point_light(p=(3, 3, -3), intensity=(40, 40, 40))
    return b.build(accelerator="none", **kw)


CK = dict(width=16, height=12, spp=4, max_depth=2, samples_per_pass=1)


def _ck_camera(mod, geom, **kw):
    return mod.perspective_camera(geom.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]), 16, 12,
                                  fov_deg=60.0, **kw)


def test_checkpoint_resume_gives_the_uninterrupted_image(tmp_path):
    """Passes 1-2 saved, the render resumed: only passes 3 and 4 run, and
    the image is the uninterrupted render's (tests/test_features.py:
    270-317); progress is called once a pass."""
    scene = _small_scene(SceneBuilder, tgeom, device="cpu")
    cam = _ck_camera(tcam, tgeom, device="cpu")
    settings = trender.RenderSettings(**CK)
    calls = []
    ref = trender.render(scene, cam, settings, progress=lambda p, n: calls.append((p, n)),
                         device="cpu")
    assert calls == [(1, 4), (2, 4), (3, 4), (4, 4)]
    ck = str(tmp_path / "film.ckpt")
    film = tfilm.new_film(16, 12, device="cpu")
    for p in range(2):
        film = trender.render_pass(scene, cam, film, settings, p, device="cpu")
    trender._save_checkpoint(ck, settings, film, 2)
    calls.clear()
    out = trender.render(scene, cam, settings, progress=lambda p, n: calls.append(p),
                         checkpoint_path=ck, device="cpu")
    assert calls == [3, 4]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)
    with np.load(ck) as z:  # the final checkpoint: every pass done
        assert int(z["next_pass"]) == 4 and sorted(z.files) == ["key", "next_pass", "rgb",
                                                                 "weight"]
    assert not os.path.exists(ck + ".tmp.npz")


def test_checkpoint_written_by_jax_resumes_in_the_port(tmp_path):
    """The npz the JAX package writes after 2 of 4 passes resumes in the
    port (same fields, same key), which renders passes 3 and 4 only."""
    js = _small_scene(JaxBuilder, jgeom)
    jc = _ck_camera(jcam, jgeom)
    jset = jrender.RenderSettings(**CK)
    ck = str(tmp_path / "film.ckpt")
    film = jfilm.new_film(16, 12)
    for p in range(2):
        film = jrender.render_pass(js, jc, film, jset, jnp.uint32(p))
    jrender._save_checkpoint(ck, jset, film, 2)
    want = np.asarray(jrender.render(js, jc, jset))
    calls = []
    got = trender.render(_small_scene(SceneBuilder, tgeom, device="cpu"),
                         _ck_camera(tcam, tgeom, device="cpu"), trender.RenderSettings(**CK),
                         progress=lambda p, n: calls.append(p), checkpoint_path=ck,
                         device="cpu")
    assert calls == [3, 4]
    frac, mean_rel = lane_agreement(got.numpy().reshape(-1, 3), want.reshape(-1, 3))
    assert frac > 0.99 and mean_rel < 2e-3, (frac, mean_rel)


def test_checkpoint_of_other_settings_is_ignored(tmp_path):
    ck = str(tmp_path / "film.ckpt")
    s1 = trender.RenderSettings(width=16, height=12, spp=4)
    s2 = trender.RenderSettings(width=16, height=12, spp=8)
    film = tfilm.new_film(16, 12, device="cpu")
    trender._save_checkpoint(ck, s1, film._replace(weight=film.weight + 1.0), 3)
    assert trender._load_checkpoint(ck, s2, "cpu") is None
    loaded, nxt = trender._load_checkpoint(ck, s1, "cpu")
    assert nxt == 3 and float(loaded.weight.min()) == 1.0
    assert trender._checkpoint_key(s1) == jrender._checkpoint_key(
        jrender.RenderSettings(width=16, height=12, spp=4))
    with open(ck, "wb") as f:
        f.write(b"not an npz")
    assert trender._load_checkpoint(ck, s1, "cpu") is None


def test_progress_reporters(capsys):
    p = StdoutProgress("port")
    for i in range(1, 4):
        p(i, 3)
    out = capsys.readouterr().out
    assert "[port] start" in out and "100.0%" in out and "done in" in out
    NullProgress()(1, 2)
    assert capsys.readouterr().out == ""


def test_options_render_matches_jax(demo):
    """Halton sampling and a Mitchell filter through both packages' render."""
    js, jc, ts, tc = demo
    kw = dict(KW, spp=2, sampler="halton")
    jimg = np.asarray(jrender.render(
        js, jc, jrender.RenderSettings(filter=jfilters.mitchell_filter(2.0), **kw)))
    timg = trender.render(ts, tc, trender.RenderSettings(filter=tfilters.mitchell_filter(2.0),
                                                         **kw), device="cpu").numpy()
    frac, mean_rel = lane_agreement(timg.reshape(-1, 3), jimg.reshape(-1, 3))
    assert frac > 0.99 and mean_rel < 2e-3, (frac, mean_rel)
    assert np.isfinite(jimg).all() and jimg.mean() > 0.01
