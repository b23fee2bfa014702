"""The port's multi-process rendering (``gopbrt_tpu_torch/parallel/``)
against the port's own single-process render and the JAX package.

The ranks run in processes of their own, on gloo and the CPU
(``_torch_dist_worker.spawn``: three spawns in this file, of 2, 4 and 8
ranks, each shared by the tests that read it).  The scene is
``tests/test_sharding.py``'s tiny scene, built by the JAX builder and
carried to the port; 16x16, 2 spp, depth 2 (15x15 on eight bands).

Bars: a sharded image within 2e-5 of the port's ``render`` (the reference's
bar, ``tests/test_sharding.py:59``: the same streams, the film summed in
another order); against JAX's images the port's image bar (> 0.99 of
pixels within 1e-3 relative, mean relative difference < 2e-3,
``tests/test_torch_render.py:44-45``); the train step's gradient within
rtol 1e-4 / atol 1e-7 of single-process autograd (``tests/
test_sharding.py:141-143``) and within 2e-3 of max|g| of ``jax.grad``
(``tests/test_torch_grad_parity.py``).  The splat's accumulators against
JAX's within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_worker import spawn
from _torch_parity import carry, jax_scene_arrays, jax_scene_infos, lane_agreement
from gopbrt_tpu.models import camera as jcam
from gopbrt_tpu.models import film as jfilm
from gopbrt_tpu.models import render as jrender
from gopbrt_tpu.models.scene import SceneBuilder
from gopbrt_tpu.ops import filters as jfilters
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu.parallel import shard as jshard
from gopbrt_tpu_torch.models import camera as tcam
from gopbrt_tpu_torch.models import film as tfilm
from gopbrt_tpu_torch.models import render as trender
from gopbrt_tpu_torch.ops import filters as tfilters
from gopbrt_tpu_torch.ops import geom as tgeom
from gopbrt_tpu_torch.parallel import dist as tdist
from gopbrt_tpu_torch.parallel import shard as tshard

EYE, LOOK, UP, FOV = [0.0, 2.0, 6.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0], 45.0
SETTINGS = dict(width=16, height=16, spp=2, max_depth=2, samples_per_pass=1,
                compaction=False)
ODD = dict(SETTINGS, width=15, height=15)
MITCHELL = ("mitchell_filter", 2.0)
GRAD_BAR = 2e-3


def tiny_scene():
    """tests/test_sharding.py:21-28, on the JAX builder."""
    b = SceneBuilder()
    mat = b.matte(kd=(0.7, 0.4, 0.2))
    b.sphere(np.asarray(jgeom.translate([0.0, 1.0, 0.0])), 1.0, mat)
    floor = b.matte(kd=(0.5, 0.5, 0.5))
    b.disk(np.asarray(jgeom.rotate_x(-90.0)), 50.0, floor)
    b.point_light(p=(3.0, 8.0, 3.0), intensity=(80.0, 80.0, 80.0))
    return b.build(accelerator="none")


def jax_camera(size=16):
    return jcam.perspective_camera(jgeom.look_at(EYE, LOOK, UP), size, size, fov_deg=FOV)


def port_camera(size=16):
    return tcam.perspective_camera(tgeom.look_at(EYE, LOOK, UP), size, size, fov_deg=FOV,
                                   device="cpu")


def port_settings(kwargs):
    kwargs = dict(kwargs)
    if "filter" in kwargs:
        kwargs["filter"] = getattr(tfilters, kwargs["filter"][0])(*kwargs["filter"][1:])
    return trender.RenderSettings(**kwargs)


@pytest.fixture(scope="module")
def jscene():
    return tiny_scene()


@pytest.fixture(scope="module")
def tscene(jscene):
    return carry(jscene)


def _spec(jscene, mesh, size=16, renders=None, train=None):
    spec = {"mesh": mesh, "scene": (jax_scene_arrays(jscene), jax_scene_infos(jscene)),
            "camera": dict(eye=EYE, look=LOOK, up=UP, fov=FOV, width=size, height=size),
            "renders": renders or {}}
    if train is not None:
        spec["train"] = train
    return spec


def _both_films(kwargs):
    return {"band": (kwargs, True), "replicated": (kwargs, False)}


@pytest.fixture(scope="module")
def ranks(jscene, tmp_path_factory):
    """The three spawns, on first use: data 2 (2 samples a pass), data 2 x
    sample 2, and data 8 on the 15x15 image."""
    specs = {
        2: _spec(jscene, (2, 1), renders=_both_films(SETTINGS),
                 train={"settings": dict(SETTINGS, samples_per_pass=2), "lr": 5e-2,
                        "steps": 1}),
        4: _spec(jscene, (2, 2), renders=_both_films(SETTINGS),
                 train={"settings": SETTINGS, "lr": 5e-2, "steps": 5}),
        8: _spec(jscene, (8, 1), size=15,
                 renders={**_both_films(ODD),
                          "mitchell_band": (dict(ODD, filter=MITCHELL), True)}),
    }
    done = {}

    def get(world):
        if world not in done:
            done[world] = spawn(world, specs[world], tmp_path_factory.mktemp(f"ranks{world}"))
        return done[world]

    return get


@pytest.fixture(scope="module")
def port_image(tscene):
    return trender.render(tscene, port_camera(), port_settings(SETTINGS), device="cpu")


@pytest.fixture(scope="module")
def jax_image(jscene):
    return np.asarray(jrender.render(jscene, jax_camera(), jrender.RenderSettings(**SETTINGS)))


def _splat_inputs(seed, rows=5, width=16):
    rng = np.random.default_rng(seed)
    jitter = rng.uniform(0.0, 1.0, (rows, width, 2)).astype(np.float32)
    L = rng.uniform(0.0, 2.0, (rows, width, 3)).astype(np.float32)
    return jitter, L


@pytest.mark.parametrize("filt", [("box_filter", 1.0), MITCHELL], ids=["box", "mitchell"])
def test_splat_band_halo_matches_jax(filt):
    """A band of 5 rows from row 3 of a 6-row image: rows 6-7 lie past it."""
    jitter, L = _splat_inputs(5)
    jr, jw = jfilm.splat_band_halo(3, jnp.asarray(jitter), jnp.asarray(L), 6,
                                   getattr(jfilters, filt[0])(filt[1]))
    tr, tw = tfilm.splat_band_halo(3, torch.tensor(jitter), torch.tensor(L), 6,
                                   getattr(tfilters, filt[0])(filt[1]))
    rr = int(np.ceil(filt[1]))
    assert tuple(tr.shape) == (5 + 2 * rr, 16, 3) and tuple(tw.shape) == (5 + 2 * rr, 16)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    # rows 6-7 are masked: the taps of rows 3-5 end at accumulator row 2 + 2 rr
    assert float(tw[3 + 2 * rr:].abs().max()) == 0.0


def test_merge_matches_jax():
    rng = np.random.default_rng(9)
    a = [rng.uniform(0, 1, s).astype(np.float32) for s in ((4, 5, 3), (4, 5))]
    b = [rng.uniform(0, 1, s).astype(np.float32) for s in ((4, 5, 3), (4, 5))]
    j = jfilm.merge(jfilm.Film(*map(jnp.asarray, a)), jfilm.Film(*map(jnp.asarray, b)))
    t = tfilm.merge(tfilm.Film(*map(torch.tensor, a)), tfilm.Film(*map(torch.tensor, b)))
    np.testing.assert_allclose(t.rgb.numpy(), np.asarray(j.rgb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.weight.numpy(), np.asarray(j.weight), rtol=0, atol=1e-6)


def test_add_samples_rows_folds_the_halo_splat():
    """The dense splat folds exactly the accumulators of splat_band_halo."""
    jitter, L = _splat_inputs(6)
    filt = tfilters.mitchell_filter(2.0)
    film = tfilm.add_samples_rows(tfilm.new_film(16, 6, device="cpu"), 3,
                                  torch.tensor(jitter), torch.tensor(L), filt)
    r, w = tfilm.splat_band_halo(3, torch.tensor(jitter), torch.tensor(L), 6, filt)
    torch.testing.assert_close(film.rgb[1:6], r[:5], rtol=0, atol=0)
    torch.testing.assert_close(film.weight[1:6], w[:5], rtol=0, atol=0)
    assert float(film.weight[0].abs().max()) == 0.0


def test_world_one_without_a_group(tscene, port_image, monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.init_distributed(device="cpu") is False
    mesh = tshard.make_mesh(device="cpu")
    assert (mesh.world, mesh.distributed) == (1, False)
    settings = port_settings(dict(SETTINGS, chunk_pixels=16 * 5))  # bands of 5 rows
    for band_film in (True, False):
        img = tshard.render_sharded(mesh, tscene, port_camera(), settings, band_film=band_film)
        np.testing.assert_allclose(img.numpy(), port_image.numpy(), rtol=0, atol=2e-5)


CASES = [(2, "band"), (2, "replicated"), (4, "band"), (4, "replicated")]
CASE_IDS = [f"{w}ranks-{m}" for w, m in CASES]


@pytest.mark.parametrize("world,mode", CASES, ids=CASE_IDS)
def test_sharded_render_matches_render(ranks, port_image, world, mode):
    res = ranks(world)
    for r in res:  # the image is on every rank
        np.testing.assert_allclose(r[mode].numpy(), port_image.numpy(), rtol=0, atol=2e-5)
    assert port_image.numpy().max() > 0.1


@pytest.mark.parametrize("world,mode", CASES, ids=CASE_IDS)
def test_sharded_render_matches_jax_render(ranks, jax_image, world, mode):
    img = ranks(world)[0][mode].numpy()
    assert img.shape == jax_image.shape and jax_image.mean() > 0.01
    frac, mean_rel = lane_agreement(img.reshape(-1, 3), jax_image.reshape(-1, 3))
    assert frac > 0.99 and mean_rel < 2e-3, (frac, mean_rel)


def test_matches_jax_render_sharded(ranks, jscene):
    """JAX's own band-film render on a data 2 x sample 2 mesh of virtual CPU
    devices against the port's four ranks."""
    mesh = jshard.make_mesh(data=2, sample=2, devices=jax.devices()[:4])
    jimg = np.asarray(jshard.render_sharded(mesh, jscene, jax_camera(),
                                            jrender.RenderSettings(**SETTINGS)))
    img = ranks(4)[0]["band"].numpy()
    frac, mean_rel = lane_agreement(img.reshape(-1, 3), jimg.reshape(-1, 3))
    assert frac > 0.99 and mean_rel < 2e-3, (frac, mean_rel)


def test_mesh_coordinates(ranks):
    """Rank r at (r // sample, r % sample): the reference's row-major
    reshape(data, sample) of its devices."""
    assert [(r["d_idx"], r["s_idx"]) for r in ranks(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [(r["d_idx"], r["s_idx"]) for r in ranks(2)] == [(0, 0), (1, 0)]


@pytest.mark.parametrize("mode", ["band", "replicated", "mitchell_band"])
def test_nondivisible_height_on_eight_bands(ranks, tscene, mode):
    """15x15 on eight bands of 2 rows: the last band's second row is padding,
    every band's halo rows cross to its neighbours (two of them with the
    Mitchell filter's radius 2)."""
    kwargs = dict(ODD, filter=MITCHELL) if mode.startswith("mitchell") else ODD
    single = trender.render(tscene, port_camera(15), port_settings(kwargs), device="cpu")
    for r in ranks(8):
        np.testing.assert_allclose(r[mode].numpy(), single.numpy(), rtol=0, atol=2e-5)


def test_band_film_holds_only_its_band(ranks):
    assert all(r["band_band_rows"] == 2 for r in ranks(8))  # 16 padded rows / 8
    assert all(r["band_band_rows"] == 8 for r in ranks(2))


def _port_grad(tscene):
    """Single-process autograd of tests/test_sharding.py's sd_loss."""
    kd = tscene.materials.kd.clone().requires_grad_(True)
    sc = tscene._replace(materials=tscene.materials._replace(kd=kd))
    film = tfilm.new_film(16, 16, device="cpu")
    pix = torch.arange(256)
    for s in range(2):
        film = trender.render_wave(sc, port_camera(), film, port_settings(SETTINGS), pix,
                                   torch.full((256,), s))
    img = film.rgb / torch.clamp(film.weight[..., None], min=1e-8)
    torch.mean(img ** 2).backward()
    return kd.grad.numpy()


def _jax_grad(jscene):
    """jax.grad of sd_loss (tests/test_sharding.py:105-114)."""
    cam, settings = jax_camera(), jrender.RenderSettings(**SETTINGS)

    def sd_loss(kd):
        sc = jscene._replace(materials=jscene.materials._replace(kd=kd))
        f = jfilm.new_film(16, 16)
        pix = jnp.arange(256, dtype=jnp.uint32)
        for s in range(2):
            f = jrender.render_wave(sc, cam, f, settings, pix, jnp.full((256,), s, jnp.uint32))
        img = f.rgb / jnp.maximum(f.weight[..., None], 1e-8)
        return jnp.mean(img ** 2)

    return np.asarray(jax.grad(sd_loss)(jscene.materials.kd))


@pytest.fixture(scope="module")
def grads(jscene, tscene):
    return _port_grad(tscene), _jax_grad(jscene)


@pytest.mark.parametrize("world", [2, 4])
def test_train_step_gradient_matches_single_process(ranks, grads, world):
    port, _ = grads
    assert np.abs(port).max() > 0
    for r in ranks(world):  # every rank holds the same mean gradient
        np.testing.assert_allclose(r["grad"].numpy(), port, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("world", [2, 4])
def test_train_step_gradient_matches_jax(ranks, grads, world):
    _, ref = grads
    got = ranks(world)[0]["grad"].numpy()
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= GRAD_BAR * scale, (np.abs(got - ref).max(), scale)


def test_train_step_descends(ranks, tscene):
    """tests/test_sharding.py:147-167: Adam toward a black target, 5 steps."""
    res = ranks(4)
    losses = res[0]["losses"]
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert float(res[0]["kd"].mean()) < float(tscene.materials.kd.mean())
    for r in res[1:]:  # the ranks step in lockstep
        assert r["losses"] == losses
        torch.testing.assert_close(r["kd"], res[0]["kd"], rtol=0, atol=0)
