"""The port's tracer (``gopbrt_tpu_torch/utils/trace.py``), on the CPU at
tiny sizes:

- off, it keeps no record and opens no profiler range;
- spans nest, with their parents, under one request a ``render.render``;
- the ring keeps the last RING requests;
- its clock is the profiler's: each span lies within 50 us of its
  ``record_function`` twin in the kineto events (of one of a few sessions,
  where the host preempts the test);
- ``li_direct`` and ``_li_wavefront`` record the chain's three stage spans,
  and their lane counters equal a recount from the alive masks, bounce by
  bounce;
- under a profiler, the program runs the operations it runs with its
  counters cut out: the tracer adds none;
- host syncs count only where a card is involved.
"""

import collections
import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gopbrt_tpu_torch.models import demo, integrators, render
from gopbrt_tpu_torch.utils import trace

W, H = 32, 16
STAGES = {"li.intersect", "li.surface", "li.nee"}
SESSIONS = 5


@pytest.fixture(scope="module")
def demo_scene():
    return demo.build_demo_scene(device="cpu"), demo.build_demo_camera(W, H, "cpu")


@pytest.fixture
def tracing():
    trace.enable()
    try:
        yield
    finally:
        trace.disable()


def _settings(max_depth=2):
    return render.RenderSettings(width=W, height=H, spp=1, max_depth=max_depth,
                                 integrator="direct", chunk_pixels=W * H // 2)


def _render(demo_scene):
    scene, cam = demo_scene
    return render.render(scene, cam, _settings(), device="cpu")


def test_off_keeps_no_record_and_opens_no_range(demo_scene):
    assert not trace.on()
    assert trace.span("render.li") is trace.span("li.nee") is trace.request()
    before = [r.id for r in trace.requests()]
    _render(demo_scene)
    assert [r.id for r in trace.requests()] == before
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not {n for n in names if n.startswith(("render.", "li."))}


def test_spans_nest_under_one_request_a_render(demo_scene, tracing):
    _render(demo_scene)
    _render(demo_scene)
    reqs = trace.requests()[-2:]
    assert reqs[0].id != reqs[1].id
    for req in reqs:
        root = req.spans[0]
        assert (root.name, root.parent) == (trace.REQUEST, None)
        names = collections.Counter(s.name for s in req.spans)
        # two bands of one pass, each in its three ranges
        assert [names[n] for n in ("render.band_rays", "render.li", "render.splat")] == [2] * 3
        assert STAGES <= set(names)
        for i, s in enumerate(req.spans):
            assert s.request == req.id and s.start_ns <= s.end_ns
            if i == 0:
                continue
            p = req.spans[s.parent]
            assert s.parent < i and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            if s.name.startswith("render."):
                assert s.parent == 0
            if s.name in STAGES:
                chain = []
                while s.parent is not None:
                    s = req.spans[s.parent]
                    chain.append(s.name)
                assert "render.li" in chain
        # the shadow rays' intersections nest under NEE
        assert any(s.name == "li.intersect" and req.spans[s.parent].name == "li.nee"
                   for s in req.spans[1:])
        assert req.total("li.lanes_run") == 2 * (_settings().max_depth + 1) * W * H // 2


def test_the_ring_keeps_the_last_requests(tracing):
    n = trace.RING + 6
    for i in range(n):
        with trace.request():
            trace.count("i", i)
            trace.count("i", torch.tensor(1000))
    reqs = trace.requests()
    assert len(reqs) == trace.RING
    assert [r.counter("i")[None] for r in reqs] == [1000 + i for i in range(6, n)]
    # a read sums the tensors once and lets them go
    assert all(r.counters["i"][None] == [1000 + i] for r, i in zip(reqs, range(6, n)))
    assert [r.id for r in reqs] == sorted(r.id for r in reqs)


def _offsets(req, prof) -> list:
    """Each span's larger distance (ns) from its ``record_function`` twin,
    at start or end, the twins matched by name and order."""
    twins = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        twins[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    seen, out = collections.Counter(), []
    for s in req.spans:
        a, b = sorted(twins[s.name])[seen[s.name]]
        seen[s.name] += 1
        out.append(max(abs(s.start_ns - a), abs(s.end_ns - b)))
    assert seen[trace.REQUEST] == 1 and len(out) > 10
    return out


def test_spans_lie_on_the_profilers_clock(demo_scene):
    """A host that preempts the test can stamp a span late: the render is
    traced again, at most SESSIONS times, until each span (the same
    sequence each time) has lain within 50 us of its twin in a session; in
    every session the median does."""
    best = None
    for _ in range(SESSIONS):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("warm-up"):
                pass
            assert trace.on() and not trace.enabled()
            _render(demo_scene)
        assert not trace.on()
        offsets = _offsets(trace.requests()[-1], prof)
        assert statistics.median(offsets) <= 50_000, offsets
        best = offsets if best is None else [min(a, b) for a, b in zip(best, offsets)]
        if max(best) <= 50_000:
            break
    assert max(best) <= 50_000, best


@pytest.mark.parametrize("chain", ["li_direct", "_li_wavefront"])
def test_chain_stages_and_lane_counts(chain, demo_scene, tracing, monkeypatch):
    scene, cam = demo_scene
    settings = _settings(max_depth=3)
    _, o, d, pix, smp = render.band_rays(cam, settings, 0, H, 0)
    assert o.shape[0] <= 4096
    # the recount: the lanes alive entering each bounce, from the t_max
    # with which the bounce asks for their closest hits
    recount, real = [], integrators._scene_intersect

    def spy(scene, o, d, t_max, time=None):
        recount.append((int((t_max > 1.0).sum()), t_max.numel()))
        return real(scene, o, d, t_max, time)

    monkeypatch.setattr(integrators, "_scene_intersect", spy)
    cone = render._cone(cam, settings)
    with trace.request() as req:
        if chain == "li_direct":
            integrators.li_direct(scene, o, d, pix, smp, 7, max_depth=3, cone=cone)
        else:
            integrators._li_wavefront(scene, o, d, pix, smp, 7,
                                      integrators.PathConfig(max_depth=3), cone=cone)
    assert STAGES <= {s.name for s in req.spans}
    live, run = req.counter("li.lanes_live"), req.counter("li.lanes_run")
    assert sorted(live) == sorted(run) == list(range(len(recount)))
    assert [(live[k], run[k]) for k in sorted(live)] == recount
    # bounce 0 runs every lane; the direct chain keeps only specular ones
    assert recount[0] == (W * H, W * H) and recount[1][0] > 0
    if chain == "li_direct":
        assert len(recount) == 4 and recount[2][0] == recount[3][0] == 0


def _aten_ops(demo_scene) -> collections.Counter:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render(demo_scene)
    return collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                               if e.name().startswith("aten::"))


def test_the_tracer_adds_no_operation(demo_scene, monkeypatch):
    """A traced render runs the operations that it runs with the tracer's
    counters cut out: the lane counters keep their masks and sum them only
    when read."""
    with_counters = _aten_ops(demo_scene)
    req = trace.requests()[-1]
    assert req.total("li.lanes_live") > 0
    monkeypatch.setattr(trace, "count", lambda *args, **kw: None)
    monkeypatch.setattr(integrators, "_count_lanes", lambda *args: None)
    assert _aten_ops(demo_scene) == with_counters


def test_host_syncs_count_only_with_a_card(tracing):
    with trace.request() as req:
        assert trace.to_card(3, "cpu").item() == 3
        assert torch.equal(trace.to_card([1.0, 2.0], None, torch.float64),
                           torch.tensor([1.0, 2.0], dtype=torch.float64))
        assert trace.to_host(torch.tensor(5)).item() == 5
        trace.synchronize("cpu")
    assert req.counter("host_syncs") == {}
