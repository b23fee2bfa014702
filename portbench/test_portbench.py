"""The benchmark's own tests, on the CPU at small sizes:

    python3 -m pytest portbench/test_portbench.py -q

- the manifest against the contract's names, units and files;
- the end-to-end and per-layer arithmetic on synthetic frames and traces;
- the reference against the program's plain path;
- the check's control (the reference in bfloat16) and planted faults in the
  program's timed path, each of which must make ``correct`` false;
- that no run loads JAX or the JAX package, and that the reference loads
  nothing of the program.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import check
import devtrace
import faults
import harness
import roofline

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = {"width": 32, "height": 18, "chunk_pixels": 32 * 4}


def cell(name: str) -> harness.Cell:
    return harness.load_cell(MANIFEST, name)


def small_run(name: str, seed: int = 2**31 + 5) -> dict:
    c = cell(name)
    c = dataclasses.replace(c, traffic={**c.traffic, "settings": {**c.traffic["settings"],
                                                                  **SMALL}})
    return harness.run(c, seed, 0.2, False, time.perf_counter(), device="cpu",
                       log=lambda m: None)


# --------------------------------------------------------------------------
# The manifest


def test_manifest_keys_names_units_and_files():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "portbench/run.py"] and m["paths"] == ["portbench"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024
    names = [c["name"] for c in m["configs"]] + CELLS + [
        x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json" and c["reduced"] == []
        assert (ROOT / c["file"]).exists() and (HERE / "configs" / f"{c['name']}.py").exists()
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in m["workloads"])
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}" and len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (HERE / "checks" / f"{w['name']}.json").exists()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(m["workloads"])
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] == "host_clock"
        assert (HERE / "e2e" / f"{x['name']}.py").exists()
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert x["moves"] in e2e and x["source"] in ("device_trace", "program_span",
                                                      "program_counter", "host_clock")
        assert (HERE / "metrics" / f"{x['name']}.py").exists()
        for w in x.get("workloads", []):
            assert w in CELLS and w in e2e[x["moves"]].get("workloads", CELLS)
    for w in CELLS:
        c = cell(w)
        assert any(x["name"] == "setup_s" for x in c.end_to_end) and len(c.end_to_end) >= 2
        assert c.per_layer
        # each per-layer metric of a cell moves an end-to-end metric the cell reports
        assert {x["moves"] for x in c.per_layer} <= {x["name"] for x in c.end_to_end}
    # a metric without a list of cells is read in every cell that reports what it moves
    for x in m["per_layer"]:
        if "workloads" not in x:
            for w in CELLS:
                reports = w in e2e[x["moves"]].get("workloads", CELLS)
                assert (x in cell(w).per_layer) == reports


# --------------------------------------------------------------------------
# The arithmetic of the metrics


def window(frame_s, start=100.0, gaps=None):
    """A Window of back-to-back frames of the given seconds."""
    frames, t = [], start
    for i, s in enumerate(frame_s):
        t += (gaps or {}).get(i, 0.0)
        frames.append((t, t + s))
        t += s
    return harness.Window(setup_s=12.5, start=start, frames=frames,
                          rays_per_frame=1920 * 1080)


def test_end_to_end_arithmetic_and_a_stall():
    rays = harness.reader("e2e", "camera_rays_per_s")
    p95 = harness.reader("e2e", "frame_ms_p95")
    setup = harness.reader("e2e", "setup_s")
    steady = window([0.05] * 200)
    assert rays.read(steady) == pytest.approx(1920 * 1080 / 0.05)
    assert p95.read(steady) == pytest.approx(50.0)
    assert setup.read(steady) == 12.5
    # one frame stalled by 1 s inside the window
    stalled = window([0.05] * 99 + [1.05] + [0.05] * 100)
    assert rays.read(stalled) == pytest.approx(1920 * 1080 * 200 / 11.0)
    # a stall between frames (the host busy elsewhere) counts too
    gap = window([0.05] * 200, gaps={100: 1.0})
    assert rays.read(gap) == pytest.approx(rays.read(stalled))
    # fifteen slow frames of 200 set the 95th percentile
    slow = window([0.05] * 185 + [0.2] * 15)
    assert p95.read(slow) == pytest.approx(200.0)


def frame(busy_ms=10.0, li_ms=4.0, wall_ms=40.0, n_ops=100, li_ops=10):
    return devtrace.Frame(wall_ms=wall_ms,
                          host_ms={"render.band_rays": 20.0, "render.li": 5.0,
                                   "render.splat": 8.0},
                          ops=[("k", 0, 1)] * n_ops, li_ops=li_ops, li_device_ms=li_ms,
                          busy_ms=busy_ms)


def test_per_layer_readers():
    r = harness.Readings(frames=[frame(), frame(busy_ms=12.0, n_ops=102, li_ops=13)],
                         window=window([0.040, 0.044, 0.050]), least_ms=0.4)
    read = {x["name"]: harness.reader("metrics", x["name"]).read(r)
            for x in MANIFEST["per_layer"]}
    assert read["render.band_rays_host_ms"] == 20.0
    assert read["film.splat_host_ms"] == 8.0 and read["li.host_ms"] == 5.0
    # render.li's operations only, not the frame's
    assert read["li.device_kernels"] == 11.5
    assert read["device.idle_share"] == pytest.approx(100 * (1 - 11.0 / 44.0))
    assert read["megakernel_roofline"] == pytest.approx(10.0)
    assert read["mesh_megakernel_roofline"] == pytest.approx(10.0)
    # the rate, read per layer where it is not an end-to-end metric
    assert read["client.camera_rays_per_s"] == pytest.approx(3 * 1920 * 1080 / 0.134)
    # a metric's reading under the name that moves the frames' tail is its own
    for x in MANIFEST["per_layer"]:
        if x["name"].endswith(".tail"):
            assert read[x["name"]] == read[x["name"][:-len(".tail")]]
    # no counted work: the roofline reader finds nothing and returns nothing
    r.least_ms = None
    assert harness.reader("metrics", "megakernel_roofline").read(r) is None
    # no attribution of operations to render.li: nothing to read
    r.frames[1].li_ops = None
    assert harness.reader("metrics", "li.device_kernels").read(r) is None


def test_roofline_least_time():
    counts = {"sphere_tests": 1_000_000, "paths": 1000}
    ms, by = roofline.least_ms(counts, 1000, 4096)
    assert by == "operations"
    assert ms == pytest.approx((62 * 1_000_000 + 3 * 1000) / 67e12 * 1e3)
    ms, by = roofline.least_ms({}, 10**9, 0)
    assert by == "bytes" and ms == pytest.approx(44e9 / 3.35e12 * 1e3)


class FakeEvent:
    """A kineto event as devtrace.reduce reads it."""

    def __init__(self, name, kind, start, dur, corr=0, linked=0, note=False):
        self._v = (name, kind, start, dur, corr, linked, note)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]

    def is_hidden_event(self):
        return False


def trace_events(annotate: bool):
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ms = 1_000_000
    ev = [FakeEvent(devtrace.FRAME, cpu, 0, 100 * ms),
          FakeEvent("render.band_rays", cpu, 0, 30 * ms),
          FakeEvent("render.li", cpu, 30 * ms, 20 * ms),
          FakeEvent("render.splat", cpu, 50 * ms, 10 * ms),
          FakeEvent("cudaLaunchKernel", cpu, 10 * ms, 1000, corr=7),
          FakeEvent("cudaLaunchKernel", cpu, 35 * ms, 1000, corr=8),
          FakeEvent("cudaLaunchKernel", cpu, 55 * ms, 1000, corr=9),
          FakeEvent("rng_kernel", cuda, 11 * ms, 4 * ms, linked=7),
          FakeEvent("void mega_kernel<1>(Args)", cuda, 36 * ms, 12 * ms, linked=8),
          FakeEvent("splat_kernel", cuda, 56 * ms, 2 * ms, linked=9)]
    if annotate:
        ev.append(FakeEvent("render.li", cuda, 36 * ms, 12 * ms, note=True))
    return ev


@pytest.mark.parametrize("annotate", [True, False])
def test_trace_reduction(annotate):
    f = devtrace.reduce(trace_events(annotate))
    assert f.wall_ms == 100.0 and f.host_ms["render.li"] == 20.0
    assert len(f.ops) == 3 and f.busy_ms == pytest.approx(18.0)
    assert f.li_ops == 1 and f.li_device_ms == pytest.approx(12.0)
    assert f.how == ("device annotations" if annotate else "launch correlation")
    # idle time by the host range open while the card had nothing to run
    assert f.idle_ms == pytest.approx({"render.band_rays": 26.0, "render.li": 8.0,
                                       "render.splat": 8.0, devtrace.OTHER: 40.0})
    assert devtrace.own_kernels(f.ops, ["megakernel", "intersect"]) == {
        "megakernel": 1, "intersect": 0}


def test_capture_retries_a_trace_that_dropped_launches(monkeypatch):
    """A trace that holds fewer of the program's kernels than were launched
    is taken again, and after RETRIES more it is not read."""
    launches = collections.Counter()
    traces = iter([[], [], []])

    class Prof:
        def __enter__(self):
            launches["megakernel"] += 4
            return self

        def __exit__(self, *a):
            return False

        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return trace_events(True)[:0] + next(traces)

    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Prof())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(devtrace, "reduce", lambda ev: frame(n_ops=0))
    logs = []
    assert devtrace.capture(lambda: None, launches, logs.append) is None
    assert len(logs) == 1 + devtrace.RETRIES


# --------------------------------------------------------------------------
# The reference and the check


@pytest.mark.parametrize("name", CELLS)
def test_reference_is_the_programs_plain_path(name):
    """At 64x36 on the CPU the program runs its plain versions, which the
    reference copies: the images agree on every pixel."""
    c = cell(name)
    settings = {**c.traffic["settings"], "width": 64, "height": 36}
    c = dataclasses.replace(c, traffic={**c.traffic, "settings": settings})
    fs = harness.frame_seed(2**31 + 11, 3)
    got = harness.connect(c, torch.device("cpu"))(fs).numpy()
    ref_scene, ref_cam = check.reference_inputs(c.config, settings, "cpu")
    ref = check.reference_rows(ref_scene, ref_cam, settings, fs, (0, 36))
    assert check.px_off(got, ref, c.check["pixel_tol"]) == 0.0
    assert np.abs(got - ref).max() < 1e-5
    # a band of rows alone is the same rows of the whole frame
    part = check.reference_rows(ref_scene, ref_cam, settings, fs, (9, 20))
    assert np.abs(part - ref[9:20]).max() < 1e-6


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("control", check.CONTROLS)
def test_control_fails_the_limit(name, control):
    """Each control (the reference in bfloat16 between its stages) put in
    the program's place reads above the cell's limit: four rows of a frame
    at the cell's own size."""
    c = cell(name)
    limit = c.check["limits"]["px_off"]
    assert limit is not None
    settings = c.traffic["settings"]
    ref_scene, ref_cam = check.reference_inputs(c.config, settings, "cpu")
    fs = harness.frame_seed(2**31 + 12, 0)
    ref = check.reference_rows(ref_scene, ref_cam, settings, fs, (540, 544))
    low = check.reference_rows(ref_scene, ref_cam, settings, fs, (540, 544), lowp=control)
    assert check.px_off(low, ref, c.check["pixel_tol"]) > limit


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = small_run(name)
    assert out["correct"] and out["failed"] == 0
    assert list(out)[-1] == "checks" and out["checks"]["px_off"]["value"] == 0.0
    assert set(out["metrics"]) == {x["name"] for x in cell(name).end_to_end}
    assert not harness.forbidden_modules()


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(name, fault):
    """The run's own path, with the program broken underneath, reads
    ``correct`` false: a pass that leaves the film as it was, half of the
    bands left out (the rest's mean developed), every radiance altered where
    the integrator produces it."""
    with faults.plant(fault):
        out = small_run(name)
    assert not out["correct"] and out["failed"] == 1
    assert out["checks"]["px_off"]["value"] > out["checks"]["px_off"]["limit"]


# --------------------------------------------------------------------------
# What a run may load


def test_forbidden_modules_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gopbrt_tpu_torch_extra", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gopbrt_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.forbidden_modules() == ["gopbrt_tpu.ops", "jaxlib"]


def test_reference_loads_nothing_of_the_program():
    """In a fresh process the reference renders a frame's rows and loads no
    module of the program, of JAX or of the JAX package."""
    code = f"""
import sys
sys.path[:0] = [{str(HERE)!r}]
import check, harness
m = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
c = harness.load_cell(m, "demo.path-d10.1080p-1spp")
s = dict(c.traffic["settings"], width=16, height=9)
scene, cam = check.reference_inputs(c.config, s, "cpu")
check.reference_rows(scene, cam, s, 5, (0, 9))
bad = [k for k in sys.modules if k.split(".")[0] in ("gopbrt_tpu_torch",) + harness.FORBIDDEN]
print(bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          CELLS[0], "--seed", str(2**31 + 3), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_one_run_on_the_card():
    """One short run of the first cell on the card: a result line whose
    platform is the GPU and whose check is correct."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", CELLS[0],
                          "--seed", str(2**31 + 21), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
