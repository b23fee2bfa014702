"""Package rules of gopbrt_tpu_torch: no JAX, entry points on the card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gopbrt_tpu_torch.models import camera as tcam
from gopbrt_tpu_torch.models import demo as tdemo
from gopbrt_tpu_torch.models import film as tfilm
from gopbrt_tpu_torch.models import render as trender
from gopbrt_tpu_torch.models.scene import SceneBuilder
from gopbrt_tpu_torch.ops import megakernel
from gopbrt_tpu_torch.parallel import dist as tdist
from gopbrt_tpu_torch.parallel import shard as tshard
from gopbrt_tpu_torch.service.proto import RenderRequest
from gopbrt_tpu_torch.service.server import RenderService

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "gopbrt_tpu")


def _port_files():
    files = sorted((REPO / "gopbrt_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    return files


def _forbidden(module: str) -> bool:
    """``module`` is jax / jaxlib / gopbrt_tpu or a submodule of one — by
    exact name, so gopbrt_tpu_torch itself is allowed."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_matches_exact_module_names():
    assert _forbidden("gopbrt_tpu") and _forbidden("gopbrt_tpu.ops.rng")
    assert _forbidden("jax.numpy")
    assert not _forbidden("gopbrt_tpu_torch") and not _forbidden("gopbrt_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


def _imports(path: Path):
    """(line, module) of every import in ``path``, in functions too; a
    ``from package import name`` gives ``package.name``."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from ((node.lineno, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield from ((node.lineno, f"{node.module}.{a.name}") for a in node.names)


LOWER = sorted((REPO / "gopbrt_tpu_torch" / "ops").rglob("*.py")) + sorted(
    (REPO / "gopbrt_tpu_torch" / "utils").rglob("*.py")) + [
    REPO / "gopbrt_tpu_torch" / "_build.py"]
UPPER = tuple(f"gopbrt_tpu_torch.{p}" for p in ("models", "service", "parallel"))


@pytest.mark.parametrize("path", LOWER, ids=lambda p: str(p.relative_to(REPO)))
def test_kernels_and_utils_import_nothing_above_them(path):
    """``ops/``, ``utils/`` and ``_build.py`` lie below the integrator, the
    service and the ranks: none of them imports from those, not even lazily
    inside a function."""
    up = [(line, m) for line, m in _imports(path)
          if any(m == u or m.startswith(u + ".") for u in UPPER)]
    assert not up, f"{path.name} imports {up}"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(no_cuda, tmp_path):
    b = SceneBuilder()
    b.sphere(np.eye(4), 1.0, b.matte())
    b.point_light(p=(0.0, 5.0, 0.0), intensity=(1.0, 1.0, 1.0))
    calls = [
        lambda: b.build(),
        lambda: tdemo.build_demo_scene(),
        lambda: tcam.perspective_camera(np.eye(4), 8, 8),
        lambda: tfilm.new_film(8, 8),
        lambda: tshard.make_mesh(),
        lambda: RenderService().render(RenderRequest(width=8, height=8), None),
        lambda: tdist.init_distributed(init_method=(tmp_path / "store").as_uri(), rank=0,
                                       world_size=1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_render_without_a_device_raises_and_renders_nothing(no_cuda, monkeypatch):
    scene = tdemo.build_demo_scene(device="cpu")
    camera = tdemo.build_demo_camera(16, 8, device="cpu")
    settings = trender.RenderSettings(width=16, height=8, spp=1, max_depth=2)
    traced = []
    monkeypatch.setattr(megakernel, "path_li_plain",
                        lambda *a, **k: traced.append(1))
    film = tfilm.new_film(16, 8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trender.render(scene, camera, settings)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trender.render_pass(scene, camera, film, settings, 0)
    assert not traced
    assert float(film.weight.sum()) == 0.0


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without a CUDA device (or outside the checkout) the gate exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (REPO / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                              text=True, timeout=120, cwd=script.parent,
                              env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
