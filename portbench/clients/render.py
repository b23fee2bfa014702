"""The client of the program's ``models.render.render``: one call a frame,
with its ``develop``, on the scene and camera that the configuration's
builders make (``"program"`` in ``configs/<config>.json``, each a
``"module:function"``)."""

from __future__ import annotations


def _import(spec: str):
    mod, fn = spec.split(":")
    return getattr(__import__(mod, fromlist=[fn]), fn)


def connect(config: dict, settings: dict, device):
    """-> frame(seed): the developed image f32[H,W,3] of a frame rendered
    with the render seed ``seed``, on ``device``."""
    from gopbrt_tpu_torch.models import render

    prog = config["program"]
    scene = _import(prog["scene"])(device=device, **config.get("kwargs", {}))
    camera = _import(prog["camera"])(settings["width"], settings["height"], device=device)
    base = render.RenderSettings(**settings)

    def frame(seed: int):
        return render.render(scene, camera, base._replace(seed=seed), device=device)

    return frame
