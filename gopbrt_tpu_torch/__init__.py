"""gopbrt_tpu_torch — the PyTorch/CUDA port of ``gopbrt_tpu`` for NVIDIA Hopper.

The package mirrors ``gopbrt_tpu``'s layout (``ops/``, ``models/``) and
module names, so each module's counterpart is found by path.  It imports
``torch`` and never JAX nor anything of ``gopbrt_tpu``.

Entry points (``SceneBuilder.build``, ``perspective_camera``, ``new_film``,
``render_pass``, ``render``) run on the card unless the caller passes
``device="cpu"``; with no card they raise instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card ("cuda").

    Raises when a CUDA device is asked for and none is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gopbrt_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path"
        )
    return dev
