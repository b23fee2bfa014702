"""Progress reporting between render passes.

Counterpart of ``gopbrt_tpu/utils/progress.py`` (pkg/pbrt/progress.go's
StdoutProgress): a callback ``(done, total)`` that ``models/render.render``
calls after each pass.
"""

from __future__ import annotations

import sys
import time


class StdoutProgress:
    """Carriage-return progress with the start, the end and the duration,
    as progress.go:33-56 prints them."""

    def __init__(self, label: str = "render"):
        self.label = label
        self.t0 = None

    def __call__(self, done: int, total: int) -> None:
        if self.t0 is None:
            self.t0 = time.time()
            print(f"[{self.label}] start {time.strftime('%H:%M:%S')}")
        pct = 100.0 * done / max(total, 1)
        sys.stdout.write(f"\r[{self.label}] progress: {pct:5.1f}%")
        sys.stdout.flush()
        if done >= total:
            print(f"\n[{self.label}] done in {time.time() - self.t0:.2f}s")


class NullProgress:
    def __call__(self, done: int, total: int) -> None:
        pass
