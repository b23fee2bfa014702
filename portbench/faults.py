"""Faults planted in the program's timed path, each of which the check has
to read as not correct: a pass that leaves the film as it was, half of the
bands left out (the rest's mean developed), every radiance altered where
the integrator returns it.  ``plant(name)`` patches the program's module
for the length of a ``with`` block."""

from __future__ import annotations

import contextlib


def _unchanged(render):
    return "render_pass", lambda scene, camera, film, *a, **k: film


def _half_the_bands(render):
    real = render.render_wave_rows

    def half(scene, camera, film, settings, row0, n_rows, sample_idx):
        if (row0 // n_rows) % 2:
            return film
        return real(scene, camera, film, settings, row0, n_rows, sample_idx)
    return "render_wave_rows", half


def _radiance_altered(render):
    real = render._radiance
    return "_radiance", lambda *a, **k: real(*a, **k) * 0.95


FAULTS = {"state_unchanged": _unchanged, "half_the_bands": _half_the_bands,
          "radiance_altered": _radiance_altered}


@contextlib.contextmanager
def plant(name: str):
    from gopbrt_tpu_torch.models import render

    attr, broken = FAULTS[name](render)
    real = getattr(render, attr)
    setattr(render, attr, broken)
    try:
        yield
    finally:
        setattr(render, attr, real)
