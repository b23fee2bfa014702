"""Host ms a traced frame of the program's ``render.li`` range: the
integrator of every band (``models/integrators.li`` / ``li_direct``, the
wavefront chain and the launches of its kernels)."""


def read(readings):
    return sum(f.host_ms["render.li"] for f in readings.frames) / len(readings.frames)
