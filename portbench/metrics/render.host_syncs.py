"""Host syncs a traced frame: the program's ``host_syncs`` counter (each
time the program makes the host wait on the card: a read of a device
value, a copy between host and card, an explicit ``synchronize``) in the
frame's request, from the program's tracer
(``gopbrt_tpu_torch/utils/trace.py``).

The frame's request, which every reader of the program's records takes
from ``requests`` here, is the one whose ``render.request`` span opened
last before the frame's first device operation: a frame that
``devtrace.capture`` took again reads only its last render.  None where
the program keeps no records (a program without the tracer)."""


def requests(readings):
    """The request of each traced frame, or None where a frame has none."""
    try:
        from gopbrt_tpu_torch.utils import trace
    except ImportError:
        return None
    opened = [(r.spans[0].start_ns, r) for r in trace.requests()
              if r.spans and r.spans[0].name == trace.REQUEST]
    out = []
    for f in readings.frames:
        if not f.ops:
            return None
        t0 = min(a for _, a, _ in f.ops)
        before = [(t, r) for t, r in opened if t <= t0]
        if not before:
            return None
        out.append(max(before, key=lambda tr: tr[0])[1])
    return out or None


def read(readings):
    reqs = requests(readings)
    if reqs is None:
        return None
    return sum(r.total("host_syncs") for r in reqs) / len(reqs)
