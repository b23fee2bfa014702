"""Host ms a traced frame in the service's PNG: the span ``service.png``
(``service/server.py``: the image's copy to the host as bytes, their zlib
encoding and the file's write) in the frame's request, as
``render.host_syncs`` takes it.  None where the program keeps no such
span."""

import harness


def read(readings):
    reqs = harness.reader("metrics", "render.host_syncs").requests(readings)
    if reqs is None:
        return None
    ms = [sum(s.end_ns - s.start_ns for s in r.spans if s.name == "service.png") / 1e6
          for r in reqs if any(s.name == "service.png" for s in r.spans)]
    return sum(ms) / len(ms) if ms and len(ms) == len(reqs) else None
