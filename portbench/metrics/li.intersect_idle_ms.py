"""Device idle ms a traced frame while the program's ``li.intersect`` span
(the chain's intersection dispatch, ``_scene_intersect`` /
``_scene_intersect_p``) is the innermost open span of the frame's
request: the gaps between the frame's merged device operations, split at
the edges of the request's spans (the program's tracer,
``gopbrt_tpu_torch/utils/trace.py``, on the clock of the trace), each
piece charged to the span open innermost at its start.  The idle charged
to ``render.li`` and the spans inside it is devtrace's
``idle_ms["render.li"]``.  ``idle_by_span`` and ``idle_ms`` serve the
readers of the other spans.  None where the program records no spans
(the frame's request: ``render.host_syncs``)."""

import collections

import harness


def idle_by_span(frame, req) -> dict:
    """{innermost span name, or None outside every span: idle ms} of one
    frame."""
    busy = []
    for a, b in sorted((a, a + d) for _, a, d in frame.ops):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    # span edges in time order: ends before starts at one time, starts in
    # the order the spans opened
    edges = sorted([(s.start_ns, 1, i) for i, s in enumerate(req.spans)]
                   + [(s.end_ns, 0, i) for i, s in enumerate(req.spans)])
    stack, ended, idle, k = [], set(), collections.Counter(), 0

    def step(t):
        """Opens and closes the spans whose edges lie at or before t."""
        nonlocal k
        while k < len(edges) and edges[k][0] <= t:
            _, kind, i = edges[k]
            if kind:
                if i not in ended:
                    stack.append(i)
            elif i in stack:
                stack.remove(i)
            else:
                ended.add(i)
            k += 1

    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        t = g0
        step(t)
        while k < len(edges) and edges[k][0] < g1:
            idle[req.spans[stack[-1]].name if stack else None] += edges[k][0] - t
            t = edges[k][0]
            step(t)
        idle[req.spans[stack[-1]].name if stack else None] += g1 - t
    return {name: ns / 1e6 for name, ns in idle.items()}


def idle_ms(readings, name: str):
    """Mean idle ms a traced frame charged to the span ``name``."""
    reqs = harness.reader("metrics", "render.host_syncs").requests(readings)
    if reqs is None or not any(s.name == name for r in reqs for s in r.spans):
        return None
    return sum(idle_by_span(f, r).get(name, 0.0)
               for f, r in zip(readings.frames, reqs)) / len(reqs)


def read(readings):
    return idle_ms(readings, "li.intersect")
