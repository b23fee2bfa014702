"""The port's tracer: spans and counters of each request, on the profiler's
clock.

``request()`` opens a request (``models/render.render``: one a call) and
its own span, ``render.request``; opened while a request is open on the
thread (the service's handler around ``render``), it opens only that span,
inside the open request; ``span(name)`` opens a span inside the
request open on this thread; ``count(name, n, key=None)`` adds ``n`` to
that request's counter ``name`` under ``key``.  A span records its name,
start and end, its parent span and its request's id.

Tracing is on while a ``torch.profiler`` session records, or after
``enable()``.  Off, ``span`` and ``request`` return one shared no-op
context and ``count`` returns at once: no record, no ``record_function``.
On, a span also opens a ``record_function`` of its name while the
profiler records, so the profiler's trace holds the program's ranges
(``render.band_rays``, ``render.li``, ``render.splat``, ...) with the
span's extent; spans and counts outside any request keep no record.  No
span name starts with ``cu``: trace readers take host events named
``cu*`` for CUDA runtime calls.  On, the program launches no device work
of its own: a counter of lanes keeps the mask it counts and sums it when
read.  Only after ``enable()`` (``enabled()``) do kernels #1 and #5 run
their counting instance, a binary of its own, so a bare profiler session
times the kernels that an untraced run launches.

Spans are stamped with ``time.time_ns()``, Unix-epoch nanoseconds: the
clock of the profiler's kineto events, host and device
(``tests/test_torch_trace.py`` holds each span to its ``record_function``
twin), so a span and the device operations of a trace compare directly.
Under the profiler a span starts at the middle of the call that opens its
range and ends when the call that closes it returns: the points nearest
to where the profiler stamps the range.

A counter adds ints and tensors: a tensor on the device counts the sum
of its elements (a count the device made, or a mask of lanes), kept as
it comes, with no sync and no kernel, and summed only when the counter is
read (``Request.counter``), after the frame; reading frees it.  The last
``RING`` requests stay in memory: ``requests()``.

Every copy between host and card that the program makes goes through
``to_card`` / ``to_host`` / ``synchronize``, which count it in
``host_syncs`` where a card is involved: the one place that decides what
is a host sync.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

RING = 64
REQUEST = "render.request"

_profiling = torch._C._autograd._profiler_enabled
_clock = time.time_ns
_ring: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()
_forced = False


class Span:
    """One span: name, start and end (ns, the profiler's clock), the index
    of its parent in its request's ``spans`` (None for the request's own)
    and its request's id."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "request")

    def __init__(self, name, start_ns, parent, request):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.request = parent, request

    def __repr__(self):
        return (f"Span({self.name!r}, {self.start_ns}, {self.end_ns}, parent={self.parent}, "
                f"request={self.request})")


class Request:
    """One request's records: its spans in the order they opened (the
    first is the request's own) and its counters, {name: {key: values}}."""

    __slots__ = ("id", "spans", "counters")

    def __init__(self, rid: int):
        self.id, self.spans, self.counters = rid, [], {}

    def counter(self, name: str) -> dict:
        """{key: total} of the counter ``name`` ({} where never counted);
        device values are summed and read here, once."""
        out = {}
        for k, v in self.counters.get(name, {}).items():
            if len(v) > 1:
                v[:] = [v[0] + sum(int(t.sum()) for t in v[1:])]
            out[k] = v[0]
        return out

    def total(self, name: str) -> int:
        return sum(self.counter(name).values())


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "_rf", "_record", "_stack")

    def __init__(self, name: str):
        if name.startswith("cu"):
            raise ValueError(f"span {name!r}: names starting with 'cu' are CUDA runtime calls "
                             "to trace readers")
        self.name = name

    def __enter__(self):
        self._open(getattr(_local, "request", None), self._enter_rf())
        return self

    def _enter_rf(self) -> int:
        """Opens the profiler's range where it records -> the span's start:
        the middle of that call, inside which the profiler stamps the
        range's start."""
        t0, self._rf = _clock(), None
        if _profiling():
            self._rf = torch.autograd.profiler.record_function(self.name)
            self._rf.__enter__()
            t0 = (t0 + _clock()) // 2
        return t0

    def _open(self, req, start_ns: int):
        self._record = None
        if req is not None:
            stack = self._stack = _local.stack
            self._record = Span(self.name, start_ns, stack[-1] if stack else None, req.id)
            stack.append(len(req.spans))
            req.spans.append(self._record)

    def __exit__(self, *exc):
        # the profiler stamps the range's end near the end of its exit call
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if self._record is not None:
            self._record.end_ns = _clock()
            self._stack.pop()
        return False


class _Request(_Span):
    __slots__ = ("_outer",)

    def __enter__(self) -> Request:
        self._outer = (getattr(_local, "request", None), getattr(_local, "stack", None))
        req = Request(next(_ids))
        _ring.append(req)
        _local.request, _local.stack = req, []
        self._open(req, self._enter_rf())
        return req

    def __exit__(self, *exc):
        super().__exit__(*exc)
        _local.request, _local.stack = self._outer
        return False


def on() -> bool:
    """Whether tracing is on: a profiler records, or ``enable()``."""
    return _forced or _profiling()


def enabled() -> bool:
    """Whether ``enable()`` turned tracing on: the only case in which the
    program launches its counting kernels."""
    return _forced


def enable() -> None:
    global _forced
    _forced = True


def disable() -> None:
    """Tracing off again outside a profiler session."""
    global _forced
    _forced = False


def request():
    """Context of one request and its own span, ``render.request``; ``as``
    gives its Request (the shared no-op context where tracing is off).
    Inside an open request it is a span of that request."""
    if not (_forced or _profiling()):
        return _NULL
    return _Span(REQUEST) if getattr(_local, "request", None) is not None else _Request(REQUEST)


def span(name: str):
    """Context of one span of the request open on this thread."""
    return _Span(name) if (_forced or _profiling()) else _NULL


def count(name: str, n, key=None) -> None:
    """Adds ``n`` (an int, or a tensor whose sum counts, kept on its device
    until read) to the counter ``name`` under ``key`` of the request open
    on this thread."""
    if not (_forced or _profiling()):
        return
    req = getattr(_local, "request", None)
    if req is None:
        return
    vals = req.counters.setdefault(name, {}).setdefault(key, [0])
    if isinstance(n, torch.Tensor):
        vals.append(n)
    else:
        vals[0] += n


def to_card(value, device=None, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)``; where that
    copies host data to a card, which synchronises, it counts in
    ``host_syncs``."""
    t = torch.as_tensor(value, dtype=dtype, device=device)
    if t.is_cuda and not (isinstance(value, torch.Tensor) and value.is_cuda):
        count("host_syncs", 1)
    return t


def to_host(t: torch.Tensor, key=None) -> torch.Tensor:
    """``t.cpu()``; from a card, a sync, counted in ``host_syncs`` under
    ``key``."""
    if t.is_cuda:
        count("host_syncs", 1, key)
    return t.cpu()


def synchronize(device) -> None:
    """Waits for a card's work (``torch.cuda.synchronize``), counted in
    ``host_syncs``; nothing on another device."""
    device = torch.device(device)
    if device.type == "cuda":
        count("host_syncs", 1)
        torch.cuda.synchronize(device)


def requests() -> list:
    """The last RING requests, oldest first."""
    return list(_ring)
