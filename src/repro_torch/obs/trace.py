"""Span-based tracing and the per-query flight recorder.

A :class:`Span` is one named wall-clock interval with attributes and
children; a :class:`Recorder` builds a span tree through nested
``with rec.span("name"):`` blocks.  The serving stack threads the active
recorder through :func:`recording` (a contextvar), so deep layers —
``core/fused.py``'s per-kind group launches, per-shard probes and the DAG
merge program, ``serve/engine.py``'s drain and host transfer — attach
their spans without any signature plumbing: they call :func:`current`,
which returns the :data:`NULL_RECORDER` no-op singleton unless something
upstream is recording.

The **flight recorder** view (with the serving tier, ROADMAP queue A, item
A5): ``DiscoveryServer(trace=True)`` keeps a ring
buffer of per-request span trees (``DiscoveryResponse.trace`` carries each
request's own root), covering submit -> queue wait -> batch formation ->
epoch pin -> per-kind fused dispatch -> per-shard probe -> cross-shard
merge -> drain -> host transfer.  ``server.dump_trace(path)`` exports the
buffer as Chrome trace-event JSON (:func:`chrome_trace`) loadable in
Perfetto / ``chrome://tracing``.

Tracing is observation only: no span ever synchronizes the device, so
enabling it changes no ids and no scores (parity-tested).  Span *durations*
on the dispatch path therefore measure host-side enqueue time unless
synchronized timing is opted into (``repro_torch.obs.set_sync_timing`` —
see the tradeoff note there); the span *tree* is contiguous wall-clock
either way, which is what makes queue + batch sum to end-to-end latency.

Clocks are injectable (``Recorder(now=...)``) so nesting/ordering tests run
on a fake clock with exact expected timestamps.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import time
from dataclasses import dataclass, field


@dataclass
class Span:
    """One named interval.  ``t0``/``t1`` are seconds on the recorder's
    clock (``t1`` None while open); ``tid`` names the Chrome-trace track
    (inherited from the parent when unset)."""
    name: str
    t0: float
    t1: float | None = None
    attrs: dict = field(default_factory=dict)
    children: list = field(default_factory=list)
    tid: str | None = None

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0

    def set(self, key: str, value):
        """Attach one attribute (no-op on the null span)."""
        self.attrs[key] = value
        return self

    def walk(self):
        """Yield this span and every descendant, depth-first."""
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str):
        """First descendant (or self) with ``name``, else None."""
        for s in self.walk():
            if s.name == name:
                return s
        return None

    def render(self, indent: int = 0) -> str:
        """ASCII tree with millisecond durations (examples / debugging)."""
        pad = "  " * indent
        attrs = "".join(f" {k}={v}" for k, v in self.attrs.items())
        lines = [f"{pad}{self.name:<{max(28 - 2 * indent, 1)}s} "
                 f"{self.duration * 1e3:9.3f} ms{attrs}"]
        for c in self.children:
            lines.append(c.render(indent + 1))
        return "\n".join(lines)


class Recorder:
    """Builds span trees (see module docstring).  ``roots`` holds the
    top-level spans in creation order."""

    enabled = True

    def __init__(self, now=time.perf_counter):
        self.now = now
        self.roots: list = []
        self._stack: list = []

    def _attach(self, span: Span):
        if self._stack:
            self._stack[-1].children.append(span)
        else:
            self.roots.append(span)

    @contextlib.contextmanager
    def span(self, name: str, tid: str | None = None, **attrs):
        s = Span(name=name, t0=self.now(), attrs=attrs, tid=tid)
        self._attach(s)
        self._stack.append(s)
        try:
            yield s
        finally:
            self._stack.pop()
            s.t1 = self.now()

    def record(self, name: str, t0: float, t1: float,
               tid: str | None = None, **attrs) -> Span:
        """Attach one pre-measured interval (e.g. queue wait, whose start
        predates the recorder) under the currently open span."""
        s = Span(name=name, t0=t0, t1=t1, attrs=attrs, tid=tid)
        self._attach(s)
        return s


class _NullSpan:
    """Shared inert span yielded by the null recorder's contexts."""
    name = "null"
    t0 = 0.0
    t1 = 0.0
    duration = 0.0
    tid = None
    children = ()

    def set(self, key, value):
        return self

    def walk(self):
        return iter(())

    def find(self, name):
        return None

    def render(self, indent: int = 0) -> str:
        return ""


class _NullSpanCtx:
    _span = _NullSpan()

    def __enter__(self):
        return self._span

    def __exit__(self, *exc):
        return False


class NullRecorder:
    """The disabled recorder: ``span`` is a reusable no-op context."""

    enabled = False
    roots: list = []
    _ctx = _NullSpanCtx()

    def span(self, name: str, tid: str | None = None, **attrs):
        return self._ctx

    def record(self, name: str, t0: float, t1: float,
               tid: str | None = None, **attrs):
        return _NullSpanCtx._span


NULL_RECORDER = NullRecorder()

#: the active recorder for this thread/task (contextvar: each thread that
#: never calls ``recording`` sees the null recorder)
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_recorder", default=NULL_RECORDER)


def current():
    """The active recorder (the no-op singleton unless inside
    :func:`recording`)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def recording(recorder):
    """Make ``recorder`` the active recorder for the dynamic extent."""
    token = _ACTIVE.set(recorder)
    try:
        yield recorder
    finally:
        _ACTIVE.reset(token)


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------

#: single logical process for the serving stack in exported traces
_PID = 1


def chrome_trace(roots, process_name: str = "blend-serve") -> dict:
    """Flatten span trees into the Chrome trace-event JSON format
    (https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU):
    one complete (``"ph": "X"``) event per span, microsecond timestamps
    relative to the earliest span, plus metadata (``"ph": "M"``) events
    naming the process and tracks.

    Spans shared between trees (a batch subtree referenced by every request
    it served) are emitted exactly once, keyed by identity — Perfetto then
    shows one dispatcher track plus one track per request."""
    roots = list(roots)
    origin = min((s.t0 for s in roots), default=0.0)
    events = [{"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
               "args": {"name": process_name}}]
    seen: set = set()
    tids: dict = {}

    def tid_index(tid: str) -> int:
        if tid not in tids:
            tids[tid] = len(tids) + 1
            events.append({"name": "thread_name", "ph": "M", "pid": _PID,
                           "tid": tids[tid], "args": {"name": tid}})
        return tids[tid]

    def emit(span, inherited_tid: str):
        if id(span) in seen:
            return
        seen.add(id(span))
        tid = span.tid or inherited_tid
        t1 = span.t1 if span.t1 is not None else span.t0
        events.append({
            "name": span.name, "ph": "X", "pid": _PID,
            "tid": tid_index(tid),
            "ts": (span.t0 - origin) * 1e6,
            "dur": max(t1 - span.t0, 0.0) * 1e6,
            "args": {k: v for k, v in span.attrs.items()
                     if isinstance(v, (str, int, float, bool))},
        })
        for c in span.children:
            emit(c, tid)

    for i, root in enumerate(roots):
        emit(root, root.tid or f"trace-{i}")
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_chrome(roots, path, process_name: str = "blend-serve"):
    """Write :func:`chrome_trace` JSON to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(chrome_trace(roots, process_name=process_name), f)
    return path
