"""Seeded, deterministic fault injection for durability and serving tests.

The library is sprinkled with **named fault points** — ``faults.checkpoint``
calls around every durability-critical transition.  When no injector is
active a checkpoint is a single global read and a ``None`` compare, so the
hot path pays nothing.  Tests and benchmarks activate an injector to turn
specific points into crashes, component failures, torn writes, or latency:

    inj = FaultInjector(seed=0, crash={"wal.append.pre": 2})
    with faults.inject(inj):
        lake.add_table(t1)          # fine (hit 1)
        lake.add_table(t2)          # raises InjectedCrash (hit 2)

Point taxonomy (the names tests enumerate):

* ``store.add.pre/post``, ``store.drop.pre/post``,
  ``store.compact.pre/post`` — around LiveLake mutations (pre = before the
  in-memory apply, post = after the WAL record is durable).
* ``wal.append.pre/post`` — around one WAL record append; ``torn=`` points
  at ``wal.append`` write a seeded *fraction* of the record then crash —
  the torn-tail case replay must truncate.
* ``snapshot.write.pre``, ``snapshot.rename.pre``, ``snapshot.post`` —
  around the write-temp-then-rename snapshot commit.
* ``shard.probe.{s}`` — before shard ``s``'s fused probe dispatch; ``fail=``
  here raises a *recoverable* :class:`InjectedFault` that the serving tier's
  shard-retry / degraded-response path absorbs.

Crash vs failure: :class:`InjectedCrash` subclasses ``BaseException`` — it
models ``kill -9`` and must never be absorbed by a library ``except
Exception`` recovery path; tests catch it explicitly at top level and then
recover from disk.  :class:`InjectedFault` subclasses :class:`BlendFault`
(an ordinary ``Exception``) — it models a failed component the system is
expected to survive.

Determinism: everything derives from the injector's seed and its per-point
hit counters; ``record=True`` turns the injector into a pure recorder so a
clean run enumerates every point it crossed (the crash-at-every-point
property test iterates exactly that list).
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager

import numpy as np

from repro_torch.errors import BlendFault


class InjectedCrash(BaseException):
    """Simulated process kill at a named fault point.  BaseException on
    purpose: no library ``except Exception`` handler may absorb a simulated
    ``kill -9`` — only the test harness catches it, then recovers from
    disk."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected crash at {point!r} (hit {hit})")
        self.point = point
        self.hit = hit


class InjectedFault(BlendFault):
    """Simulated recoverable component failure (e.g. one shard's probe)."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected fault at {point!r} (hit {hit})")
        self.point = point
        self.hit = hit


class FaultInjector:
    """Deterministic fault plan keyed on named points and 1-based hit
    counts.

    ``crash={point: n}``   — raise :class:`InjectedCrash` on the n-th hit.
    ``fail={point: k}``    — raise :class:`InjectedFault` on hits 1..k
                             (consecutive failures; hit k+1 succeeds — the
                             retry-path knob).
    ``torn={point: n}``    — at the n-th hit of a torn-capable point (WAL
                             appends) write a seeded fraction of the record,
                             then crash.
    ``latency={point: s}`` — sleep ``s`` seconds at every hit (injected
                             ``sleep`` for tests).
    ``record=True``        — never raise; just record the ordered unique
                             point names crossed (``.points``).
    """

    def __init__(self, seed: int = 0, *, crash: dict | None = None,
                 fail: dict | None = None, torn: dict | None = None,
                 latency: dict | None = None, sleep=time.sleep,
                 record: bool = False):
        self.crash = dict(crash or {})
        self.fail = dict(fail or {})
        self.torn = dict(torn or {})
        self.latency = dict(latency or {})
        self.record = record
        self._sleep = sleep
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.hits: dict = {}          # point -> hit count so far
        self.points: list = []        # ordered unique points crossed

    def _count(self, point: str) -> int:
        with self._lock:
            n = self.hits.get(point, 0) + 1
            self.hits[point] = n
            if n == 1:
                self.points.append(point)
            return n

    def hit(self, point: str):
        """One checkpoint crossing: count it, then latency / fail / crash
        in that order (a point can both lag and die)."""
        n = self._count(point)
        if self.record:
            return
        lag = self.latency.get(point)
        if lag:
            self._sleep(lag)
        if self.fail.get(point, 0) >= n:
            raise InjectedFault(point, n)
        if self.crash.get(point) == n:
            raise InjectedCrash(point, n)

    def torn_fraction(self, point: str) -> float | None:
        """Non-None when this hit should tear: the seeded fraction of the
        record to actually write before crashing.  Does NOT raise — the
        caller writes the partial record first, then calls
        :meth:`crash_now` so the torn bytes really land on disk."""
        if self.record:
            return None
        n = self._count(point)
        if self.torn.get(point) != n:
            return None
        return float(self._rng.uniform(0.05, 0.95))

    def crash_now(self, point: str):
        raise InjectedCrash(point, self.hits.get(point, 0))


#: the process-wide active injector (None = zero-cost checkpoints)
_active: FaultInjector | None = None


def active() -> FaultInjector | None:
    return _active


@contextmanager
def inject(injector: FaultInjector):
    """Activate ``injector`` for the dynamic extent of the block.  Not
    reentrant across nested distinct injectors (last one wins), which the
    deterministic tests never need."""
    global _active
    prev = _active
    _active = injector
    try:
        yield injector
    finally:
        _active = prev


def checkpoint(point: str):
    """A named fault point.  Near-zero cost when no injector is active."""
    inj = _active
    if inj is not None:
        inj.hit(point)


def torn_fraction(point: str) -> float | None:
    """Torn-write probe for WAL appends (see FaultInjector.torn_fraction)."""
    inj = _active
    return inj.torn_fraction(point) if inj is not None else None


def crash_now(point: str):
    inj = _active
    if inj is not None:
        inj.crash_now(point)
    raise InjectedCrash(point, 0)
