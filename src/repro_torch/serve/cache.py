"""QueryCache: the two-level semantic cache behind the serving stack.

Discovery workloads are highly repetitive — users iterate on pipelines that
share whole subtrees (joinability -> correlation -> union chains), so the
largest serving win left after retrace-free dispatch is not executing the
same logical plan twice.  Three levels, all keyed on canonical fingerprints
(query/fingerprint.py), all validated against ``(epoch, index fingerprint)``:

* **plan cache** — query text / expression -> ``Compiled`` (parse + rewrite +
  lower skipped on repeats).  Compilation is index-independent, so this
  level *survives* epoch changes.
* **result cache** — plan fingerprint -> (ResultSet, table ids, ExecInfo).
  A hit serves ranked ids without touching the executor at all.
* **seeker (subplan) cache** — per hash-consed seeker node: seeker-spec
  fingerprint -> its unrestricted ResultSet.  The executor short-circuits
  ``run_seeker`` on a hit; only *unrestricted* runs (``allowed=None``) are
  cached or served, so a partially-cached plan stays bit-identical to a cold
  run — a seeker that would execute under a threaded optimizer mask still
  executes.

Result and seeker levels are LRU with byte-budget accounting (a dense
ResultSet costs 5 bytes/table slot: f32 scores + bool mask).  Any epoch-key
mismatch wipes both — LiveLake ``add_table`` / ``drop_table`` / ``compact``
can never serve stale ids; the plan level is only keyed by query content and
is left intact.

The cache object is engine-agnostic: the executor duck-types ``seeker_key``
/ ``get_seeker`` / ``put_seeker`` (core/ never imports serve/).

In this port the result and seeker levels hold the executor's tensors, so
on the card their byte charges are device bytes (the charges are the JAX
package's).  No entry aliases a device program's output buffer, which
the program's next replay rewrites: the fused path stores copies
(core/fused.py), and the unfused path's results are its own.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

from repro_torch import obs
from repro_torch.query.fingerprint import (fingerprint_plan, fingerprint_spec,
                                     index_epoch_key)

#: default byte budget across the result + seeker levels
DEFAULT_BYTES = 64 << 20
#: entry cap for the (tiny, index-independent) compiled-plan level
PLAN_ENTRIES = 256


@dataclass
class CacheInfo:
    """Per-request cache telemetry, carried on ``QueryResult.cache`` and
    ``DiscoveryResponse.cache`` and rendered by ``session.explain``."""
    status: str                   # 'hit' | 'partial' | 'miss'
    seekers_cached: int = 0       # seeker nodes served from the subplan cache
    seekers_run: int = 0          # seeker nodes actually executed
    entries: int = 0              # resident entries (result + seeker levels)
    bytes: int = 0                # resident bytes (result + seeker levels)
    evictions: int = 0            # lifetime LRU evictions
    invalidations: int = 0        # lifetime epoch wipes
    epoch: int = 0                # epoch the request was served at

    def as_dict(self) -> dict:
        return {"status": self.status, "seekers_cached": self.seekers_cached,
                "seekers_run": self.seekers_run, "entries": self.entries,
                "bytes": self.bytes, "evictions": self.evictions,
                "invalidations": self.invalidations, "epoch": self.epoch}


@dataclass
class CachedResult:
    """One exact-result entry: everything ``serve`` needs, executor-free."""
    result: object                # combiners.ResultSet (on the device)
    info: object                  # ExecInfo of the producing run
    plan_nodes: int
    ids: list | None = None       # ranked table ids, materialized on first hit
    approx: object | None = None  # core.sketch.ApproxInfo for approx entries


@dataclass
class CachedSeeker:
    """One subplan entry: an unrestricted seeker ResultSet + its overflow."""
    result: object
    overflow: object


@dataclass
class _Entry:
    value: object
    nbytes: int


class _LRU:
    """Byte-budgeted LRU dict (move-to-front on get, evict-oldest on put)."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self.data: OrderedDict = OrderedDict()
        self.bytes = 0
        self.evictions = 0

    def get(self, key):
        e = self.data.get(key)
        if e is None:
            return None
        self.data.move_to_end(key)
        return e.value

    def put(self, key, value, nbytes: int):
        old = self.data.pop(key, None)
        if old is not None:
            self.bytes -= old.nbytes
        if nbytes > self.max_bytes:
            return                       # oversized: never cache, never evict
        self.data[key] = _Entry(value, nbytes)
        self.bytes += nbytes
        while self.bytes > self.max_bytes and len(self.data) > 1:
            _, victim = self.data.popitem(last=False)
            self.bytes -= victim.nbytes
            self.evictions += 1

    def clear(self):
        self.data.clear()
        self.bytes = 0

    def __len__(self):
        return len(self.data)


class QueryCache:
    """See module docstring.  Owned by a ``Session`` (``connect(lake,
    cache=True)``); shared by every query and ``serve_many`` batch on it."""

    def __init__(self, max_bytes: int = DEFAULT_BYTES,
                 result_fraction: float = 0.5):
        result_bytes = int(max_bytes * result_fraction)
        self.results = _LRU(result_bytes)
        self.seekers = _LRU(max_bytes - result_bytes)
        self.plans: OrderedDict = OrderedDict()
        self._epoch_key = None
        self.hits = 0
        self.misses = 0
        self.partial = 0
        self.invalidations = 0

    # ------------------------------------------------------------ validation
    def begin(self, index, config=None) -> tuple:
        """Validate against the live ``(epoch, index fingerprint)`` plus the
        session's execution ``config`` (executor opts + cost-model identity:
        a different m_cap ladder or seeker ranking is a different
        computation); a moved key wipes the result + seeker levels (stale or
        foreign entries are unservable) and keeps the query-content-only
        plan level.  Returns the key."""
        key = (index_epoch_key(index), config)
        if key != self._epoch_key:
            if self._epoch_key is not None:
                self.invalidations += 1
                obs.registry().counter("cache.invalidations").inc()
            self.results.clear()
            self.seekers.clear()
            self._epoch_key = key
        return key

    # ------------------------------------------------------------ plan level
    def get_plan(self, key):
        got = self.plans.get(key)
        if got is not None:
            self.plans.move_to_end(key)
        return got

    def put_plan(self, key, compiled):
        self.plans[key] = compiled
        self.plans.move_to_end(key)
        while len(self.plans) > PLAN_ENTRIES:
            self.plans.popitem(last=False)

    # ---------------------------------------------------------- result level
    @staticmethod
    def result_key(plan, optimize: bool, approx=None) -> tuple:
        """Canonical result identity: plan fingerprint + optimizer mode (the
        B-NO baseline may rank differently, so it gets its own entries).
        ``approx`` is the ``ApproxParams.key()`` tuple for sketch-tier
        requests — different (epsilon, confidence) settings are different
        computations and must never cross-serve with each other or with
        exact entries (``approx=None``)."""
        return (fingerprint_plan(plan), bool(optimize), approx)

    def get_result(self, key) -> CachedResult | None:
        return self.results.get(key)

    def put_result(self, key, entry: CachedResult, n_tables: int):
        # 5 B/table of device arrays (f32 scores + bool mask) plus 36 B/table
        # headroom for the host ids list a hit materializes into the entry
        # (8 B list slot + a Python int object) — charged up front so the
        # write-back can never carry the level past its budget
        nbytes = 41 * n_tables + 96 * max(entry.plan_nodes, 1)
        self.results.put(key, entry, nbytes)

    # ------------------------------------------- seeker level (executor API)
    @staticmethod
    def seeker_key(spec) -> str:
        return fingerprint_spec(spec)

    def get_seeker(self, key) -> CachedSeeker | None:
        got = self.seekers.get(key)
        obs.registry().counter(
            "cache.seeker.hit" if got is not None else "cache.seeker.miss"
        ).inc()
        return got

    def put_seeker(self, key, result, overflow, n_tables: int):
        self.seekers.put(key, CachedSeeker(result, overflow),
                         5 * n_tables + 64)

    # ------------------------------------------------------------- telemetry
    def note(self, status: str):
        if status == "hit":
            self.hits += 1
        elif status == "partial":
            self.partial += 1
        else:
            self.misses += 1
        reg = obs.registry()
        reg.counter(f"cache.result.{status}").inc()
        if reg.enabled:
            reg.gauge("cache.bytes").set(self.resident_bytes)
            reg.gauge("cache.entries").set(self.entries)
            reg.gauge("cache.evictions").set(self.evictions)

    @property
    def entries(self) -> int:
        return len(self.results) + len(self.seekers)

    @property
    def resident_bytes(self) -> int:
        return self.results.bytes + self.seekers.bytes

    @property
    def evictions(self) -> int:
        return self.results.evictions + self.seekers.evictions

    def request_info(self, status: str, *, seekers_cached: int = 0,
                     seekers_run: int = 0) -> CacheInfo:
        """Snapshot the cache state into one request's telemetry record."""
        epoch = self._epoch_key[0][0] if self._epoch_key else 0
        return CacheInfo(status=status, seekers_cached=seekers_cached,
                         seekers_run=seekers_run, entries=self.entries,
                         bytes=self.resident_bytes, evictions=self.evictions,
                         invalidations=self.invalidations, epoch=epoch)

    def stats(self) -> dict:
        """Lifetime counters (benchmarks / observability)."""
        return {"hits": self.hits, "misses": self.misses,
                "partial": self.partial, "entries": self.entries,
                "bytes": self.resident_bytes, "evictions": self.evictions,
                "invalidations": self.invalidations,
                "plans": len(self.plans)}

    def clear(self):
        self.results.clear()
        self.seekers.clear()
        self.plans.clear()
        self._epoch_key = None
