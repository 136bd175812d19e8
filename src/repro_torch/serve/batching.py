"""Batch-forming and admission-control primitives for the serving front tier.

The continuous-batching core of ``serve/server.py`` lives here as plain,
clock-injectable state machines so serving *policy* is unit-testable without
threads or sleeps (tests/test_batching.py drives them with a fake clock):

* :class:`TokenBucket` — the per-tenant rate limiter.  ``burst`` tokens of
  capacity refilled at ``rate`` tokens/sec; ``try_acquire`` either debits or
  reports how long until the request would clear.
* :class:`RateLimiter` — a tenant -> bucket map with a default rate and
  per-tenant overrides; tracks sheds per tenant.
* :class:`BatchFormer` — the continuous-batching state machine: priority
  lanes (``interactive`` before ``batch``) with bounded queues, a per-lane
  coalescing window, and FIFO **mutation barriers**.  ``submit`` admits or
  sheds (``queue_full``); ``poll(now)`` returns either a :class:`Batch` of
  coalesced queries, a :class:`Barrier` mutation, or ``None`` (plus
  ``next_deadline`` for the dispatcher's timed wait).  Requests may carry an
  absolute **deadline**: once it passes while queued they are culled into
  ``Batch.expired`` — never dispatched — and the server resolves them with
  a typed ``DeadlineExceeded`` instead of serving stale work.

Barrier semantics — the property the serving tier's bit-identity rests on:
every admitted operation carries a monotone sequence number; a query may
only join a batch if it arrived *before* the oldest pending mutation, and a
mutation only runs once every earlier query has been dispatched.  Queries
therefore observe exactly the index epoch a sequential arrival-order
execution would have shown them (lane priority only reorders read-only
queries *between* barriers, which cannot change any result).  While a
mutation is pending the window is cut short: runnable queries flush
immediately so the barrier drains fast.

Nothing here is thread-safe by itself — the server serializes access under
its own condition variable, and the deterministic tests drive the state
machines single-threaded.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

#: lane names (dict order in ``BatchFormer.lanes`` is dispatch priority)
INTERACTIVE = "interactive"
BATCH = "batch"

#: shed reasons carried on ``Overloaded`` responses and in stats
SHED_QUEUE_FULL = "queue_full"
SHED_RATE_LIMIT = "rate_limit"


@dataclass
class LaneConfig:
    """One priority lane: how long to hold the window open for coalescing,
    and how deep the bounded queue may grow before backpressure sheds."""
    window_s: float = 0.002
    max_queue: int = 256


class TokenBucket:
    """Classic token bucket: ``burst`` capacity, ``rate`` tokens/sec refill.

    ``now`` is injectable (defaults to ``time.monotonic``) so rate decisions
    are testable with a fake clock; every method also takes an explicit
    ``now=`` override.  ``rate=None`` means unlimited (always admits).
    """

    def __init__(self, rate: float | None, burst: float | None = None,
                 now=time.monotonic):
        self.rate = rate
        self.burst = float(burst if burst is not None
                           else (rate if rate is not None else 0) or 1.0)
        self._now = now
        self._tokens = self.burst
        self._t = now()

    def _refill(self, now: float):
        if now > self._t:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now

    def available(self, now: float | None = None) -> float:
        if self.rate is None:
            return float("inf")
        self._refill(self._now() if now is None else now)
        return self._tokens

    def try_acquire(self, n: float = 1.0,
                    now: float | None = None) -> tuple[bool, float]:
        """Debit ``n`` tokens if available.  Returns ``(admitted,
        retry_after_s)`` — ``retry_after_s`` is 0 on admit, else the time
        until ``n`` tokens will have refilled."""
        if self.rate is None:
            return True, 0.0
        self._refill(self._now() if now is None else now)
        if self._tokens >= n:
            self._tokens -= n
            return True, 0.0
        if self.rate <= 0:
            return False, float("inf")
        return False, (n - self._tokens) / self.rate


class RateLimiter:
    """Per-tenant token buckets: one default ``(rate, burst)`` plus
    per-tenant overrides; buckets materialize on first use so tenants need
    no registration.  ``rate=None`` disables limiting entirely."""

    def __init__(self, rate: float | None = None, burst: float | None = None,
                 per_tenant: dict | None = None, now=time.monotonic):
        self.rate, self.burst = rate, burst
        self.per_tenant = dict(per_tenant or {})
        self._now = now
        self._buckets: dict = {}
        self.sheds: dict = {}                 # tenant -> rate-limit sheds

    def _bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            rate, burst = self.per_tenant.get(tenant,
                                              (self.rate, self.burst))
            b = self._buckets[tenant] = TokenBucket(rate, burst,
                                                    now=self._now)
        return b

    def admit(self, tenant: str,
              now: float | None = None) -> tuple[bool, float]:
        ok, retry = self._bucket(tenant).try_acquire(now=now)
        if not ok:
            self.sheds[tenant] = self.sheds.get(tenant, 0) + 1
        return ok, retry


@dataclass
class Pending:
    """One admitted operation waiting in the former.  ``payload`` is opaque
    to the batching layer (the server stores the query/mutation + future).
    ``deadline_s`` is the absolute clock value past which the request must
    not be dispatched — the former culls it into ``Batch.expired`` instead
    of serving stale work."""
    seq: int
    kind: str                     # 'query' | 'mutation'
    lane: str
    tenant: str
    payload: object
    enqueue_s: float
    deadline_s: float | None = None


@dataclass
class Batch:
    """A coalesced set of queries, ready for one fused ``serve_many``.
    ``expired`` carries requests whose deadline passed while queued — never
    dispatched; the server resolves them with ``DeadlineExceeded``.  A batch
    may be *all* expired (``requests == []``)."""
    requests: list                # of Pending, lane-priority order
    formed_s: float
    expired: list = field(default_factory=list)


@dataclass
class Barrier:
    """One mutation, runnable only because every earlier query dispatched."""
    request: Pending


@dataclass
class FormerStats:
    admitted: dict = field(default_factory=dict)     # lane -> count
    shed: dict = field(default_factory=dict)         # reason -> count
    shed_by_lane: dict = field(default_factory=dict)
    batches: int = 0
    batched_requests: int = 0
    batch_size_hist: dict = field(default_factory=dict)   # size -> count
    barriers: int = 0
    expired: int = 0              # deadline-culled, never dispatched

    def note_shed(self, lane: str, reason: str):
        self.shed[reason] = self.shed.get(reason, 0) + 1
        by = self.shed_by_lane.setdefault(lane, {})
        by[reason] = by.get(reason, 0) + 1


class BatchFormer:
    """The continuous-batching state machine (see module docstring)."""

    #: mutation queue bound — mutations shed with ``queue_full`` beyond it
    MUTATION_LANE = "mutation"

    def __init__(self, *, max_batch: int = 16, lanes: dict | None = None,
                 mutation_max_queue: int = 256):
        if lanes is None:
            lanes = {INTERACTIVE: LaneConfig(window_s=0.002, max_queue=256),
                     BATCH: LaneConfig(window_s=0.010, max_queue=1024)}
        self.max_batch = int(max_batch)
        self.lanes = dict(lanes)              # insertion order = priority
        self.mutation_max_queue = int(mutation_max_queue)
        self._queues: dict = {name: deque() for name in self.lanes}
        self._mutations: deque = deque()
        self._seq = 0
        self.stats = FormerStats()

    # ------------------------------------------------------------ admission
    def submit(self, payload, *, lane: str = BATCH, tenant: str = "default",
               kind: str = "query", now: float = 0.0,
               deadline_s: float | None = None):
        """Admit one operation.  Returns ``(Pending, None)`` on admit or
        ``(None, reason)`` on shed (bounded queues are the backpressure:
        beyond ``max_queue`` the request is rejected, never buffered).
        ``deadline_s`` (absolute; queries only) marks the request for
        deadline culling — see :class:`Batch`."""
        if kind == "mutation":
            if len(self._mutations) >= self.mutation_max_queue:
                self.stats.note_shed(self.MUTATION_LANE, SHED_QUEUE_FULL)
                return None, SHED_QUEUE_FULL
            p = Pending(self._next_seq(), kind, self.MUTATION_LANE, tenant,
                        payload, now)
            self._mutations.append(p)
            self.stats.admitted[self.MUTATION_LANE] = \
                self.stats.admitted.get(self.MUTATION_LANE, 0) + 1
            return p, None
        if lane not in self.lanes:
            raise ValueError(f"unknown lane {lane!r}: "
                             f"expected one of {list(self.lanes)}")
        if len(self._queues[lane]) >= self.lanes[lane].max_queue:
            self.stats.note_shed(lane, SHED_QUEUE_FULL)
            return None, SHED_QUEUE_FULL
        p = Pending(self._next_seq(), kind, lane, tenant, payload, now,
                    deadline_s)
        self._queues[lane].append(p)
        self.stats.admitted[lane] = self.stats.admitted.get(lane, 0) + 1
        return p, None

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    # -------------------------------------------------------------- forming
    def _barrier_seq(self) -> float:
        return self._mutations[0].seq if self._mutations else float("inf")

    def _runnable(self) -> list:
        """Queries admitted before the oldest pending mutation, in lane
        priority order then FIFO within each lane (test/introspection
        helper — the forming hot path uses the bounded prefix walk in
        ``poll`` instead)."""
        bseq = self._barrier_seq()
        out = []
        for name in self.lanes:
            out.extend(p for p in self._queues[name] if p.seq < bseq)
        return out

    def depth(self) -> dict:
        d = {name: len(q) for name, q in self._queues.items()}
        d[self.MUTATION_LANE] = len(self._mutations)
        return d

    def pending(self) -> int:
        return sum(self.depth().values())

    def next_deadline(self, now: float) -> float | None:
        """When the dispatcher should wake if nothing arrives: the earliest
        window close — or request deadline — among runnable queries
        (``None``: nothing pending, so wait for a submit).  With a mutation
        pending the deadline is ``now`` — runnable queries flush immediately
        so the barrier drains, and a runnable mutation executes without
        waiting.  Only lane *heads* are inspected (O(lanes), not O(depth));
        a non-head request with a shorter deadline than its head is culled
        when it reaches the head or joins a batch, which is exact whenever
        per-lane deadlines are FIFO-ordered (the common case: one deadline
        policy per lane)."""
        if self._mutations:
            return now
        # no mutation pending => every queued query is runnable, and each
        # lane is FIFO, so its earliest window close is its front's
        best = None
        for name, cfg in self.lanes.items():
            q = self._queues[name]
            if q:
                d = q[0].enqueue_s + cfg.window_s
                if q[0].deadline_s is not None:
                    d = min(d, q[0].deadline_s)
                best = d if best is None else min(best, d)
        return best

    def poll(self, now: float):
        """Return ready work: a :class:`Batch`, a :class:`Barrier`, or
        ``None`` (window still open / nothing pending).  A batch is ready
        when it is full, its earliest window closed, or a mutation is
        waiting behind it (barrier flush)."""
        # seqs are assigned at admission, so within each FIFO lane the
        # runnable (pre-barrier) queries are a *prefix* of the deque and the
        # earliest window close is the front's.  Forming is therefore
        # O(max_batch + lanes), independent of queue depth — with thousands
        # queued under overload, a full-queue rescan per poll was the
        # serving tier's throughput cap.
        # deadline culling, part 1: expired lane heads never dispatch — pop
        # them eagerly (any seq: an expired query can't affect any result,
        # so it may leave the queue even from behind a barrier)
        expired: list = []
        for name in self.lanes:
            q = self._queues[name]
            while q and q[0].deadline_s is not None \
                    and now >= q[0].deadline_s:
                expired.append(q.popleft())
        bseq = self._barrier_seq()
        take: list = []
        closed = False
        for name, cfg in self.lanes.items():
            q = self._queues[name]
            if q and q[0].seq < bseq:
                closed = closed or now >= q[0].enqueue_s + cfg.window_s
                if len(take) < self.max_batch:
                    for p in q:
                        if p.seq >= bseq or len(take) >= self.max_batch:
                            break
                        take.append(p)
        if take:
            full = len(take) >= self.max_batch
            flush = bool(self._mutations)
            if full or flush or closed:
                for p in take:        # per-lane prefixes: popleft is exact
                    self._queues[p.lane].popleft()
                # deadline culling, part 2: a mid-prefix request may have
                # expired even though its lane head had not
                kept: list = []
                for p in take:
                    (kept if p.deadline_s is None or now < p.deadline_s
                     else expired).append(p)
                if kept:
                    self.stats.batches += 1
                    self.stats.batched_requests += len(kept)
                    h = self.stats.batch_size_hist
                    h[len(kept)] = h.get(len(kept), 0) + 1
                self.stats.expired += len(expired)
                return Batch(requests=kept, formed_s=now, expired=expired)
            if expired:
                self.stats.expired += len(expired)
                return Batch(requests=[], formed_s=now, expired=expired)
            return None
        if expired:
            self.stats.expired += len(expired)
            return Batch(requests=[], formed_s=now, expired=expired)
        if self._mutations:
            self.stats.barriers += 1
            return Barrier(request=self._mutations.popleft())
        return None
