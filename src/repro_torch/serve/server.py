"""DiscoveryServer: the async serving front tier over a DiscoveryEngine.

The engine (serve/engine.py) is a synchronous in-process object; the fused
path makes ``serve_many`` ~8x cheaper per request than one-at-a-time
``serve`` — but only if something assembles batches from concurrent
traffic.  This module is that something::

    server = DiscoveryServer(DiscoveryEngine(lake, live=True))
    fut = server.submit(expr, lane="interactive", tenant="alice")
    resp = fut.result()        # DiscoveryResponse | Overloaded

Requests enter through ``submit`` (thread-safe, returns a
``concurrent.futures.Future``) and are coalesced by the clock-injectable
:class:`~repro_torch.serve.batching.BatchFormer`: requests arriving within a
lane's batching window form one fused ``serve_many`` call, so responses are
**bit-identical to sequential ``serve``** (table ids and scores) — the
fused batch path already guarantees per-request parity, and mutation
barriers guarantee each query observes the same epoch a sequential
arrival-order execution would have shown it.

Serving policy, not just a queue:

* **priority lanes** — ``interactive`` dispatches before ``batch`` within
  every formed batch; each lane has its own coalescing window.
* **per-tenant rate limits** — token buckets shed excess traffic at
  admission with a typed :class:`Overloaded` (``reason='rate_limit'``)
  carrying ``retry_after_s``.
* **backpressure / load shedding** — lane queues are bounded; beyond
  ``max_queue`` requests are rejected with ``Overloaded('queue_full')``
  rather than queued unboundedly, so queue depth (and therefore p99) stays
  bounded under any offered load.
* **mutation barriers** — ``add_table`` / ``drop_table`` / ``compact`` are
  serialized as barrier ops: a mutation waits for every earlier query to
  dispatch, later queries wait for it, and the whole batch executes under
  ``LiveLake.barrier()`` so one consistent epoch is pinned per batch.

One dispatcher thread owns the engine: the executor's program cache,
hash memo and epoch refresh are not thread-safe, and its programs share
one graph memory pool (core/programs.py), so only one thread may replay
them, on one stream.  Submitters only enqueue.  On the card the
dispatcher makes the executor's device current and runs everything on
that device's default stream (PyTorch keeps the current device and stream
per thread); the lazy work of a live engine (the arena refresh, the
captures of new geometries) and ``serve_many``'s pinned transfer run on
it too, inside the batch's ``LiveLake.barrier()``.  ``explain`` takes the
engine lock and runs between batches, on the same device and stream.
Another thread may use the card meanwhile, a second session included:
captures are thread-local (core/programs.py).  One call is the limit: a
device-wide ``torch.cuda.synchronize()`` in another thread while the
dispatcher captures a geometry it has not seen raises in that thread
(``torch.AcceleratorError``, "operation not permitted when stream is
capturing"), because CUDA forbids it during any capture, and it
invalidates the capture.  The dispatcher takes that capture again once
(the ``programs.recaptures`` metric) and answers the request; were the
retry invalidated too, the request's future would hold the typed
``errors.CaptureFailed`` and the server would go on.  A thread beside a
capturing server syncs its own streams (``Stream.synchronize``).
``AsyncDiscoveryServer`` is the asyncio façade: the same futures awaited
via ``asyncio.wrap_future``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from concurrent.futures import Future
from contextlib import nullcontext
from dataclasses import dataclass

import torch

from repro_torch import obs
from repro_torch.errors import DeadlineExceeded, Overloaded
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import (NULL_RECORDER, Recorder, Span,
                                   dump_chrome, recording)
from repro_torch.serve.batching import (BATCH, INTERACTIVE, SHED_RATE_LIMIT,
                                        BatchFormer, Barrier, Batch,
                                        LaneConfig, RateLimiter)
from repro_torch.serve.engine import DiscoveryEngine

__all__ = ["AsyncDiscoveryServer", "DeadlineExceeded", "DiscoveryServer",
           "Overloaded"]


@dataclass
class _QueryJob:
    query: object
    future: Future
    optimize: bool
    deadline_s: float | None = None   # the caller's requested budget


@dataclass
class _MutationJob:
    op: str                       # 'add_table' | 'drop_table' | 'compact'
    args: tuple
    kwargs: dict
    future: Future


class DiscoveryServer:
    """Continuous-batching front tier (see module docstring).

    Parameters mirror the policy surface: ``max_batch`` bounds coalescing,
    ``interactive_window_s`` / ``batch_window_s`` are the per-lane windows,
    ``max_queue`` / ``batch_max_queue`` bound the lanes (backpressure),
    ``rate`` / ``burst`` / ``per_tenant`` configure token buckets
    (``rate=None``: unlimited), ``optimize`` / ``fused`` set the engine
    defaults.  ``start=False`` leaves the dispatcher parked (deterministic
    queue tests); ``now`` injects the clock for admission decisions.

    ``engine`` is a ``DiscoveryEngine`` or a lake, which gets
    ``DiscoveryEngine(lake)``: on the card unless the caller passes an
    engine built with ``device="cpu"``.

    Observability: all serving telemetry lives in ``self.metrics`` — the
    process registry when ``repro_torch.obs`` is enabled (or an explicit
    ``metrics=`` registry), else a private one so :meth:`stats` always
    works.  ``trace=True`` turns on the per-request flight recorder: every
    response carries its span tree (``DiscoveryResponse.trace``), the last
    ``trace_capacity`` request trees are retained, and
    :meth:`dump_trace` exports them as Chrome trace-event JSON."""

    def __init__(self, engine, *, max_batch: int = 16,
                 interactive_window_s: float = 0.002,
                 batch_window_s: float = 0.010,
                 max_queue: int = 256, batch_max_queue: int = 1024,
                 mutation_max_queue: int = 256,
                 rate: float | None = None, burst: float | None = None,
                 per_tenant: dict | None = None,
                 optimize: bool = True, fused: bool = True,
                 start: bool = True, now=time.monotonic,
                 trace: bool = False, trace_capacity: int = 256,
                 metrics: MetricsRegistry | None = None,
                 deadline_margin_s: float = 0.0):
        self.engine = engine if isinstance(engine, DiscoveryEngine) \
            else DiscoveryEngine(engine)
        self.optimize, self.fused = optimize, fused
        self._now = now
        self._former = BatchFormer(
            max_batch=max_batch,
            lanes={INTERACTIVE: LaneConfig(interactive_window_s, max_queue),
                   BATCH: LaneConfig(batch_window_s, batch_max_queue)},
            mutation_max_queue=mutation_max_queue)
        self._limiter = RateLimiter(rate, burst, per_tenant, now=now)
        #: subtracted from every request deadline so the cull happens while
        #: there is still time to *not* dispatch — covers batch-formation
        #: latency between the cull decision and the engine call
        self.deadline_margin_s = float(deadline_margin_s)
        self._cond = threading.Condition()
        self._engine_lock = threading.Lock()
        self._stopping = False
        #: dispatcher sleep state (guarded by _cond): None while it is
        #: processing or between polls, else the absolute deadline it sleeps
        #: toward (inf for an idle wait).  submit uses it to wake the
        #: dispatcher only when an arrival changes its plan.
        self._sleep_deadline: float | None = None
        self.metrics = metrics if metrics is not None else (
            obs.registry() if obs.enabled() else MetricsRegistry(now=now))
        self._trace = trace
        #: flight recorder: span trees of the most recent requests
        self._flight: deque = deque(maxlen=trace_capacity)
        # pre-bound hot-path instruments (one dict lookup saved per submit)
        self._m_submitted = self.metrics.counter("server.submitted")
        self._thread: threading.Thread | None = None
        if start:
            self.start()

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stopping = False
        self._thread = threading.Thread(target=self._loop,
                                        name="discovery-server", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float | None = 30.0):
        """Stop the dispatcher; with ``drain`` (default) every admitted
        request is served first — futures never dangle."""
        with self._cond:
            self._stopping = True
            if not drain:
                while True:
                    work = self._former.poll(float("inf"))
                    if work is None:
                        break
                    reqs = work.requests + work.expired \
                        if isinstance(work, Batch) else [work.request]
                    for p in reqs:
                        p.payload.future.cancel()
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------ admission
    def submit(self, query, *, lane: str = INTERACTIVE,
               tenant: str = "default", optimize: bool | None = None,
               deadline_s: float | None = None) -> Future:
        """Admit one query; returns a Future resolving to a
        ``DiscoveryResponse`` or, when shed, an :class:`Overloaded` (the
        future itself never raises for overload — shedding is a response,
        not an error).  ``deadline_s`` is a *relative* latency budget: if it
        passes while the request is still queued, the request is never
        dispatched and the future resolves to :class:`DeadlineExceeded`
        (minus ``deadline_margin_s`` of headroom for batch formation)."""
        fut: Future = Future()
        job = _QueryJob(query, fut,
                        self.optimize if optimize is None else optimize,
                        deadline_s)
        with self._cond:
            now = self._now()
            ok, retry = self._limiter.admit(tenant, now=now)
            if not ok:
                self.metrics.counter(
                    f"server.shed.{SHED_RATE_LIMIT}").inc()
                fut.set_result(Overloaded(SHED_RATE_LIMIT, lane, tenant,
                                          retry_after_s=retry))
                return fut
            cutoff = None if deadline_s is None \
                else now + deadline_s - self.deadline_margin_s
            pending, reason = self._former.submit(job, lane=lane,
                                                  tenant=tenant, now=now,
                                                  deadline_s=cutoff)
            if pending is None:
                self.metrics.counter(f"server.shed.{reason}").inc()
                fut.set_result(Overloaded(reason, lane, tenant))
                return fut
            self._m_submitted.inc()
            wake = now + self._former.lanes[lane].window_s
            self._wake(wake if cutoff is None else min(wake, cutoff))
        return fut

    def serve(self, query, **kw):
        """Synchronous convenience: submit + wait."""
        return self.submit(query, **kw).result()

    def _submit_mutation(self, op: str, *args, **kwargs) -> Future:
        fut: Future = Future()
        job = _MutationJob(op, args, kwargs, fut)
        with self._cond:
            now = self._now()
            pending, reason = self._former.submit(job, kind="mutation",
                                                  now=now)
            if pending is None:
                fut.set_result(Overloaded(reason, BatchFormer.MUTATION_LANE,
                                          "default"))
                return fut
            self._wake(now)           # a barrier cuts every window short
        return fut

    def _wake(self, deadline: float):
        """Wake the dispatcher only when this arrival changes its plan: it
        is sleeping AND (the arrival's window deadline is earlier than the
        one it sleeps toward, or a full batch is probably ready).  Waking on
        every submit would make the dispatcher rescan its queues once per
        admitted request — an O(depth) cost that caps goodput well below
        the fused engine's capacity at saturating offered load.  Caller
        holds ``_cond``."""
        sd = self._sleep_deadline
        if sd is None:                # processing: it re-polls on its own
            return
        if deadline < sd or \
                sum(self._former.depth().values()) >= self._former.max_batch:
            self._cond.notify()

    def add_table(self, table, name: str | None = None) -> Future:
        """Enqueue a barrier mutation; the future resolves to the table id
        once every earlier query has been served at the old epoch."""
        return self._submit_mutation("add_table", table, name=name)

    def drop_table(self, ref) -> Future:
        return self._submit_mutation("drop_table", ref)

    def compact(self, **kw) -> Future:
        return self._submit_mutation("compact", **kw)

    # ------------------------------------------------------------ dispatcher
    def _device_scope(self):
        """The engine's CUDA device made current, and its default stream
        the current stream, for the calling thread (a no-op on the CPU):
        every replay of the executor's programs then runs on one stream,
        whichever thread runs it."""
        dev = self.engine.executor.device
        if dev.type != "cuda":
            return nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(dev))
        stack.enter_context(torch.cuda.stream(torch.cuda.default_stream(dev)))
        return stack

    def _loop(self):
        with self._device_scope():
            self._dispatch()

    def _dispatch(self):
        while True:
            with self._cond:
                while True:
                    # when stopping, flush every open window (drain): poll
                    # at t=inf closes all of them, so no future dangles
                    now = float("inf") if self._stopping else self._now()
                    work = self._former.poll(now)
                    if work is not None:
                        break
                    if self._stopping:
                        return
                    deadline = self._former.next_deadline(self._now())
                    timeout = None if deadline is None \
                        else max(deadline - self._now(), 0.0)
                    self._sleep_deadline = float("inf") if deadline is None \
                        else deadline
                    self._cond.wait(timeout=timeout)
                    self._sleep_deadline = None
            if isinstance(work, Batch):
                if work.expired:
                    self._expire(work.expired)
                if work.requests:
                    self._run_batch(work)
            else:
                self._run_barrier(work)

    def _epoch_barrier(self):
        """Pin one consistent epoch for a whole engine call: hold the
        LiveLake mutation barrier so nothing (server mutations run on this
        same thread; direct user mutations run anywhere) can move the store
        epoch while a batch is in flight."""
        live = self.engine.live
        return live.barrier() if live is not None else nullcontext()

    def _expire(self, expired: list):
        """Resolve deadline-culled requests with a typed
        :class:`DeadlineExceeded` — they were never dispatched, so no device
        work was wasted on answers nobody is waiting for."""
        now = self._now()
        m = self.metrics.counter("server.deadline_exceeded")
        for p in expired:
            m.inc()
            job = p.payload
            if not job.future.done():
                job.future.set_result(DeadlineExceeded(
                    p.lane, p.tenant, deadline_s=job.deadline_s,
                    waited_s=max(now - p.enqueue_s, 0.0)))

    def _run_batch(self, batch: Batch):
        start = self._now()
        jobs = [p.payload for p in batch.requests]
        reg = self.metrics
        rec = Recorder(now=self._now) if self._trace else NULL_RECORDER
        try:
            with recording(rec), \
                    rec.span("batch", tid="dispatcher",
                             requests=len(jobs)) as bspan:
                with contextlib.ExitStack() as stack:
                    # pin_epoch measures lock + mutation-barrier wait; the
                    # barrier stays held for the whole dispatch below
                    with rec.span("pin_epoch"):
                        stack.enter_context(self._engine_lock)
                        stack.enter_context(self._epoch_barrier())
                    responses: list = [None] * len(jobs)
                    # per-request optimize overrides partition the batch;
                    # each partition is still one fused serve_many call
                    by_opt: dict = {}
                    for i, job in enumerate(jobs):
                        by_opt.setdefault(job.optimize, []).append(i)
                    for opt, idxs in by_opt.items():
                        out = self.engine.serve_many(
                            [jobs[i].query for i in idxs], optimize=opt,
                            fused=self.fused)
                        for i, resp in zip(idxs, out):
                            responses[i] = resp
        except BaseException as e:                   # noqa: BLE001
            reg.counter("server.batch_errors").inc()
            for job in jobs:
                if not job.future.done():
                    job.future.set_exception(e)
            return
        end = self._now()
        launches = max(r.launches for r in responses)
        ndeg = sum(1 for r in responses if getattr(r, "degraded", False))
        if ndeg:
            reg.counter("server.degraded").inc(ndeg)
        reg.counter("server.served").inc(len(jobs))
        reg.counter("server.batches").inc()
        reg.counter("server.launches").inc(launches)
        reg.gauge("server.launches_last_batch").set(launches)
        reg.histogram("server.batch_size", lo=1.0).observe(len(jobs))
        reg.histogram("server.batch_seconds").observe(end - start)
        for d_lane, d in self._former.depth().items():
            reg.gauge(f"server.queue_depth.{d_lane}").set(d)
        for p, job, resp in zip(batch.requests, jobs, responses):
            resp.queue_seconds = max(start - p.enqueue_s, 0.0)
            resp.batch_size = len(batch.requests)
            reg.histogram(f"server.queue_seconds.{p.lane}").observe(
                resp.queue_seconds)
            reg.histogram(f"server.e2e_seconds.{p.lane}").observe(
                max(end - p.enqueue_s, 0.0))
            if self._trace:
                # per-request tree: its own queue wait, then the (shared)
                # batch subtree — chrome_trace emits shared subtrees once.
                # queue + batch are contiguous wall-clock intervals, so the
                # root's children tile its whole [enqueue, end] extent.
                root = Span("request", t0=min(p.enqueue_s, start), t1=end,
                            tid=f"req-{p.seq}",
                            attrs={"lane": p.lane, "tenant": p.tenant,
                                   "batch_size": len(batch.requests)})
                root.children.append(
                    Span("queue", t0=root.t0, t1=start, tid=root.tid))
                root.children.append(bspan)
                resp.trace = root
                self._flight.append(root)
            if not job.future.cancelled():
                job.future.set_result(resp)

    def _run_barrier(self, barrier: Barrier):
        job = barrier.request.payload
        t0 = self._now()
        try:
            with self._engine_lock:
                out = getattr(self.engine, job.op)(*job.args, **job.kwargs)
        except BaseException as e:                   # noqa: BLE001
            self.metrics.counter("server.mutation_errors").inc()
            if not job.future.done():
                job.future.set_exception(e)
            return
        self.metrics.counter("server.mutations").inc()
        self.metrics.histogram("server.mutation_seconds").observe(
            self._now() - t0)
        if not job.future.cancelled():
            job.future.set_result(out)

    # ------------------------------------------------------------ inspection
    @property
    def session(self):
        return self.engine.session

    def stats(self) -> dict:
        """Serving telemetry: queue depth and occupancy per lane, shed
        counts by reason/lane/tenant, batch-size histogram, aggregate
        launches per batch, mutation counters.  A thin reader: all serving
        counters live in ``self.metrics`` (admission/queue-shape state stays
        in the BatchFormer/RateLimiter, which own those decisions)."""
        with self._cond:
            f = self._former
            s = f.stats
            reg = self.metrics
            depth = f.depth()
            occupancy = {
                name: {"depth": depth[name], "max_queue": cfg.max_queue,
                       "utilization": depth[name] / cfg.max_queue}
                for name, cfg in f.lanes.items()}
            rate_sheds = sum(self._limiter.sheds.values())
            queue_sheds = sum(s.shed.values())
            batches = max(s.batches, 1)
            launches_total = int(reg.counter("server.launches").value)
            return {
                "running": self._thread is not None
                and self._thread.is_alive(),
                "served": int(reg.counter("server.served").value),
                "queue_depth": depth,
                "lane_occupancy": occupancy,
                "shed": {SHED_RATE_LIMIT: rate_sheds, **s.shed,
                         "total": rate_sheds + queue_sheds,
                         "by_lane": {k: dict(v)
                                     for k, v in s.shed_by_lane.items()},
                         "by_tenant": dict(self._limiter.sheds)},
                "batches": {"formed": s.batches,
                            "requests": s.batched_requests,
                            "mean_size": s.batched_requests / batches,
                            "size_hist": {str(k): v for k, v in
                                          sorted(s.batch_size_hist.items())}},
                "launches": {"total": launches_total,
                             "per_batch_mean": launches_total / batches,
                             "last_batch": int(reg.gauge(
                                 "server.launches_last_batch").value)},
                "mutations": {"executed": int(reg.counter(
                                  "server.mutations").value),
                              "pending": depth[f.MUTATION_LANE]},
                "deadline_exceeded": s.expired,
                "degraded": int(reg.counter("server.degraded").value),
            }

    def dump_trace(self, path):
        """Export the flight recorder (the last ``trace_capacity`` request
        span trees) as Chrome trace-event JSON loadable in Perfetto /
        ``chrome://tracing``; returns ``path``."""
        with self._cond:
            roots = list(self._flight)
        return dump_chrome(roots, path)

    def explain(self, query, **kw):
        """``session.explain`` with the server's stats attached (rendered as
        the ``== server ==`` section).  Takes the engine lock: the explain
        runs between batches, never concurrently with one."""
        with self._engine_lock, self._epoch_barrier(), self._device_scope():
            return self.session.explain(query, server=self.stats(), **kw)


class AsyncDiscoveryServer:
    """Asyncio façade over :class:`DiscoveryServer`: the same thread-based
    queue underneath, awaited via ``asyncio.wrap_future``::

        async with AsyncDiscoveryServer(engine) as server:
            resp = await server.serve(expr, tenant="alice")

    Wraps an existing server or constructs one from the same kwargs."""

    def __init__(self, engine_or_server, **kw):
        self.server = engine_or_server \
            if isinstance(engine_or_server, DiscoveryServer) \
            else DiscoveryServer(engine_or_server, **kw)

    async def serve(self, query, **kw):
        import asyncio
        return await asyncio.wrap_future(self.server.submit(query, **kw))

    async def add_table(self, table, name: str | None = None):
        import asyncio
        return await asyncio.wrap_future(self.server.add_table(table,
                                                               name=name))

    async def drop_table(self, ref):
        import asyncio
        return await asyncio.wrap_future(self.server.drop_table(ref))

    async def compact(self, **kw):
        import asyncio
        return await asyncio.wrap_future(self.server.compact(**kw))

    def stats(self) -> dict:
        return self.server.stats()

    async def __aenter__(self):
        self.server.start()
        return self

    async def __aexit__(self, *exc):
        self.server.stop()
