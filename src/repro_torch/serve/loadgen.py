"""Trace-driven load generation for the serving front tier.

Two halves, split so determinism is structural rather than accidental:

* **trace generation** (:func:`make_trace`) is a pure function of its seed —
  no wall clock, no global RNG.  It emits a list of timestamped
  :class:`TraceEvent`\\ s: a Zipf-distributed query mix over a fixed pool of
  distinct BlendQL queries (repeats share canonical fingerprints, so the
  hot head of the distribution is exactly the query-cache-friendly part of
  the space), bursty Markov-modulated Poisson arrivals (ON periods run at
  ``burst_factor`` times the base rate), a tenant/lane mix, and optional
  mutation traffic (add/drop cycles over deterministically generated
  tables, dropped by name so replay never waits on an add's table id).
* **replay** (:func:`replay`) walks a trace against a live
  ``DiscoveryServer`` in open-loop mode: each event is submitted at its
  scheduled offset regardless of completions (offered load is controlled,
  not gated on service), futures are collected, and the report aggregates
  client-observed latency (submit -> future done), goodput, shed rate, and
  the server's own batching stats.

Reproducibility contract (BENCH_7): everything random derives from
``seed``; replay's only nondeterminism is scheduler jitter on the arrival
sleeps — run-to-run latency distributions match modulo machine noise.
"""
from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field

import numpy as np

import repro_torch as blend
from repro_torch.core.lake import Table
from repro_torch.errors import DeadlineExceeded, Overloaded
from repro_torch.serve.batching import BATCH, INTERACTIVE


@dataclass
class TraceEvent:
    t: float                      # seconds from trace start
    kind: str                     # 'query' | 'add' | 'drop'
    tenant: str = "default"
    lane: str = INTERACTIVE
    qid: int = -1                 # index into the query pool (queries)
    payload: object = None        # query expr / Table to add / name to drop


@dataclass
class Trace:
    events: list
    seed: int
    duration_s: float
    config: dict = field(default_factory=dict)

    @property
    def offered_rps(self) -> float:
        n = sum(1 for e in self.events if e.kind == "query")
        return n / self.duration_s if self.duration_s else 0.0


def query_pool(lake, rng, n_distinct: int = 24, k: int = 24) -> list:
    """A fixed pool of distinct queries covering all four seekers and every
    combiner shape (the fingerprint space Zipf ranks over).  Seeded: the
    same ``rng`` state yields the same pool."""
    pool = []
    for i in range(n_distinct):
        t = lake.tables[int(rng.integers(0, lake.n_tables))]
        rows = rng.choice(t.n_rows, min(6, t.n_rows), replace=False)
        sc = blend.sc([t.columns[0][r] for r in rows], k=k)
        kw = blend.kw([t.columns[1][rows[0]], t.columns[1][rows[1]]], k=k)
        mc = blend.mc([(t.columns[0][r], t.columns[1][r]) for r in rows[:4]],
                      k=k)
        corr = blend.corr([t.columns[0][r] for r in rows],
                          [float(j) for j in range(len(rows))], k=k)
        shape = i % 6
        if shape == 0:
            q = (sc & mc).top(10)
        elif shape == 1:
            q = (sc | corr).top(10)
        elif shape == 2:
            q = blend.counter(sc, kw, mc, k=10)
        elif shape == 3:
            q = (mc - kw).top(10)
        elif shape == 4:
            q = ((sc & kw) | corr).top(10)
        else:
            q = sc.top(10)
        pool.append(q)
    return pool


def zipf_qids(rng, n_distinct: int, size: int, a: float = 1.1) -> np.ndarray:
    """Bounded Zipf over pool ranks: P(rank r) ~ 1/r^a.  (``rng.zipf`` is
    unbounded; discovery traffic wants a fixed catalog of hot queries.)"""
    w = 1.0 / np.arange(1, n_distinct + 1, dtype=np.float64) ** a
    return rng.choice(n_distinct, size=size, p=w / w.sum())


def mutation_table(seed: int, i: int, rows: int = 20,
                   vocab: int = 400) -> Table:
    """A deterministically generated table for add/drop traffic; its name
    encodes (seed, i) so drops resolve by name without waiting on ids."""
    rng = np.random.default_rng(900_000 + seed * 10_000 + i)
    return Table(f"loadgen_{seed}_{i}",
                 [[f"tok_{int(x)}" for x in rng.integers(0, vocab, rows)],
                  [f"tok_{int(x)}" for x in rng.integers(0, vocab, rows)],
                  [float(x) for x in np.round(rng.normal(0, 5, rows), 3)]])


def make_trace(lake, *, seed: int = 0, duration_s: float = 2.0,
               rate_rps: float = 200.0, zipf_a: float = 1.1,
               n_distinct: int = 24, k: int = 24,
               tenants: tuple = ("tenant_a", "tenant_b", "tenant_c"),
               p_interactive: float = 0.7, p_mutation: float = 0.0,
               burst_factor: float = 4.0, burst_fraction: float = 0.2,
               mean_burst_s: float = 0.05) -> Trace:
    """Generate a deterministic trace (see module docstring).

    Arrivals are Markov-modulated Poisson: exponential ON/OFF state
    holding times (ON mean ``mean_burst_s``, OFF mean chosen so the
    long-run ON fraction is ``burst_fraction``), with the instantaneous
    rate scaled so the *average* offered rate is ``rate_rps``."""
    rng = np.random.default_rng(seed)
    pool = query_pool(lake, rng, n_distinct=n_distinct, k=k)
    bf = min(max(burst_fraction, 0.0), 1.0)
    # average rate = base * ((1 - bf) + bf * burst_factor)
    base = rate_rps / ((1.0 - bf) + bf * burst_factor)
    mean_off_s = mean_burst_s * (1.0 - bf) / bf if 0.0 < bf < 1.0 \
        else float("inf")

    events: list = []
    t = 0.0
    in_burst = bf >= 1.0
    state_end = (rng.exponential(mean_burst_s) if in_burst
                 else rng.exponential(mean_off_s)) if bf not in (0.0, 1.0) \
        else float("inf")
    n_added = 0
    alive: list = []              # names of loadgen tables currently added
    while True:
        rate = base * (burst_factor if in_burst else 1.0)
        t += rng.exponential(1.0 / rate)
        while t > state_end:
            in_burst = not in_burst
            state_end += rng.exponential(
                mean_burst_s if in_burst else mean_off_s)
        if t >= duration_s:
            break
        tenant = str(tenants[int(rng.integers(0, len(tenants)))])
        if p_mutation > 0.0 and rng.random() < p_mutation:
            if alive and (len(alive) > 8 or rng.random() < 0.5):
                name = alive.pop(0)
                events.append(TraceEvent(t=t, kind="drop", tenant=tenant,
                                         payload=name))
            else:
                tab = mutation_table(seed, n_added)
                alive.append(tab.name)
                n_added += 1
                events.append(TraceEvent(t=t, kind="add", tenant=tenant,
                                         payload=tab))
            continue
        qid = int(zipf_qids(rng, n_distinct, 1, a=zipf_a)[0])
        lane = INTERACTIVE if rng.random() < p_interactive else BATCH
        events.append(TraceEvent(t=t, kind="query", tenant=tenant,
                                 lane=lane, qid=qid, payload=pool[qid]))
    return Trace(events=events, seed=seed, duration_s=duration_s,
                 config={"rate_rps": rate_rps, "zipf_a": zipf_a,
                         "n_distinct": n_distinct, "k": k,
                         "tenants": list(tenants),
                         "p_interactive": p_interactive,
                         "p_mutation": p_mutation,
                         "burst_factor": burst_factor,
                         "burst_fraction": burst_fraction})


@dataclass
class ReplayReport:
    offered: int                  # query events submitted
    completed: int                # queries answered with a DiscoveryResponse
    shed: int                     # queries answered with Overloaded
    mutations: int                # mutation events submitted
    makespan_s: float             # first submit -> last future done
    latencies_s: list             # client-observed, completed queries only
    queue_s: list                 # server-reported queue time per response
    batch_sizes: list             # coalesced batch size per response
    shed_reasons: dict
    server_stats: dict
    expired: int = 0              # queries answered with DeadlineExceeded
    retried: int = 0              # shed queries resubmitted with backoff
    gave_up: int = 0              # still Overloaded after max_retries

    @property
    def goodput_rps(self) -> float:
        return self.completed / self.makespan_s if self.makespan_s else 0.0

    @property
    def shed_rate(self) -> float:
        return self.shed / self.offered if self.offered else 0.0

    def percentile_ms(self, q: float) -> float:
        if not self.latencies_s:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_s), q) * 1e3)

    def as_dict(self) -> dict:
        return {
            "offered": self.offered, "completed": self.completed,
            "shed": self.shed, "mutations": self.mutations,
            "makespan_s": round(self.makespan_s, 4),
            "offered_rps": round(self.offered / self.makespan_s, 2)
            if self.makespan_s else 0.0,
            "goodput_rps": round(self.goodput_rps, 2),
            "shed_rate": round(self.shed_rate, 4),
            "shed_reasons": dict(self.shed_reasons),
            "deadline_exceeded": self.expired,
            "retries": {"resubmitted": self.retried,
                        "gave_up": self.gave_up},
            "latency_ms": {"p50": round(self.percentile_ms(50), 3),
                           "p95": round(self.percentile_ms(95), 3),
                           "p99": round(self.percentile_ms(99), 3)},
            "queue_ms_p50": round(float(np.percentile(
                np.asarray(self.queue_s), 50) * 1e3), 3)
            if self.queue_s else 0.0,
            "queue_ms_p99": round(float(np.percentile(
                np.asarray(self.queue_s), 99) * 1e3), 3)
            if self.queue_s else 0.0,
            "batch_size_mean": round(float(np.mean(self.batch_sizes)), 2)
            if self.batch_sizes else 0.0,
            "batch_occupancy_hist":
                self.server_stats["batches"]["size_hist"],
        }


class _Flight:
    """One trace event's lifecycle across (re)submissions."""
    __slots__ = ("ev", "fut", "attempts")

    def __init__(self, ev, fut):
        self.ev = ev
        self.fut = fut
        self.attempts = 0


def replay(server, trace: Trace, *, timeout_s: float = 120.0,
           sleep=time.sleep, now=time.perf_counter,
           deadline_s: float | None = None, max_retries: int = 0,
           base_backoff_s: float = 0.01, max_backoff_s: float = 0.25,
           retry_jitter: float = 0.5) -> ReplayReport:
    """Open-loop replay (see module docstring).  ``sleep``/``now`` are
    injectable for tests that replay without real pacing.

    ``deadline_s`` attaches a per-query latency budget (the server answers
    ``DeadlineExceeded`` for requests whose budget passes while queued;
    counted as ``expired``, never as completed or shed).

    ``max_retries > 0`` turns on well-behaved client retries: a shed query
    is resubmitted after capped exponential backoff floored at the server's
    ``retry_after_s`` hint, with seeded proportional jitter.  Sheds resolve
    synchronously at submit, so retries are scheduled inline on the pacing
    thread and fire at their due times *during* the replay — offered load
    stays open-loop.  Retries default **off**: a pure-shed replay measures
    admission policy, not client politeness."""
    t0 = now()
    rng = np.random.default_rng(trace.seed ^ 0x5E77)
    done_at: dict = {}            # future -> completion wall time
    records: list = []            # of _Flight
    due: list = []                # heap of (due_s, tiebreak, flight)
    tie = itertools.count()
    retried = gave_up = 0

    def _submit(ev):
        if ev.kind == "query":
            kw = {"lane": ev.lane, "tenant": ev.tenant}
            if deadline_s is not None:
                kw["deadline_s"] = deadline_s
            fut = server.submit(ev.payload, **kw)
        elif ev.kind == "add":
            fut = server.add_table(ev.payload, name=ev.payload.name)
        else:
            fut = server.drop_table(ev.payload)
        fut.add_done_callback(lambda f, _now=now: done_at.setdefault(f,
                                                                     _now()))
        return fut

    def _maybe_schedule_retry(fl):
        """Sheds resolve synchronously inside ``submit`` — inspect the
        future right away and queue a backed-off resubmission."""
        nonlocal gave_up
        if not max_retries or fl.ev.kind != "query" or not fl.fut.done():
            return
        try:
            out = fl.fut.result(timeout=0)
        except BaseException:                        # noqa: BLE001
            return
        if not isinstance(out, Overloaded):
            return
        if fl.attempts >= max_retries:
            gave_up += 1
            return
        backoff = base_backoff_s * (2.0 ** fl.attempts)
        if out.retry_after_s:
            backoff = max(backoff, float(out.retry_after_s))
        backoff = min(backoff, max_backoff_s)
        if retry_jitter:
            backoff *= 1.0 + retry_jitter * float(rng.uniform(0.0, 1.0))
        fl.attempts += 1
        heapq.heappush(due, (now() + backoff, next(tie), fl))

    def _drain_due(limit_s):
        nonlocal retried
        while due and due[0][0] <= limit_s:
            _, _, fl = heapq.heappop(due)
            retried += 1
            fl.fut = _submit(fl.ev)
            _maybe_schedule_retry(fl)

    for ev in trace.events:
        _drain_due(now())
        delay = ev.t - (now() - t0)
        if delay > 0:
            sleep(delay)
        fl = _Flight(ev, _submit(ev))
        records.append(fl)
        _maybe_schedule_retry(fl)
    while due:                    # post-trace: flush remaining retries
        wait = due[0][0] - now()
        if wait > 0:
            sleep(wait)
        _drain_due(now())

    offered = completed = shed = mutations = expired = 0
    latencies: list = []
    queue_s: list = []
    batch_sizes: list = []
    shed_reasons: dict = {}
    last_done = t0
    for fl in records:
        ev, fut = fl.ev, fl.fut
        out = fut.result(timeout=timeout_s)
        last_done = max(last_done, done_at.get(fut, now()))
        if ev.kind != "query":
            mutations += 1
            continue
        offered += 1
        if isinstance(out, Overloaded):
            shed += 1
            shed_reasons[out.reason] = shed_reasons.get(out.reason, 0) + 1
            continue
        if isinstance(out, DeadlineExceeded):
            expired += 1
            continue
        completed += 1
        latencies.append(done_at[fut] - (t0 + ev.t))
        queue_s.append(out.queue_seconds)
        batch_sizes.append(out.batch_size)
    return ReplayReport(offered=offered, completed=completed, shed=shed,
                        mutations=mutations, makespan_s=last_done - t0,
                        latencies_s=latencies, queue_s=queue_s,
                        batch_sizes=batch_sizes, shed_reasons=shed_reasons,
                        server_stats=server.stats(), expired=expired,
                        retried=retried, gave_up=gave_up)
