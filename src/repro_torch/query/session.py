"""The unified Session API: ``repro_torch.connect(lake) -> Session``.

A Session owns the resident unified index + executor and compiles BlendQL
(fluent expressions or SQL strings) through the full stack::

    parse/IR -> rewrite (rules.py) -> lower (lower.py) -> Plan
             -> optimize + execute (core/optimizer.py, core/executor.py)

``session.query`` and ``session.sql`` return a ``QueryResult``;
``session.explain`` additionally renders the logical tree, the applied
rewrite rules, the ranked physical order and per-node timings.  Legacy
physical ``Plan`` objects are accepted everywhere an expression is.

``query(fused=True)`` and ``query_many`` run on the fused path
(core/fused.py).  ``connect(lake, live=True)`` serves a LiveLake
(store/): the session gains ``add_table`` / ``add_tables`` /
``drop_table`` / ``compact`` / ``snapshot``, ``restore`` reopens a
snapshot and ``recover`` replays snapshot + write-ahead log.
``connect(lake, cache=True)`` gives the session a semantic query cache
(serve/cache.py); ``explain(server=)`` renders the batching server's
stats (serve/server.py).  ``connect(lake, shards=N)`` partitions the
store along the table axis (dist/shard.py).  ``query(approx=...)`` answers
from the sketch tier (core/sketch.py) and escalates only the contended
boundary of the top-k to the exact path.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch import obs
from repro_torch.core import combiners as comb
from repro_torch.core import sketch as sk
from repro_torch.core.combiners import ResultSet
from repro_torch.core.cost_model import CostModel
from repro_torch.core.executor import ExecInfo, Executor
from repro_torch.core.index import build_index, resolve_device
from repro_torch.core.optimizer import optimize as optimize_plan
from repro_torch.core.plan import Plan
from repro_torch.dist.shard import ShardedExecutor, ShardedStore
from repro_torch.obs import trace as otrace
from repro_torch.query import logical as L
from repro_torch.query.fingerprint import object_nonce
from repro_torch.query.lower import lower
from repro_torch.query.parse import parse
from repro_torch.query.rules import prune_dead_nodes, rewrite
from repro_torch.store.live import LiveLake


@dataclass
class Compiled:
    """Output of the logical pipeline, ready for (repeated) execution."""
    plan: Plan
    logical: L.Expr | None            # rewritten IR (None for legacy plans)
    raw: L.Expr | None                # IR as written, pre-rewrite
    applied_rules: list = field(default_factory=list)
    node_of: dict = field(default_factory=dict)   # IR node -> plan-node name


@dataclass
class QueryResult:
    result: object                    # core.combiners.ResultSet (on device)
    info: ExecInfo
    compiled: Compiled
    seconds: float
    _ids: list | None = None
    cache: object | None = None       # serve.cache.CacheInfo (None: cache off)
    _entry: object | None = None      # the CachedResult behind this result
    #: core.sketch.ApproxInfo when the query ran with ``approx=`` (estimates,
    #: intervals, escalation accounting); None on the exact path
    approx: object | None = None

    @property
    def scores(self):
        """Dense f32 [n_tables] score tensor on the executor's device."""
        return self.result.scores

    @property
    def ids(self) -> list:
        """Ranked table ids, score-descending (materialized lazily, so a
        ``sync=False`` dispatch stays free of host synchronization; a result
        backed by a cache entry writes the list back into it, so later hits
        skip the transfer)."""
        if self._ids is None:
            self._ids = [int(t) for t in self.result.ids()]
            if self._entry is not None and self._entry.ids is None:
                self._entry.ids = self._ids
        return self._ids

    def materialize(self, scores_np, mask_np) -> list:
        """Install ids from already-fetched host arrays (``serve_many``
        fetches a whole batch's (scores, mask) pairs in one transfer).
        Ranking goes through ``ResultSet.rank``, the code path the lazy
        ``ids`` property uses, with the same cache-entry write-back."""
        if self._ids is None:
            self._ids = [int(t) for t in ResultSet.rank(scores_np, mask_np)]
            if self._entry is not None and self._entry.ids is None:
                self._entry.ids = self._ids
        return self._ids

    @property
    def applied_rules(self):
        return self.compiled.applied_rules

    def __iter__(self):
        return iter(self.ids)


@dataclass
class Explain:
    logical_tree: str
    applied_rules: list
    physical_order: dict              # intersect node -> ranked seeker names
    exec_order: list                  # actual execution order (ExecInfo)
    node_seconds: dict
    overflow: int
    ids: list
    launches: int = 0                 # device-program dispatches (ExecInfo)
    index_shape: dict = field(default_factory=dict)   # Session.index_shape
    cache: dict = field(default_factory=dict)         # query-cache telemetry
    server: dict = field(default_factory=dict)        # front-tier telemetry
    metrics: dict = field(default_factory=dict)       # obs registry snapshot

    def __str__(self):
        lines = ["== logical plan =="]
        lines += [self.logical_tree]
        lines.append("== rewrite rules applied ==")
        lines += [f"  - {r}" for r in self.applied_rules] or ["  (none)"]
        if self.index_shape:
            s = self.index_shape
            lines.append("== index ==")
            if s.get("shards"):
                mesh = "x".join(str(d) for d in s["mesh_shape"])
                lines.append(f"  mode: {s['mode']}   mesh: {mesh} "
                             f"({s['shards']} shards)   "
                             f"epoch: {s['epoch']}")
                for p in s["per_shard"]:
                    lines.append(f"  shard {p['shard']}: "
                                 f"segments: {p['segments']}   "
                                 f"postings: {p['postings']}   "
                                 f"tables: {p['live_tables']}   "
                                 f"tombstones: {p['tombstones']}   "
                                 f"[{p['device']}]")
            else:
                lines.append(f"  mode: {s['mode']}   epoch: {s['epoch']}   "
                             f"segments: {s['segments']}")
                lines.append(
                    f"  postings/segment: {s['postings_per_segment']}")
            lines.append(f"  live tables: {s['live_tables']}"
                         + (f"   tombstoned: {s['tombstoned']}"
                            if s["tombstoned"] else ""))
        if self.cache:
            c = self.cache
            lines.append("== cache ==")
            lines.append(f"  status: {c['status']}   "
                         f"seekers: {c['seekers_run']} run / "
                         f"{c['seekers_cached']} cached   "
                         f"epoch: {c['epoch']}")
            lines.append(f"  entries: {c['entries']}   bytes: {c['bytes']}   "
                         f"evictions: {c['evictions']}   "
                         f"invalidations: {c['invalidations']}")
        if self.server:
            s = self.server
            depth = s["queue_depth"]
            lines.append("== server ==")
            lines.append(
                "  queue depth: "
                + "   ".join(f"{k}: {v}" for k, v in depth.items()))
            occ = s["lane_occupancy"]
            lines.append(
                "  lane occupancy: "
                + "   ".join(f"{k}: {v['depth']}/{v['max_queue']}"
                             for k, v in occ.items()))
            lines.append(f"  served: {s['served']}   "
                         f"shed: {s['shed']['total']} "
                         f"(rate_limit: {s['shed'].get('rate_limit', 0)}, "
                         f"queue_full: {s['shed'].get('queue_full', 0)})")
            lines.append(f"  batches: {s['batches']['formed']}   "
                         f"mean size: {s['batches']['mean_size']:.2f}   "
                         f"launches/batch: "
                         f"{s['launches']['per_batch_mean']:.2f}")
        if self.metrics:
            m = self.metrics
            lines.append("== metrics ==")
            for name, v in m.get("counters", {}).items():
                lines.append(f"  {name:<40s} {v:,.0f}")
            for name, v in m.get("gauges", {}).items():
                lines.append(f"  {name:<40s} {v:,.1f}")
            for name, h in m.get("histograms", {}).items():
                scale, unit = (1e3, "ms") if "seconds" in name \
                    else (1.0, "")
                lines.append(f"  {name:<40s} n={h['count']:<7d} "
                             f"p50={h['p50'] * scale:9.3f}{unit} "
                             f"p95={h['p95'] * scale:9.3f}{unit} "
                             f"p99={h['p99'] * scale:9.3f}{unit}")
        lines.append("== physical order (ranked execution groups) ==")
        if self.physical_order:
            for comb, seekers in self.physical_order.items():
                lines.append(f"  {comb}: {' -> '.join(seekers)}")
        else:
            lines.append("  (no reorderable intersection groups)")
        if self.exec_order:
            lines.append("== execution ==")
            lines.append(f"  order: {' -> '.join(self.exec_order)}")
            for name in self.exec_order:
                if name in self.node_seconds:
                    lines.append(f"  {name:<14s} "
                                 f"{self.node_seconds[name]*1e3:8.2f} ms")
            lines.append(f"  launches: {self.launches}")
            lines.append(f"  overflow: {self.overflow}")
            lines.append(f"  top tables: {list(self.ids)[:10]}")
        return "\n".join(lines)


class Session:
    """A connection to one lake: resident index, executor, cost model, and
    the BlendQL compile pipeline (with a bounded compiled-plan memo).  Over
    a live lake (``connect(lake, live=True)``) the Session also exposes the
    mutation API — ``add_table`` / ``add_tables`` / ``drop_table`` /
    ``compact`` / ``snapshot`` — and ``explain`` reports the index shape
    (segments, postings, tombstones, epoch).  With ``connect(lake,
    cache=True)`` the Session also owns a semantic QueryCache
    (serve/cache.py): plan, result and seeker levels keyed on canonical
    fingerprints and invalidated by ``(epoch, index fingerprint)``."""

    def __init__(self, executor: Executor, lake=None,
                 cost_model: CostModel | None = None, live=None, cache=None):
        self.executor = executor
        self.lake = lake
        self.cost_model = cost_model
        self.live = live                  # LiveLake handle or None
        self.cache = cache                # serve.cache.QueryCache or None
        self._plan_memo = {}              # cache-off compile memo (bounded)

    @property
    def index(self):
        return self.executor.index

    def _cache_config(self) -> tuple:
        """The execution-identity part of the cache key: entries produced
        under other executor options (capacity ladder, probe backend,
        device) or another cost model (seeker ranking, so f32 sum order)
        are other computations and never cross-serve (serve/cache.py
        ``begin``)."""
        ex = self.executor
        return (ex.backend, str(ex.device), ex.m_cap_max, ex.row_cap,
                ex.bucket_width, getattr(ex, "n_shards", 0),
                object_nonce(self.cost_model)
                if self.cost_model is not None else 0)

    # ------------------------------------------------------------ mutations
    def _require_live(self):
        if self.live is None:
            raise RuntimeError("this session is static; open one with "
                               "repro_torch.connect(lake, live=True) to "
                               "mutate")
        return self.live

    def add_table(self, table, name: str | None = None) -> int:
        """Index one new table without a rebuild; returns its table id."""
        return self._require_live().add_table(table, name=name)

    def add_tables(self, tables, names=None) -> list:
        """Bulk ingest: one WAL group commit covers the whole batch."""
        return self._require_live().add_tables(tables, names=names)

    def drop_table(self, ref) -> int:
        """Drop a table (id or name): tombstoned, or whole-run removed."""
        return self._require_live().drop_table(ref)

    def compact(self, full: bool = True, reclaim_ids: bool = False):
        """Merge delta segments off the hot path (store/compact.py)."""
        return self._require_live().compact(full=full,
                                            reclaim_ids=reclaim_ids)

    def snapshot(self, path):
        """Persist the compacted index; reload with ``repro_torch.restore``
        or ``repro_torch.recover``."""
        return self._require_live().snapshot(path)

    def index_shape(self) -> dict:
        """Observable index layout (also rendered by ``explain``); a static
        index is one segment at epoch 0."""
        idx = self.executor.index
        if hasattr(idx, "shape"):
            return idx.shape()
        return {"mode": "static", "epoch": 0, "segments": 1,
                "postings_per_segment": [idx.n_postings],
                "tables_per_segment": [idx.n_tables],
                "live_tables": idx.n_tables, "tombstoned": [],
                "table_slots": idx.n_tables, "row_stride": idx.row_stride,
                "postings": idx.n_postings}

    # ---------------------------------------------------------------- compile
    def compile(self, q, top: int | None = None) -> Compiled:
        """Expression / BlendQL string / legacy Plan -> Compiled.  Strings
        and expressions are memoized by content (compilation does not depend
        on the index, so with the query cache its plan level keeps them
        across epoch changes)."""
        plan_key = None
        if isinstance(q, (str, L.Expr)):
            plan_key = (q, top)
            got = self.cache.get_plan(plan_key) if self.cache is not None \
                else self._plan_memo.get(plan_key)
            if got is not None:
                return got
        if isinstance(q, str):
            q = parse(q)
        if isinstance(q, Plan):
            # legacy frontend: dead-subtree pruning is the only safe rewrite;
            # prune a copy so the caller-owned Plan is never mutated
            plan = q.copy()
            removed = prune_dead_nodes(plan)
            applied = ["prune_dead_nodes"] if removed else []
            return Compiled(plan=plan, logical=None, raw=None,
                            applied_rules=applied)
        if not isinstance(q, L.Expr):
            raise TypeError(f"cannot compile {type(q)!r}: expected a BlendQL "
                            f"expression, SQL string, or Plan")
        rewritten = rewrite(q, top=top)
        plan, node_of = lower(rewritten.expr)
        prune_dead_nodes(plan)
        compiled = Compiled(plan=plan, logical=rewritten.expr, raw=q,
                            applied_rules=list(rewritten.applied),
                            node_of=node_of)
        if self.cache is not None:
            self.cache.put_plan(plan_key, compiled)
        else:
            # FIFO-bounded: serving mixes are small
            if len(self._plan_memo) >= 512:
                self._plan_memo.pop(next(iter(self._plan_memo)))
            self._plan_memo[plan_key] = compiled
        return compiled

    # ---------------------------------------------------------------- execute
    def query(self, q, top: int | None = None, optimize: bool = True,
              sync: bool = True, fused: bool = False,
              approx=False) -> QueryResult:
        """Compile + execute; ``top`` overrides/sets the root result limit.
        ``fused=True`` executes on the fused path (core/fused.py): batched
        same-kind seeker dispatch + a single whole-DAG device program,
        ``ExecInfo.launches <= n_kinds + 1``, bit-identical results.

        With the query cache (``connect(lake, cache=True)``) the request is
        first validated against the ``(epoch, index fingerprint)`` key, then
        served from the exact-result cache when the canonical plan
        fingerprint matches (launching nothing); otherwise the executor runs
        with the subplan cache, which serves unrestricted seeker runs (a
        'partial' hit).  Results are bit-identical to a cold run.

        ``approx=True`` (or ``{"epsilon": .., "confidence": ..}`` / an
        ``ApproxParams``) answers from the sketch tier (core/sketch.py):
        per-table estimates with confidence intervals replace the exact
        probe, and only the contended boundary of the top-k ranking, the
        tables whose interval both reaches the k-th-place threshold and is
        wider than ``epsilon``, escalates to the exact path.  At
        ``epsilon=0`` the ids are those of the exact query.  The result's
        ``approx`` carries the estimates, intervals and escalation
        accounting."""
        compiled = q if isinstance(q, Compiled) else self.compile(q, top=top)
        params = sk.ApproxParams.of(approx)
        if params is not None:
            return self._query_approx(compiled, params, optimize=optimize,
                                      sync=sync, fused=fused)
        cache = self.cache
        t0 = time.perf_counter()
        if cache is None:
            rs, info = self.executor.run(compiled.plan, optimize=optimize,
                                         cost_model=self.cost_model,
                                         sync=sync, fused=fused)
            return QueryResult(result=rs, info=info, compiled=compiled,
                               seconds=time.perf_counter() - t0)
        cache.begin(self.executor.index, self._cache_config())
        rkey = cache.result_key(compiled.plan, optimize)
        entry = cache.get_result(rkey)
        if entry is not None:
            return self._hit_result(entry, compiled, sync,
                                    time.perf_counter() - t0)
        rs, info = self.executor.run(compiled.plan, optimize=optimize,
                                     cost_model=self.cost_model, sync=sync,
                                     cache=cache, fused=fused)
        return self._record_result(rkey, rs, info, compiled,
                                   time.perf_counter() - t0)

    def _hit_result(self, entry, compiled, sync, seconds) -> QueryResult:
        """Serve one exact-result cache hit (shared by query/query_many)."""
        cache = self.cache
        cache.note("hit")
        # a sync=False hit on an entry stored earlier in the same undrained
        # batch must not block the dispatch loop: its ids materialize later
        if sync and entry.ids is None:
            entry.ids = [int(t) for t in entry.result.ids()]
        return QueryResult(result=entry.result, info=entry.info,
                           compiled=compiled, seconds=seconds,
                           _ids=entry.ids, cache=cache.request_info("hit"),
                           _entry=entry)

    def _record_result(self, rkey, rs, info, compiled,
                       seconds) -> QueryResult:
        """Store one executed result into the cache and wrap it (shared by
        query/query_many)."""
        cache = self.cache
        from repro_torch.serve.cache import CachedResult   # serve/ is above
        entry = CachedResult(result=rs, info=info,
                             plan_nodes=len(compiled.plan.nodes))
        cache.put_result(rkey, entry, n_tables=self.executor.n_tables)
        status = "partial" if info.cached_nodes else "miss"
        cache.note(status)
        cinfo = cache.request_info(status,
                                   seekers_cached=len(info.cached_nodes),
                                   seekers_run=info.seeker_runs)
        # the ids this result materializes are written back into the entry
        # too, so a later hit on it reads nothing from the device
        return QueryResult(result=rs, info=info, compiled=compiled,
                           seconds=seconds, cache=cinfo, _entry=entry)

    # ----------------------------------------------------------------- approx
    def _query_approx(self, compiled, params, *, optimize, sync,
                      fused) -> QueryResult:
        """Sketch-tier execution (``query(approx=...)``).

        A single-seeker SC / KW / C plan answers from the per-table sketch
        estimates (``Executor.sketch_probe``, host NumPy), ranked by one
        top-k on the executor's device (shard 0's, the merge device, on a
        sharded lake).  When the escalation set (core/sketch.py) is not
        empty the exact plan runs, through the normal cached path, and its
        ResultSet is returned whole, which makes ``epsilon=0`` give the
        exact ids.  Multi-node plans and MC have no sketch estimator and
        run exact with ``approx.fallback`` set.  Approximate results are
        cached under their own key (plan fingerprint, epsilon and
        confidence), never served for exact requests or the other way
        round."""
        t0 = time.perf_counter()
        plan = compiled.plan
        out_node = plan.nodes[plan.output]
        cache = self.cache
        rkey = None
        if cache is not None:
            cache.begin(self.executor.index, self._cache_config())
            rkey = cache.result_key(plan, optimize, approx=params.key())
            entry = cache.get_result(rkey)
            if entry is not None:
                res = self._hit_result(entry, compiled, sync,
                                       time.perf_counter() - t0)
                res.approx = entry.approx
                return res
        reg = obs.registry() if obs.enabled() else None
        if reg is not None:
            reg.counter("approx.queries").inc()
        fallback = None
        if not (len(plan.nodes) == 1 and out_node.is_seeker):
            fallback = "multi-node-plan"
        elif out_node.spec.kind == "MC":
            fallback = "mc-no-estimator"
        if fallback is not None:
            if reg is not None:
                reg.counter("approx.fallbacks").inc()
            ainfo = sk.ApproxInfo(
                params=params,
                kind=out_node.spec.kind if out_node.is_seeker else "plan",
                estimator="exact-fallback", escalated=0, candidates=0,
                threshold=0.0, fallback=fallback)
            return self._exact_for_approx(compiled, ainfo, rkey,
                                          optimize, sync, fused, t0)
        spec = out_node.spec
        with otrace.current().span("approx.query", kind=spec.kind):
            probe = self.executor.sketch_probe(spec, params.confidence)
            esc, candidates, thresh = sk.escalation_set(probe, spec.k, params)
        ainfo = sk.ApproxInfo(
            params=params, kind=spec.kind, estimator=probe.estimator,
            escalated=len(esc), candidates=candidates, threshold=thresh,
            est=probe.est, ci_lo=probe.ci_lo, ci_hi=probe.ci_hi,
            escalated_ids=[int(t) for t in esc],
            probe_seconds=probe.seconds)
        if reg is not None:
            reg.counter("approx.candidates").inc(candidates)
            reg.counter("approx.escalated_tables").inc(len(esc))
        if len(esc):
            if reg is not None:
                reg.counter("approx.escalations").inc()
            return self._exact_for_approx(compiled, ainfo, rkey,
                                          optimize, sync, fused, t0)
        est = torch.as_tensor(probe.est, dtype=torch.float32).to(
            self.executor.device)
        rs = comb.topk_result(est, spec.k)
        if sync:
            self.executor.synchronize()
        # the probe is host-side (0 launches); the top-k select is 1 program
        info = ExecInfo(optimized=optimize, launches=probe.launches + 1)
        info.node_seconds[plan.output] = probe.seconds
        info.order.append(plan.output)
        seconds = time.perf_counter() - t0
        if cache is None:
            return QueryResult(result=rs, info=info, compiled=compiled,
                               seconds=seconds, approx=ainfo)
        from repro_torch.serve.cache import CachedResult   # serve/ is above
        entry = CachedResult(result=rs, info=info, plan_nodes=len(plan.nodes),
                             approx=ainfo)
        cache.put_result(rkey, entry, n_tables=self.executor.n_tables)
        cache.note("miss")
        return QueryResult(result=rs, info=info, compiled=compiled,
                           seconds=seconds, cache=cache.request_info("miss"),
                           _entry=entry, approx=ainfo)

    def _exact_for_approx(self, compiled, ainfo, rkey, optimize, sync,
                          fused, t0) -> QueryResult:
        """Resolve an approximate request on the exact path (escalation or
        fallback): the exact run goes through ``query``, so it lands in,
        and can be served from, the exact-result cache; the same ResultSet
        is also recorded under the approximate key with its ApproxInfo, so
        a repeated approximate request hits directly."""
        eres = self.query(compiled, optimize=optimize, sync=sync, fused=fused)
        if self.cache is not None and rkey is not None:
            from repro_torch.serve.cache import CachedResult
            self.cache.put_result(
                rkey, CachedResult(result=eres.result, info=eres.info,
                                   plan_nodes=len(compiled.plan.nodes),
                                   ids=eres._ids, approx=ainfo),
                n_tables=self.executor.n_tables)
        return QueryResult(result=eres.result, info=eres.info,
                           compiled=compiled,
                           seconds=time.perf_counter() - t0, _ids=eres._ids,
                           cache=eres.cache, _entry=eres._entry,
                           approx=ainfo)

    def sql(self, text: str, optimize: bool = True,
            sync: bool = True) -> QueryResult:
        """Execute one BlendQL statement."""
        return self.query(text, optimize=optimize, sync=sync)

    def query_many(self, queries, top: int | None = None,
                   optimize: bool = True, sync: bool = True,
                   fused: bool = True) -> list:
        """Execute a batch of queries; with ``fused=True`` (the default)
        same-kind seekers are batched *across all requests* into shared
        device launches (``Executor.run_many``), so a heterogeneous batch
        executes in about one launch per seeker kind plus one DAG program
        per request; ``fused=False`` runs ``query`` on each in turn.
        Query-cache semantics match ``query``: exact-result hits
        short-circuit before the executor, subplan hits drop their seekers
        out of the fused batch, and every result is bit-identical to a
        sequential cold run.

        Each result's ``seconds`` is its own compile (and cache lookup)
        time plus an equal share of the batch's execution (exact hits pay
        no share)."""
        cache = self.cache
        if cache is not None:
            cache.begin(self.executor.index, self._cache_config())
        results: list = [None] * len(queries)
        pending: list = []           # (index, Compiled, result key, seconds)
        for i, q in enumerate(queries):
            t0 = time.perf_counter()
            comp = q if isinstance(q, Compiled) else self.compile(q, top=top)
            if cache is None:
                pending.append((i, comp, None, time.perf_counter() - t0))
                continue
            rkey = cache.result_key(comp.plan, optimize)
            entry = cache.get_result(rkey)
            if entry is not None:
                results[i] = self._hit_result(entry, comp, sync,
                                              time.perf_counter() - t0)
            else:
                pending.append((i, comp, rkey, time.perf_counter() - t0))
        if not pending:
            return results
        if not fused:
            for i, comp, _, _ in pending:
                results[i] = self.query(comp, optimize=optimize, sync=sync)
            return results
        t0 = time.perf_counter()
        outs = self.executor.run_many([c.plan for _, c, _, _ in pending],
                                      optimize=optimize,
                                      cost_model=self.cost_model, sync=sync,
                                      cache=cache)
        share = (time.perf_counter() - t0) / len(pending)
        for (i, comp, rkey, own_s), (rs, info) in zip(pending, outs):
            if cache is not None:
                results[i] = self._record_result(rkey, rs, info, comp,
                                                 own_s + share)
            else:
                results[i] = QueryResult(result=rs, info=info, compiled=comp,
                                         seconds=own_s + share)
        return results

    # ---------------------------------------------------------------- explain
    def explain(self, q, top: int | None = None, optimize: bool = True,
                execute: bool = True, fused: bool = False,
                server: dict | None = None) -> Explain:
        """Compile (and by default run) ``q``; returns the transcript:
        rendered logical tree, applied rewrite rules, the index's shape,
        ranked physical order, and per-node timings from the actual
        execution.  ``fused=True`` executes on the fused path: the
        ``launches`` line then shows the collapsed dispatch count (<=
        n_kinds + 1).  ``server=`` attaches front-tier telemetry
        (``DiscoveryServer.stats()``), rendered as the ``== server ==``
        section: queue depth, lane occupancy, shed counts, launches per
        batch.  With ``repro_torch.obs`` enabled the transcript also
        carries the metrics snapshot (``== metrics ==``)."""
        compiled = q if isinstance(q, Compiled) else self.compile(q, top=top)
        if compiled.logical is not None:
            tree = compiled.logical.render()
        else:
            tree = "\n".join(
                f"{name}: {node.spec}" for name, node in
                compiled.plan.nodes.items())
        ranked = {}
        if optimize:
            ep = optimize_plan(compiled.plan, self.executor.seeker_stats,
                               self.cost_model)
            ranked = {name: list(eg.seekers) for name, eg in ep.groups.items()}
        info = ExecInfo(optimized=optimize)
        ids: list = []
        cache_info: dict = {}
        if execute:
            res = self.query(compiled, optimize=optimize, fused=fused)
            info, ids = res.info, res.ids
            if res.cache is not None:
                cache_info = res.cache.as_dict()
        return Explain(logical_tree=tree,
                       applied_rules=list(compiled.applied_rules),
                       physical_order=ranked, exec_order=list(info.order),
                       node_seconds=dict(info.node_seconds),
                       overflow=info.overflow if execute else 0, ids=ids,
                       launches=info.launches,
                       index_shape=self.index_shape(), cache=cache_info,
                       server=dict(server) if server else {},
                       metrics=obs.registry().snapshot()
                       if obs.enabled() else {})


def _make_cache(cache):
    """``cache=`` argument -> QueryCache | None: False/None disables, True
    uses the default byte budget, an int is the budget, a QueryCache
    instance is used as-is (imported here: serve/ sits above query/)."""
    if not cache:
        return None
    from repro_torch.serve.cache import QueryCache
    if isinstance(cache, QueryCache):
        return cache
    if cache is True:
        return QueryCache()
    return QueryCache(max_bytes=int(cache))


def connect(lake, cost_model: CostModel | None = None, live: bool = False,
            cache=False, shards: int | None = None, wal=None,
            **executor_opts) -> Session:
    """Open a discovery session on a lake: builds the unified index and the
    executor (kwargs forwarded: ``backend=``, ``device=``, ``m_cap_max=``,
    ...), returning the Session handle that serves queries.  ``device=None``
    means CUDA and raises when no card is present.

    With ``live=True`` the index is built as a LiveLake segment store
    (store/): the session gains the mutation API and queries keep serving,
    bit-identically to a from-scratch rebuild, while the lake evolves.
    ``lake`` may also be an existing ``LiveLake``.  ``wal=`` (a path or
    ``store.wal.WriteAheadLog``; requires ``live=True``) durably logs every
    acknowledged mutation; reopen with :func:`recover`.

    ``cache=True`` (or a byte budget / QueryCache instance) enables the
    semantic query cache (serve/cache.py): repeated or subtree-sharing
    queries are served from compiled-plan, exact-result and per-seeker
    caches, all invalidated by the store epoch so mutations never serve
    stale ids.

    ``shards=N`` partitions the store along the table axis (dist/shard.py),
    shard i on ``cuda:(i % device_count)`` (every shard on the CPU with
    ``device="cpu"``): queries execute as fused per-shard probes plus one
    cross-shard merge, bit-identical to an unsharded session; combine with
    ``live=True`` for shard-local mutations (``add_table`` routes to the
    least-loaded shard)."""
    qc = _make_cache(cache)
    if wal is not None and not live:
        raise ValueError("wal= requires live=True (the WAL logs mutations)")
    # resolve the device before the (long) index build, so a missing card
    # fails fast
    executor_opts["device"] = resolve_device(executor_opts.get("device"))
    if shards:
        if isinstance(lake, LiveLake):
            raise TypeError("pass the raw lake (not a LiveLake) with "
                            "shards=: the store must be built sharded")
        store = ShardedStore(lake, n_shards=shards)
        executor = ShardedExecutor(store, **executor_opts)
        ll = LiveLake(lake, store=store, wal=wal) if live else None
        return Session(executor, lake=lake, cost_model=cost_model,
                       live=ll, cache=qc)
    if live:
        if isinstance(lake, LiveLake):
            ll = lake
            if wal is not None:
                raise ValueError("pass wal= when the LiveLake is built, "
                                 "not when wrapping an existing one")
        else:
            ll = LiveLake(lake, wal=wal)
        return Session(Executor(ll.store, **executor_opts),
                       lake=None if lake is ll else lake,
                       cost_model=cost_model, live=ll, cache=qc)
    executor = Executor(build_index(lake), **executor_opts)
    return Session(executor, lake=lake, cost_model=cost_model, cache=qc)


def restore(path, cost_model: CostModel | None = None, cache=False,
            **executor_opts) -> Session:
    """Open a live session from a snapshot (store/snapshot.py): no
    re-indexing, the server restart path.  As in the JAX package, the
    executor is a plain ``Executor`` even over a sharded snapshot: one
    engine over every shard's segments."""
    executor_opts["device"] = resolve_device(executor_opts.get("device"))
    ll = LiveLake.restore(path)
    return Session(Executor(ll.store, **executor_opts),
                   cost_model=cost_model, live=ll, cache=_make_cache(cache))


def recover(path=None, *, wal=None, shards: int | None = None,
            cost_model: CostModel | None = None, cache=False,
            policy=None, **executor_opts) -> Session:
    """Open a live session from durable state: the latest good snapshot
    generation at ``path`` (if any; corrupt generations fall back, see
    store/snapshot.py) plus a replay of every WAL record past the
    snapshot's watermark (store/wal.py): the crash-recovery path.  The
    recovered session answers queries with ids, scores and epoch
    bit-identical to the uninterrupted run, and keeps logging to ``wal``.
    ``shards=N`` only matters on a cold start with no snapshot (a
    recovered snapshot already knows its shard layout)."""
    executor_opts["device"] = resolve_device(executor_opts.get("device"))
    ll = LiveLake.recover(path, wal=wal, shards=shards, policy=policy)
    cls = ShardedExecutor if hasattr(ll.store, "shards") else Executor
    return Session(cls(ll.store, **executor_opts), cost_model=cost_model,
                   live=ll, cache=_make_cache(cache))
