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
(core/fused.py).  This slice serves a static index with the query cache
off; live lakes, the cache, sharding, the WAL, the approximate tier, the
serving front tier and snapshot restore/recovery raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch import obs
from repro_torch.core.cost_model import CostModel
from repro_torch.core.executor import ExecInfo, Executor
from repro_torch.core.index import build_index, resolve_device
from repro_torch.core.optimizer import optimize as optimize_plan
from repro_torch.core.plan import Plan
from repro_torch.query import logical as L
from repro_torch.query.lower import lower
from repro_torch.query.parse import parse
from repro_torch.query.rules import prune_dead_nodes, rewrite

_LATER = {
    "live": "LiveLake on torch (ROADMAP queue A, item A4)",
    "cache": "the query cache (ROADMAP queue A, item A5)",
    "shards": "sharding (ROADMAP queue A, item A6)",
    "wal": "LiveLake on torch with its WAL (ROADMAP queue A, item A4)",
    "approx": "the approximate tier (ROADMAP queue A, item A7)",
    "restore": "LiveLake snapshots (ROADMAP queue A, item A4)",
    "recover": "LiveLake crash recovery (ROADMAP queue A, item A4)",
    "server": "the serving front tier (ROADMAP queue A, item A5)",
}


def _not_ported(option: str):
    raise NotImplementedError(f"{option} is not ported to repro_torch yet: "
                              f"it comes with {_LATER[option]}")


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

    @property
    def scores(self):
        """Dense f32 [n_tables] score tensor on the executor's device."""
        return self.result.scores

    @property
    def ids(self) -> list:
        """Ranked table ids, score-descending (materialized lazily)."""
        if self._ids is None:
            self._ids = [int(t) for t in self.result.ids()]
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
    metrics: dict = field(default_factory=dict)       # obs registry snapshot

    def __str__(self):
        lines = ["== logical plan =="]
        lines += [self.logical_tree]
        lines.append("== rewrite rules applied ==")
        lines += [f"  - {r}" for r in self.applied_rules] or ["  (none)"]
        if self.index_shape:
            s = self.index_shape
            lines.append("== index ==")
            lines.append(f"  mode: {s['mode']}   epoch: {s['epoch']}   "
                         f"segments: {s['segments']}")
            lines.append(f"  postings/segment: {s['postings_per_segment']}")
            lines.append(f"  live tables: {s['live_tables']}"
                         + (f"   tombstoned: {s['tombstoned']}"
                            if s["tombstoned"] else ""))
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
    the BlendQL compile pipeline (with a bounded compiled-plan memo)."""

    def __init__(self, executor: Executor,
                 cost_model: CostModel | None = None):
        self.executor = executor
        self.cost_model = cost_model
        self._plan_memo = {}

    @property
    def index(self):
        return self.executor.index

    def index_shape(self) -> dict:
        """Observable index layout (also rendered by ``explain``); a static
        index is one segment at epoch 0."""
        idx = self.executor.index
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
        on the index)."""
        plan_key = None
        if isinstance(q, (str, L.Expr)):
            plan_key = (q, top)
            got = self._plan_memo.get(plan_key)
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
        ``ExecInfo.launches <= n_kinds + 1``, bit-identical results."""
        if approx:
            _not_ported("approx")
        compiled = q if isinstance(q, Compiled) else self.compile(q, top=top)
        t0 = time.perf_counter()
        rs, info = self.executor.run(compiled.plan, optimize=optimize,
                                     cost_model=self.cost_model, sync=sync,
                                     fused=fused)
        return QueryResult(result=rs, info=info, compiled=compiled,
                           seconds=time.perf_counter() - t0)

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
        per request; ``fused=False`` runs ``query`` on each in turn.  Every
        result is bit-identical to a sequential run.

        Each result's ``seconds`` is its own compile time plus an equal
        share of the batch's execution."""
        pending = []
        for q in queries:
            t0 = time.perf_counter()
            comp = q if isinstance(q, Compiled) else self.compile(q, top=top)
            pending.append((comp, time.perf_counter() - t0))
        if not pending:
            return []
        if not fused:
            return [self.query(comp, optimize=optimize, sync=sync)
                    for comp, _ in pending]
        t0 = time.perf_counter()
        outs = self.executor.run_many([c.plan for c, _ in pending],
                                      optimize=optimize,
                                      cost_model=self.cost_model, sync=sync)
        share = (time.perf_counter() - t0) / len(pending)
        return [QueryResult(result=rs, info=info, compiled=comp,
                            seconds=own_s + share)
                for (comp, own_s), (rs, info) in zip(pending, outs)]

    # ---------------------------------------------------------------- explain
    def explain(self, q, top: int | None = None, optimize: bool = True,
                execute: bool = True, fused: bool = False,
                server: dict | None = None) -> Explain:
        """Compile (and by default run) ``q``; returns the transcript:
        rendered logical tree, applied rewrite rules, the index's shape,
        ranked physical order, and per-node timings from the actual
        execution.  ``fused=True`` executes on the fused path: the
        ``launches`` line then shows the collapsed dispatch count (<=
        n_kinds + 1).  With ``repro_torch.obs`` enabled the transcript also
        carries the metrics snapshot (``== metrics ==``)."""
        if server:
            _not_ported("server")
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
        if execute:
            res = self.query(compiled, optimize=optimize, fused=fused)
            info, ids = res.info, res.ids
        return Explain(logical_tree=tree,
                       applied_rules=list(compiled.applied_rules),
                       physical_order=ranked, exec_order=list(info.order),
                       node_seconds=dict(info.node_seconds),
                       overflow=info.overflow if execute else 0, ids=ids,
                       launches=info.launches,
                       index_shape=self.index_shape(),
                       metrics=obs.registry().snapshot()
                       if obs.enabled() else {})


def connect(lake, cost_model: CostModel | None = None, live: bool = False,
            cache=False, shards: int | None = None, wal=None,
            **executor_opts) -> Session:
    """Open a discovery session on a lake: builds the unified index and the
    executor (kwargs forwarded: ``backend=``, ``device=``, ``m_cap_max=``,
    ...), returning the Session handle that serves queries.  ``device=None``
    means CUDA and raises when no card is present."""
    for option, value in (("live", live), ("cache", cache),
                          ("shards", shards), ("wal", wal)):
        if value:
            _not_ported(option)
    # resolve the device before the (long) index build, so a missing card
    # fails fast
    executor_opts["device"] = resolve_device(executor_opts.get("device"))
    executor = Executor(build_index(lake), **executor_opts)
    return Session(executor, cost_model=cost_model)


def restore(path, **kwargs) -> Session:
    _not_ported("restore")


def recover(path=None, **kwargs) -> Session:
    _not_ported("recover")
