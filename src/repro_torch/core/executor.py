"""Plan executor: optimized (EG ordering + mask threading) and naive (B-NO).

The executor owns a ``MatchEngine`` (device index + probe backends) on one
device, hashes query values through a cross-query memo cache, and runs the
plan DAG.  Over a LiveLake ``SegmentStore`` it refreshes the engine when
the store's epoch moved, at the entry of each plan (one epoch per plan),
into its own device arena (core/arena.py).  ``optimize=False`` reproduces
the paper's B-NO configuration: same seekers and combiners, insertion
seeker order, no intermediate-result threading.

Match capacities are quantized to a small fixed ladder and query counts are
padded to powers of two, exactly as in the JAX package, so both systems see
the same windows and overflow counts.  ``sync=False`` skips the
data-dependent compaction stages (their capacity picks are host syncs).
``fused=True`` and ``run_many`` run plans on the fused path (core/fused.py):
one device program per seeker group and one per plan's combiner DAG.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import combiners as comb
from repro_torch.core import seekers as seek
from repro_torch.core.arena import Arena
from repro_torch.core.cost_model import CostModel
from repro_torch.core.hashing import MISSING, hash_value, row_superkey, \
    split_u64
from repro_torch.core.index import UnifiedIndex, hash_keys, resolve_device
from repro_torch.core.match import MatchEngine
from repro_torch.core.optimizer import optimize as optimize_plan
from repro_torch.core.plan import Plan, SeekerSpec
from repro_torch.core.programs import Programs

# the match-capacity ladder: every seeker launch uses one of these
# capacities, so a coarse ladder keeps the window shape stable across draws
# from the same workload
CAP_LADDER = (32, 128, 512, 1024)
PAD_SENTINEL = MISSING                    # reserved: never a real cell hash
# a live executor keeps the device programs of this many engine configs of
# its arena generation, the most recently built; each program holds its
# static inputs and outputs (core/programs.py), so a stream of new
# geometries must not keep all
RECENT_CONFIGS = 8


@dataclass
class OverflowSlice:
    """A lazy view into a fused group's stacked overflow vector: ``rows``
    are this plan's seekers' rows in ``vec``, read when
    ``ExecInfo.overflow`` is, not at dispatch."""
    vec: torch.Tensor             # int64 [n_seekers_p] on the device
    rows: list                    # this plan's row indices into vec


@dataclass
class ExecInfo:
    optimized: bool
    node_seconds: dict = field(default_factory=dict)
    order: list = field(default_factory=list)
    overflow_parts: list = field(default_factory=list)
    # query-cache accounting (serve/cache.py): seeker nodes served from the
    # subplan cache vs actually dispatched; ``serve_many`` excludes exact
    # result-cache hits from its drain, a partial request keeps its share
    cached_nodes: list = field(default_factory=list)
    seeker_runs: int = 0
    # device-program dispatch count: on the unfused path every seeker call
    # (compaction stages included) and every combiner node counts one; the
    # fused path counts its group launches + the single DAG program
    launches: int = 0
    #: memoized ``overflow`` total (None until first read / batch fetch)
    _overflow: int | None = None

    @property
    def total_seconds(self) -> float:
        return sum(self.node_seconds.values())

    @property
    def overflow(self) -> int:
        """Matches beyond capacity, all parts fetched in ONE device-to-host
        copy on first read."""
        if self._overflow is None:
            ExecInfo.materialize_overflow([self])
        return self._overflow

    @staticmethod
    def materialize_overflow(infos):
        """Resolve many infos' overflow totals in ONE device-to-host copy,
        deduping shared vectors (a fused group's overflow vector is shared
        by every plan of a ``run_many`` batch)."""
        vecs = ExecInfo.overflow_vectors(infos)
        host: dict = {}
        if vecs:
            flat = torch.cat(list(vecs.values())).cpu().numpy()
            off = 0
            for k, v in vecs.items():
                host[k] = flat[off:off + v.numel()]
                off += v.numel()
        ExecInfo.resolve_overflow(infos, host)

    @staticmethod
    def overflow_vectors(infos) -> dict:
        """{id of a part's vector: that vector as flat int64} over the
        parts of the infos not yet resolved, each shared vector once."""
        vecs: dict = {}
        for i in infos:
            if i._overflow is None:
                for p in i.overflow_parts:
                    v = p.vec if isinstance(p, OverflowSlice) else p
                    if id(v) not in vecs:
                        vecs[id(v)] = v.reshape(-1).to(torch.int64)
        return vecs

    @staticmethod
    def resolve_overflow(infos, host: dict):
        """Set each unresolved info's total from ``host``, {id as in
        ``overflow_vectors``: that vector on the host}."""
        for i in infos:
            if i._overflow is None:
                total = 0
                for p in i.overflow_parts:
                    if isinstance(p, OverflowSlice):
                        total += int(host[id(p.vec)][p.rows].sum())
                    else:
                        total += int(host[id(p)].sum())
                i._overflow = total


def _pow2_at_least(n: int, lo: int = 8, hi: int = 1024) -> int:
    m = lo
    while m < min(n, hi):
        m *= 2
    return m


class Executor:
    """Runs plans over a ``UnifiedIndex`` or a LiveLake ``SegmentStore`` on
    ``device`` (``None`` means CUDA and raises when no card is present;
    pass ``device="cpu"`` for the plain PyTorch path).

    A store carries an ``epoch`` counter that every mutation bumps; the
    executor compares it lazily at query entry and rebuilds its MatchEngine
    when stale, so a Session over a live lake always observes a consistent
    epoch without any mutation hook into the executor.  (The value-hash
    memo survives refreshes: it is a pure function of cell values.)"""

    def __init__(self, index: UnifiedIndex, m_cap_max: int = 1024,
                 row_cap: int = 8, backend: str = "sorted",
                 bucket_width: int | None = None, device=None):
        self.device = resolve_device(device)
        self.index = index
        self.backend = backend
        self.bucket_width = bucket_width
        self.programs = Programs(self.device)     # the fused path's programs
        self.arena = Arena(self.device)           # a live engine's storage
        self._engine_epoch = None
        self._recent: list = []                   # (generation, config)
        self._in_plan = False
        self._build_engine()
        self.m_cap_max = m_cap_max
        self.row_cap = row_cap
        rungs = {min(c, m_cap_max) for c in CAP_LADDER}
        if m_cap_max > max(CAP_LADDER):
            rungs.add(m_cap_max)        # honor caps above the default ladder
        self.cap_ladder = tuple(sorted(rungs))
        self._hash_cache: dict = {}
        self._hash_cache_max = 1 << 20

    # ---------------------------------------------------------- live engine
    def _build_engine(self):
        idx = self.index
        if hasattr(idx, "segments"):       # LiveLake SegmentStore
            if self.bucket_width is not None:
                raise ValueError(
                    "bucket_width is not configurable on a live store: "
                    "each segment sizes its own lossless bucket layout")
            self.engine = MatchEngine.from_store(idx, self.arena,
                                                 backend=self.backend)
            self._engine_epoch = idx.epoch
            self._keep_recent_programs()
        else:
            self.engine = MatchEngine.from_index(
                idx, backend=self.backend, bucket_width=self.bucket_width,
                device=self.device)
        self.n_tables = idx.n_tables
        self.max_cols = idx.max_cols

    def _keep_recent_programs(self):
        """Drop the programs that read the engine, except those of the
        current arena generation built for one of its last
        ``RECENT_CONFIGS`` configs.  A program of an older generation reads
        freed buffers, so a new generation drops every program with the
        graph memory pool they share; an older config's programs hold
        their static inputs and outputs, which an endless stream of
        geometries would otherwise pile up."""
        now = (self.arena.generation, self.engine.config)
        if self._recent and self._recent[-1][0] != now[0]:
            self.programs.clear()
            self._recent = []
        recent = [c for c in self._recent if c != now]
        self._recent = recent[-(RECENT_CONFIGS - 1):] + [now]
        keep = set(self._recent)
        self.programs.drop_where(
            lambda key: key[0] == "engine" and key[1:3] not in keep)

    def refresh(self):
        """Pick up index mutations: rebuild the engine iff the store epoch
        moved (no-op for a static UnifiedIndex and for unchanged epochs)."""
        ep = getattr(self.index, "epoch", None)
        if ep is not None and ep != self._engine_epoch:
            self._build_engine()

    def program_key(self, *parts) -> tuple:
        """Key of a device program that reads the engine: ``parts`` plus
        the engine's static config and the arena generation it views."""
        return ("engine", self.arena.generation, self.engine.config) + parts

    # ------------------------------------------------------------------ util
    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def synchronize(self):
        """Wait for the executor's queued work (nothing to wait for on the
        CPU): the caller's current stream on the device, where all of it
        runs.  Not a device-wide synchronize, which CUDA refuses
        while another thread captures a graph (serve/server.py)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _hash_many(self, values) -> np.ndarray:
        """Memoized value hashing (shared across queries / plans), bounded:
        past the limit the oldest half is evicted."""
        vals = list(values)
        out = np.empty(len(vals), np.uint32)
        cache = self._hash_cache
        if len(cache) > self._hash_cache_max:
            for k in list(cache)[:len(cache) // 2]:
                del cache[k]
        for i, v in enumerate(vals):
            h = cache.get(v)
            if h is None:
                h = hash_value(v)
                cache[v] = h
            out[i] = h
        return out

    def _hashed(self, values) -> np.ndarray:
        """Hash + dedupe (SQL IN (...) set semantics)."""
        return np.unique(self._hash_many(values))

    def _pad_queries(self, h: np.ndarray, lo: int = 16):
        """Pad a hashed query array to the power-of-two shape ladder; returns
        (int32 device keys, bool mask)."""
        n = len(h)
        width = _pow2_at_least(max(n, 1), lo=lo, hi=1 << 30)
        hp = np.full(width, PAD_SENTINEL, np.uint32)
        hp[:n] = h
        mask = np.zeros(width, bool)
        mask[:n] = True
        return self._put(hash_keys(hp)), self._put(mask)

    def _stat_counts(self, h: np.ndarray) -> np.ndarray:
        """Planner-statistics counts: on a live store, tombstoned postings
        are excluded (they contribute no results, only probe-window slots),
        so seeker ranking reflects the live lake."""
        if hasattr(self.index, "segments"):
            return self.index.host_counts(h, live_only=True)
        return self.index.host_counts(h)

    def seeker_stats(self, spec: SeekerSpec):
        """(cardinality, n_cols, avg value frequency) — the cost features."""
        if spec.kind == "MC":
            freqs = []
            for c in range(spec.n_cols):
                h = self._hashed([t[c] for t in spec.values])
                freqs.append(self._stat_counts(h).mean())
            avg = float(np.prod(freqs))
            return (float(len(spec.values)), float(spec.n_cols), avg)
        h = self._hashed(spec.values)
        avg = float(self._stat_counts(h).mean()) if len(h) else 0.0
        return (float(len(spec.values)), float(spec.n_cols), avg)

    def _quantize_cap(self, need: int) -> int:
        for c in self.cap_ladder:
            if need <= c:
                return c
        return self.cap_ladder[-1]

    def _mcap_for(self, hashes: np.ndarray) -> int:
        counts = self.index.host_counts(hashes)
        return self._quantize_cap(int(counts.max(initial=1)))

    # --------------------------------------------------------------- seekers
    def run_seeker(self, spec: SeekerSpec, allowed=None,
                   sync: bool = True) -> comb.ResultSet:
        if not self._in_plan:   # a running plan already pinned its epoch
            self.refresh()
        self._last_launches = 1
        if spec.kind in ("SC", "KW"):
            h = self._hashed(spec.values)
            m_cap = self._mcap_for(h)
            qh, qm = self._pad_queries(h)
            fn = seek.sc_seeker if spec.kind == "SC" else seek.kw_seeker
            kw = dict(m_cap=m_cap, n_tables=self.n_tables)
            if spec.kind == "SC":
                kw["max_cols"] = self.max_cols
            scores, ovf = fn(self.engine, qh, qm, allowed=allowed, **kw)
        elif spec.kind == "MC":
            values = list(dict.fromkeys(spec.values))   # dedupe tuples
            nt = len(values)
            n_cols = spec.n_cols
            th = np.stack([self._hash_many([t[c] for t in values])
                           for c in range(n_cols)], axis=1)       # [nt, n_cols]
            counts = np.stack([self.index.host_counts(th[:, c])
                               for c in range(n_cols)], axis=1)
            init_col = np.argmin(counts, axis=1).astype(np.int64)
            qks = np.array([row_superkey(th[i], np.zeros(n_cols, np.int64))
                            for i in range(nt)], np.uint64)
            qk_lo, qk_hi = split_u64(qks)
            m_cap = self._quantize_cap(int(counts.max(initial=1)))
            # pad the tuple batch onto the shape ladder
            ntp = _pow2_at_least(max(nt, 1), lo=8, hi=1 << 30)
            pad = ntp - nt
            th = np.pad(th, ((0, pad), (0, 0)))
            init_col = np.pad(init_col, (0, pad))
            qk_lo, qk_hi = np.pad(qk_lo, (0, pad)), np.pad(qk_hi, (0, pad))
            tmask = np.zeros(ntp, bool)
            tmask[:nt] = True
            args = (self.engine, self._put(hash_keys(th)),
                    self._put(init_col), self._put(qk_lo.view(np.int32)),
                    self._put(qk_hi.view(np.int32)))
            tmask = self._put(tmask)
            if sync:
                # stage 1: survivor counts after predicate + bloom -> the
                # stage-2 validation runs with compacted candidate buffers
                self._last_launches = 2
                surv = seek.mc_survivor_counts(*args, m_cap=m_cap,
                                               allowed=allowed,
                                               tuple_mask=tmask)
                m_cap2 = self._quantize_cap(int(surv.max().item()))
                scores, _rows, ovf = seek.mc_seeker_compact(
                    *args, m_cap=m_cap, m_cap2=min(m_cap2, m_cap),
                    n_tables=self.n_tables, n_cols=n_cols,
                    row_stride=self.index.row_stride, allowed=allowed,
                    tuple_mask=tmask)
            else:
                # skip the data-dependent compaction stage (its capacity
                # pick is a host sync); validate at full m_cap
                scores, _rows, ovf = seek.mc_seeker(
                    *args, m_cap=m_cap, n_tables=self.n_tables,
                    n_cols=n_cols, row_stride=self.index.row_stride,
                    allowed=allowed, tuple_mask=tmask)
        elif spec.kind == "C":
            pairs = list(dict.fromkeys(zip(spec.values, spec.target)))
            h = self._hash_many([p[0] for p in pairs])
            tgt = np.array([float(p[1]) for p in pairs])
            qbit = (tgt >= tgt.mean()).astype(np.int8)            # k0/k1 split
            m_cap = self._mcap_for(h)
            qh, qm = self._pad_queries(h)
            qbit = self._put(np.pad(qbit, (0, qh.shape[0] - len(qbit))))
            kw = dict(m_cap=m_cap, row_cap=self.row_cap,
                      n_tables=self.n_tables, max_cols=self.max_cols,
                      h_sample=spec.h, sampling=spec.sampling,
                      row_stride=self.index.row_stride, allowed=allowed)
            if allowed is not None and sync:
                # two-stage: compact the join side to the surviving postings
                self._last_launches = 2
                surv = int(seek.c_survivor_counts(self.engine, qh, qm,
                                                  m_cap=m_cap,
                                                  allowed=allowed).item())
                cap2 = _pow2_at_least(max(surv, 1),
                                      hi=int(qh.shape[0]) * m_cap)
                scores, ovf = seek.c_seeker_compact(self.engine, qh, qm, qbit,
                                                    cap2=cap2, **kw)
            else:
                scores, ovf = seek.c_seeker(self.engine, qh, qm, qbit, **kw)
        else:
            raise ValueError(spec.kind)
        if sync:
            self.synchronize()
        self._last_overflow = ovf
        return comb.topk_result(scores, spec.k)

    # ------------------------------------------------------------------ plan
    def run(self, plan: Plan, optimize: bool = True,
            cost_model: CostModel | None = None, sync: bool = True,
            cache=None, fused: bool = False):
        """Execute ``plan``: unfused, one dispatch per node; with
        ``fused=True`` through core/fused.py, all same-kind seekers as one
        batched device program and the combiner DAG as one more, so the
        plan runs in ``~n_kinds + 1`` launches (``ExecInfo.launches``),
        bit-identical to the unfused walk.  ``cache`` is an optional query
        cache (duck-typed ``seeker_key`` / ``get_seeker`` / ``put_seeker``,
        serve/cache.py): unrestricted seeker runs are served from and
        stored into its subplan level; a seeker that would run under a
        threaded optimizer mask still runs, so a partially cached plan is
        bit-identical to a cold run."""
        self.refresh()          # one consistent epoch for the whole plan
        self._in_plan = True    # nested run_seeker calls must not re-refresh
        try:
            if fused:
                from repro_torch.core.fused import run_fused
                rs, info = run_fused(self, [plan], optimize=optimize,
                                     cost_model=cost_model, cache=cache)[0]
                if sync:
                    self.synchronize()
                return rs, info
            return self._run(plan, optimize, cost_model, sync, cache)
        finally:
            self._in_plan = False

    def run_many(self, plans, optimize: bool = True,
                 cost_model: CostModel | None = None, sync: bool = True,
                 cache=None):
        """Fused batch execution: same-kind seekers are batched *across all
        plans* into shared device launches.  Returns [(ResultSet,
        ExecInfo)] aligned with ``plans``; with ``sync=False`` nothing
        synchronizes."""
        from repro_torch.core.fused import run_fused
        self.refresh()
        self._in_plan = True
        try:
            out = run_fused(self, list(plans), optimize=optimize,
                            cost_model=cost_model, cache=cache)
        finally:
            self._in_plan = False
        if sync:
            self.synchronize()
        return out

    def _run(self, plan: Plan, optimize: bool, cost_model, sync: bool,
             cache=None):
        info = ExecInfo(optimized=optimize)
        ep = optimize_plan(plan, self.seeker_stats, cost_model) if optimize \
            else None
        memo: dict[str, comb.ResultSet] = {}
        # synchronized-timing mode (repro_torch.obs.set_sync_timing): each
        # node waits for the device before its clock read, so node_seconds
        # time device work, not the dispatch
        sync_time = obs.sync_timing()

        def timed_seeker(name, spec, allowed=None):
            t0 = time.perf_counter()
            hit = key = None
            if cache is not None and allowed is None:
                key = cache.seeker_key(spec)
                hit = cache.get_seeker(key)
            if hit is not None:
                rs = hit.result
                info.overflow_parts.append(hit.overflow)
                info.cached_nodes.append(name)
            else:
                rs = self.run_seeker(spec, allowed=allowed, sync=sync)
                if sync_time and not sync:
                    self.synchronize()
                info.seeker_runs += 1
                info.launches += self._last_launches
                info.overflow_parts.append(self._last_overflow)
                if key is not None:
                    cache.put_seeker(key, rs, self._last_overflow,
                                     self.n_tables)
            info.node_seconds[name] = time.perf_counter() - t0
            info.order.append(name)
            return rs

        def timed_combiner(name, fn):
            t0 = time.perf_counter()
            rs = fn()
            if sync_time:
                self.synchronize()
            info.node_seconds[name] = time.perf_counter() - t0
            info.order.append(name)
            info.launches += 1
            return rs

        def eval_node(name: str) -> comb.ResultSet:
            if name in memo:
                return memo[name]
            node = plan.nodes[name]
            if node.is_seeker:
                rs = timed_seeker(name, node.spec)
            else:
                kind = node.spec.kind
                k = node.spec.k
                if optimize and ep is not None and name in ep.groups:
                    rs = self._run_group(plan, ep.groups[name], node,
                                         timed_seeker, timed_combiner,
                                         eval_node, memo)
                elif kind == "difference":
                    a = eval_node(node.deps[0])
                    b_node = plan.nodes[node.deps[1]]
                    if optimize and b_node.is_seeker and \
                            len(plan.consumers(b_node.name)) == 1 and \
                            b_node.name not in memo:
                        # rewriting: restrict the subtrahend to the minuend's
                        # tables (WHERE TableId IN (IR_a))
                        b = timed_seeker(b_node.name, b_node.spec,
                                         allowed=a.mask)
                        memo[b_node.name] = b
                    else:
                        b = eval_node(node.deps[1])
                    rs = timed_combiner(name,
                                        lambda: comb.difference(a, b, k))
                else:
                    deps = [eval_node(d) for d in node.deps]
                    fn = {"intersect": comb.intersect, "union": comb.union,
                          "counter": comb.counter}.get(kind)
                    if fn is None:
                        raise ValueError(kind)
                    rs = timed_combiner(name, lambda: fn(deps, k))
            memo[name] = rs
            return rs

        result = eval_node(plan.output)
        reg = obs.registry()
        reg.counter("exec.plans").inc()
        reg.counter("exec.launches").inc(info.launches)
        reg.counter("exec.seeker_runs").inc(info.seeker_runs)
        reg.histogram("exec.plan_seconds").observe(info.total_seconds)
        return result, info

    def _run_group(self, plan, eg, combiner_node, timed_seeker,
                   timed_combiner, eval_node, memo):
        """Ranked execution-group run with mask threading (Intersection)."""
        results = []
        allowed = None
        for sname in eg.seekers:
            if sname in memo:
                # shared seeker (>= 2 consumers): it was executed
                # unrestricted once already — reuse, don't re-probe
                rs = memo[sname]
            else:
                exclusive = len(plan.consumers(sname)) == 1
                rs = timed_seeker(sname, plan.nodes[sname].spec,
                                  allowed=allowed if exclusive else None)
                memo[sname] = rs
            results.append(rs)
            allowed = rs.mask if allowed is None else (allowed & rs.mask)
        # non-seeker deps of the combiner are evaluated normally
        for dep in combiner_node.deps:
            if dep not in eg.seekers:
                results.append(eval_node(dep))
        return timed_combiner(
            combiner_node.name,
            lambda: comb.intersect(results, combiner_node.spec.k))

