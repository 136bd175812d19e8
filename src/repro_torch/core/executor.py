"""Plan executor: optimized (EG ordering + mask threading) and naive (B-NO).

The executor owns a ``MatchEngine`` (device index + probe backends) on one
device, hashes query values through a cross-query memo cache, and runs the
plan DAG.  ``optimize=False`` reproduces the paper's B-NO configuration:
same seekers and combiners, insertion seeker order, no intermediate-result
threading.

Match capacities are quantized to a small fixed ladder and query counts are
padded to powers of two, exactly as in the JAX package, so both systems see
the same windows and overflow counts.  ``sync=False`` skips the
data-dependent compaction stages (their capacity picks are host syncs).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import combiners as comb
from repro_torch.core import seekers as seek
from repro_torch.core.cost_model import CostModel
from repro_torch.core.hashing import MISSING, hash_value, row_superkey, \
    split_u64
from repro_torch.core.index import UnifiedIndex, hash_keys, resolve_device
from repro_torch.core.match import MatchEngine
from repro_torch.core.optimizer import optimize as optimize_plan
from repro_torch.core.plan import Plan, SeekerSpec

# the match-capacity ladder: every seeker launch uses one of these
# capacities, so a coarse ladder keeps the window shape stable across draws
# from the same workload
CAP_LADDER = (32, 128, 512, 1024)
PAD_SENTINEL = MISSING                    # reserved: never a real cell hash


@dataclass
class ExecInfo:
    optimized: bool
    node_seconds: dict = field(default_factory=dict)
    order: list = field(default_factory=list)
    overflow_parts: list = field(default_factory=list)
    # device-program dispatch count: every seeker call (compaction stages
    # included) and every combiner node counts one
    launches: int = 0

    @property
    def total_seconds(self) -> float:
        return sum(self.node_seconds.values())

    @property
    def overflow(self) -> int:
        return int(sum(int(p) for p in self.overflow_parts))


def _pow2_at_least(n: int, lo: int = 8, hi: int = 1024) -> int:
    m = lo
    while m < min(n, hi):
        m *= 2
    return m


class Executor:
    """Runs plans over a static ``UnifiedIndex`` on ``device`` (``None``
    means CUDA and raises when no card is present; pass ``device="cpu"``
    for the plain PyTorch path)."""

    def __init__(self, index: UnifiedIndex, m_cap_max: int = 1024,
                 row_cap: int = 8, backend: str = "sorted",
                 bucket_width: int | None = None, device=None):
        self.device = resolve_device(device)
        self.index = index
        self.backend = backend
        self.engine = MatchEngine.from_index(
            index, backend=backend, bucket_width=bucket_width,
            device=self.device)
        self.n_tables = index.n_tables
        self.max_cols = index.max_cols
        self.m_cap_max = m_cap_max
        self.row_cap = row_cap
        rungs = {min(c, m_cap_max) for c in CAP_LADDER}
        if m_cap_max > max(CAP_LADDER):
            rungs.add(m_cap_max)        # honor caps above the default ladder
        self.cap_ladder = tuple(sorted(rungs))
        self._hash_cache: dict = {}
        self._hash_cache_max = 1 << 20

    # ------------------------------------------------------------------ util
    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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

    def seeker_stats(self, spec: SeekerSpec):
        """(cardinality, n_cols, avg value frequency) — the cost features."""
        if spec.kind == "MC":
            freqs = []
            for c in range(spec.n_cols):
                h = self._hashed([t[c] for t in spec.values])
                freqs.append(self.index.host_counts(h).mean())
            avg = float(np.prod(freqs))
            return (float(len(spec.values)), float(spec.n_cols), avg)
        h = self._hashed(spec.values)
        avg = float(self.index.host_counts(h).mean()) if len(h) else 0.0
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
        if sync and scores.is_cuda:
            torch.cuda.synchronize(scores.device)
        self._last_overflow = ovf
        return comb.topk_result(scores, spec.k)

    # ------------------------------------------------------------------ plan
    def run(self, plan: Plan, optimize: bool = True,
            cost_model: CostModel | None = None, sync: bool = True,
            cache=None, fused: bool = False):
        """Execute ``plan`` (unfused: one dispatch per node)."""
        if cache is not None:
            raise NotImplementedError(
                "the query cache is not ported yet (ROADMAP queue A, item "
                "A5: serve/cache.py)")
        if fused:
            raise NotImplementedError(
                "fused execution is not ported yet (ROADMAP queue A, item A2: "
                "core/fused.py)")
        return self._run(plan, optimize, cost_model, sync)

    def _run(self, plan: Plan, optimize: bool, cost_model, sync: bool):
        info = ExecInfo(optimized=optimize)
        ep = optimize_plan(plan, self.seeker_stats, cost_model) if optimize \
            else None
        memo: dict[str, comb.ResultSet] = {}

        def timed_seeker(name, spec, allowed=None):
            t0 = time.perf_counter()
            rs = self.run_seeker(spec, allowed=allowed, sync=sync)
            info.launches += self._last_launches
            info.overflow_parts.append(self._last_overflow)
            info.node_seconds[name] = time.perf_counter() - t0
            info.order.append(name)
            return rs

        def timed_combiner(name, fn):
            t0 = time.perf_counter()
            rs = fn()
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

        return eval_node(plan.output), info

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
