"""Fused plan execution: batched same-kind seeker dispatch + one device
program for the whole combiner DAG.

The unfused executor pays one dispatch per seeker node (two for the
compaction stages) and a Python re-entry between every combiner; on the
card, host work and launches, not probe work, dominate a query.  The fused
path collapses a plan (or a whole ``run_many`` batch) to ``n_kinds + 1``
device programs:

1. **Batched seeker dispatch** — all same-kind seekers, across every plan in
   the batch, are concatenated into one padded query array with per-row
   seeker ids and per-row (ladder-quantized) capacities, probed once through
   ``MatchEngine.probe_capped`` and grouped-by into a stacked
   ``[n_seekers, n_tables]`` score matrix (seekers.py ``*_seeker_seg``).
   Capacity lookups batch into ONE ``host_counts`` call over every seeker's
   hashes.
2. **Whole-DAG program** — the post-seeker combiner DAG (top-k / intersect /
   union / difference / counter / optimizer mask threading) is elementwise
   over ``[n_tables]`` vectors, so the entire DAG is one program keyed on
   the (static, hashable) instruction list derived from the plan topology.
   No intermediate host syncs.

Each program is a captured CUDA graph on the card and an eager call on the
CPU (core/programs.py).  Bit-identity with the unfused executor rests on
two invariants:

* per-seeker probe windows under ``probe_capped`` hold exactly the postings
  a dedicated launch at that seeker's capacity would hold, and every seeker
  score is a sum / max of 0-or-1 float contributions (or a QCR ratio of such
  sums), so the stacked rows equal the dedicated launches bit for bit;
* a seeker run under the optimizer's threaded ``allowed`` mask equals
  ``where(allowed, unrestricted_scores, 0)`` followed by the same top-k —
  the mask is constant per table and is ANDed into contributions *before* a
  per-table group-by — so mask threading moves into the DAG program, and
  the batched seekers all run unrestricted.

Query-cache composition: seekers served from the subplan cache drop out of
the batch entirely; their cached (scores, mask) vectors are fed to the DAG
program as extra inputs.  As in the unfused path, only unrestricted runs
are served from or stored into the cache, so partial hits stay
bit-identical to a cold run.  The DAG program also returns the registers
of the seekers to store, and each is stored as a copy: the program's
output buffers are rewritten by its next replay.

Program-key discipline: the batch query width, the tuple-block width, the
seeker count and the shared capacity window are quantized onto power-of-two
/ capacity ladders, and the DAG program is keyed on plan topology, so
re-running any plan shape with new values of the same buckets builds no new
program (``seekers.TRACE_COUNTS``, asserted in tests/test_torch_fused.py).
A seeker group's key also holds the engine's ``EngineConfig`` (what the JAX
package's jit sees) and the arena generation (``Executor.program_key``):
on a live lake a mutation within a seen geometry reuses the program, whose
replay reads the refilled arena (tests/test_torch_live.py,
tests/test_torch_cuda.py).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import combiners as comb
from repro_torch.core import seekers as seek
from repro_torch.core.executor import (ExecInfo, OverflowSlice, PAD_SENTINEL,
                                       _pow2_at_least)
from repro_torch.core.hashing import row_superkey, split_u64
from repro_torch.core.index import hash_keys
from repro_torch.core.optimizer import optimize as optimize_plan
from repro_torch.obs import trace as otrace


@dataclass
class _Task:
    """One pending (unrestricted) seeker dispatch in the fused batch."""
    plan_idx: int
    name: str
    spec: object
    instr_idx: int                    # its placeholder slot in the plan prog
    # hashed query payload (filled by _hash_tasks)
    h: np.ndarray | None = None      # SC/KW/C: hashed values
    qbit: np.ndarray | None = None   # C: k0/k1 split bits
    th: np.ndarray | None = None     # MC: [nt, n_cols] hashed tuples
    init_col: np.ndarray | None = None
    qk_lo: np.ndarray | None = None
    qk_hi: np.ndarray | None = None
    nt: int = 0                      # MC: deduped tuple count
    m_cap: int = 0                   # this seeker's capacity-ladder rung
    group_key: tuple = ()
    row: int = -1                    # row in the group's stacked output
    head: object = None              # canonical task for this spec: dupes
    #                                  share its hashes, batch row and scores


@dataclass
class _PlanProg:
    """A plan compiled to a linear DAG program + its pending seeker batch."""
    instrs: list = field(default_factory=list)
    order: list = field(default_factory=list)        # ExecInfo.order parity
    tasks: list = field(default_factory=list)        # _Task, traversal order
    cached: list = field(default_factory=list)       # CachedSeeker hits
    cached_names: list = field(default_factory=list)
    cache_puts: list = field(default_factory=list)   # (key, reg, task)
    out_reg: int = 0


def _group_key(spec) -> tuple:
    """Seekers sharing a key share one device program: the kind plus every
    per-seeker *static* argument of its segmented seeker."""
    if spec.kind == "MC":
        return ("MC", spec.n_cols)
    if spec.kind == "C":
        return ("C", spec.h, spec.sampling)
    return (spec.kind,)


# --------------------------------------------------------------------------
# plan -> linear DAG program (mirrors Executor._run's traversal exactly,
# including the memoization, EG mask threading, the difference-subtrahend
# rewrite and the subplan-cache consultation order)
# --------------------------------------------------------------------------

def _compile_plan(plan, optimize, ep, cache, plan_idx) -> _PlanProg:
    pr = _PlanProg()
    reg_of: dict[str, int] = {}

    def emit(ins) -> int:
        pr.instrs.append(ins)
        return len(pr.instrs) - 1

    def seeker_node(name, spec, allowed_reg) -> int:
        # mirrors timed_seeker: the cache serves and stores unrestricted
        # runs only
        key = cache.seeker_key(spec) \
            if cache is not None and allowed_reg is None else None
        if key is not None:
            hit = cache.get_seeker(key)
            if hit is not None:
                reg = emit(("cached", len(pr.cached)))
                pr.cached.append(hit)
                pr.cached_names.append(name)
                pr.order.append(name)
                return reg
        task = _Task(plan_idx=plan_idx, name=name, spec=spec,
                     instr_idx=len(pr.instrs))
        # the task's ordinal within the plan is stable across batch
        # compositions; its batch row is resolved through the ``rows``
        # operand at run time, so reshuffled batches reuse the DAG program
        reg = emit(("seeker", None, len(pr.tasks), spec.k,
                    -1 if allowed_reg is None else allowed_reg))
        pr.tasks.append(task)
        if key is not None:
            pr.cache_puts.append((key, reg, task))
        pr.order.append(name)
        return reg

    def run_group(eg, combiner_node) -> int:
        results = []
        allowed = None
        for sname in eg.seekers:
            if sname in reg_of:
                r = reg_of[sname]
            else:
                exclusive = len(plan.consumers(sname)) == 1
                r = seeker_node(sname, plan.nodes[sname].spec,
                                allowed if exclusive else None)
                reg_of[sname] = r
            results.append(r)
            allowed = r if allowed is None else emit(("maskand", allowed, r))
        for dep in combiner_node.deps:
            if dep not in eg.seekers:
                results.append(eval_node(dep))
        reg = emit(("intersect", tuple(results), combiner_node.spec.k))
        pr.order.append(combiner_node.name)
        return reg

    def eval_node(name: str) -> int:
        if name in reg_of:
            return reg_of[name]
        node = plan.nodes[name]
        if node.is_seeker:
            reg = seeker_node(name, node.spec, None)
        else:
            kind = node.spec.kind
            k = node.spec.k
            if optimize and ep is not None and name in ep.groups:
                reg = run_group(ep.groups[name], node)
            elif kind == "difference":
                a = eval_node(node.deps[0])
                b_node = plan.nodes[node.deps[1]]
                if optimize and b_node.is_seeker and \
                        len(plan.consumers(b_node.name)) == 1 and \
                        b_node.name not in reg_of:
                    b = seeker_node(b_node.name, b_node.spec, a)
                    reg_of[b_node.name] = b
                else:
                    b = eval_node(node.deps[1])
                reg = emit(("difference", a, b, k))
                pr.order.append(name)
            elif kind in ("intersect", "union", "counter"):
                deps = tuple(eval_node(d) for d in node.deps)
                reg = emit((kind, deps, k))
                pr.order.append(name)
            else:
                raise ValueError(kind)
        reg_of[name] = reg
        return reg

    pr.out_reg = eval_node(plan.output)
    return pr


# --------------------------------------------------------------------------
# batched hashing + ONE host_counts call for every capacity pick
# --------------------------------------------------------------------------

def _hash_tasks(ex, tasks):
    """Hash every pending seeker's query values (through the executor's
    memoized value-hash cache) and pick every capacity from one batched
    ``host_counts`` lookup over the concatenated hash arrays."""
    reqs = []
    for t in tasks:
        spec = t.spec
        if spec.kind in ("SC", "KW"):
            t.h = ex._hashed(spec.values)
            reqs.append(t.h)
        elif spec.kind == "C":
            pairs = list(dict.fromkeys(zip(spec.values, spec.target)))
            t.h = ex._hash_many([p[0] for p in pairs])
            tgt = np.array([float(p[1]) for p in pairs])
            t.qbit = (tgt >= tgt.mean()).astype(np.int8) if len(tgt) \
                else np.zeros(0, np.int8)
            reqs.append(t.h)
        else:                                       # MC
            values = list(dict.fromkeys(spec.values))
            t.nt = len(values)
            n_cols = spec.n_cols
            t.th = np.stack([ex._hash_many([v[c] for v in values])
                             for c in range(n_cols)], axis=1) if values \
                else np.zeros((0, n_cols), np.uint32)
            qks = np.array([row_superkey(t.th[i], np.zeros(n_cols, np.int64))
                            for i in range(t.nt)], np.uint64)
            t.qk_lo, t.qk_hi = split_u64(qks)
            reqs.append(t.th.reshape(-1))
    if not tasks:
        return
    lens = np.array([len(r) for r in reqs], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    all_h = np.concatenate(reqs) if offs[-1] else np.zeros(0, np.uint32)
    counts = ex.index.host_counts(all_h)
    for i, t in enumerate(tasks):
        c = counts[offs[i]:offs[i + 1]]
        if t.spec.kind == "MC":
            cm = c.reshape(t.nt, t.spec.n_cols) if t.nt \
                else np.zeros((0, t.spec.n_cols), np.int64)
            t.init_col = np.argmin(cm, axis=1).astype(np.int32) if t.nt \
                else np.zeros(0, np.int32)
            t.m_cap = ex._quantize_cap(int(cm.max(initial=1)))
        else:
            t.m_cap = ex._quantize_cap(int(c.max(initial=1)))


# --------------------------------------------------------------------------
# group batch assembly + launch
# --------------------------------------------------------------------------

def _pow2(n: int, lo: int) -> int:
    return _pow2_at_least(max(n, 1), lo=lo, hi=1 << 30)


def _launch_group(ex, key, tasks):
    """Dispatch one seeker group as a single device program.  Returns
    (scores [n_seekers_p, n_tables], overflow [n_seekers_p]); the scores are
    the program's own buffer (read by this batch's DAG programs), the
    overflow a copy.  ``tasks`` are the deduped head tasks of the group
    (run_fused collapses identical specs before hashing)."""
    for i, t in enumerate(tasks):
        t.row = i
    kind = key[0]
    # lo=8: a batch's per-kind seeker count varies with every batch
    # composition; padding the stacked output to at least 8 rows collapses
    # nsp (and with it the DAG program's input shapes) onto a couple of
    # buckets, so reshuffled batches build no new program
    nsp = _pow2(len(tasks), lo=8)
    m_cap = max([1] + [t.m_cap for t in tasks])
    if kind == "MC":
        n_cols = key[1]
        width = _pow2(sum(t.nt for t in tasks), lo=8)
        th = np.zeros((width, n_cols), np.uint32)
        init = np.zeros(width, np.int32)
        qlo = np.zeros(width, np.uint32)
        qhi = np.zeros(width, np.uint32)
        seg = np.zeros(width, np.int32)
        caps = np.zeros(width, np.int32)
        tmask = np.zeros(width, bool)
        off = 0
        for i, t in enumerate(tasks):
            n = t.nt
            th[off:off + n] = t.th
            init[off:off + n] = t.init_col
            qlo[off:off + n] = t.qk_lo
            qhi[off:off + n] = t.qk_hi
            seg[off:off + n] = i
            caps[off:off + n] = t.m_cap
            tmask[off:off + n] = True
            off += n
        host = (hash_keys(th), init, qlo.view(np.int32), qhi.view(np.int32),
                seg, caps, tmask)
        static = dict(m_cap=m_cap, n_seekers=nsp, n_tables=ex.n_tables,
                      n_cols=n_cols, row_stride=ex.index.row_stride)
        fn = seek.mc_seeker_seg
    else:
        width = _pow2(sum(len(t.h) for t in tasks), lo=16)
        qh = np.full(width, PAD_SENTINEL, np.uint32)
        qm = np.zeros(width, bool)
        seg = np.zeros(width, np.int32)
        caps = np.zeros(width, np.int32)
        qb = np.zeros(width, np.int8)
        off = 0
        for i, t in enumerate(tasks):
            n = len(t.h)
            qh[off:off + n] = t.h
            qm[off:off + n] = True
            seg[off:off + n] = i
            caps[off:off + n] = t.m_cap
            if kind == "C":
                qb[off:off + n] = t.qbit
            off += n
        static = dict(m_cap=m_cap, n_seekers=nsp, n_tables=ex.n_tables)
        host = (hash_keys(qh), qm, seg, caps)
        if kind == "SC":
            static["max_cols"] = ex.max_cols
            fn = seek.sc_seeker_seg
        elif kind == "KW":
            fn = seek.kw_seeker_seg
        else:
            host = (hash_keys(qh), qm, qb, seg, caps)
            static.update(row_cap=ex.row_cap, max_cols=ex.max_cols,
                          h_sample=key[1], sampling=key[2],
                          row_stride=ex.index.row_stride)
            fn = seek.c_seeker_seg
    rec = otrace.current()
    with rec.span("shard:0", m_cap=m_cap, seekers=len(tasks)):
        t0 = time.perf_counter()
        # keyed on the engine's config and arena generation: a program
        # reads the engine's tensors, views of the arena that every refresh
        # refills in place, so it is built (called) with the current engine
        # and its replays read the current epoch
        scores, ovf = ex.programs.run(
            ex.program_key(kind, width, tuple(sorted(static.items()))),
            kind + "_seg", lambda *ops: fn(ex.engine, *ops, **static), host)
        ovf = ovf.clone()           # read lazily, after later replays
        if obs.sync_timing():
            ex.synchronize()
        obs.registry().histogram("shard.probe_seconds.0").observe(
            time.perf_counter() - t0)
    return scores, ovf


# --------------------------------------------------------------------------
# the whole-DAG device program
# --------------------------------------------------------------------------

def _run_dag(prog, outs, n_groups, rows, *inputs):
    """Execute one plan's compiled instruction list as one program.
    ``inputs`` are the ``n_groups`` stacked seeker score matrices this plan
    consumes, then each cached seeker's scores and mask; ``rows`` maps each
    seeker ordinal to its batch row (an operand, so a reshuffled batch of
    the same plan shapes reuses the program).  Every op is its
    combiners.py counterpart, so outputs are bit-identical to the
    node-at-a-time walk.  Returns (scores, mask) of each register in
    ``outs``, flattened."""
    rows = rows.to(torch.int64)
    group_scores, cached = inputs[:n_groups], inputs[n_groups:]
    regs = []
    for ins in prog:
        op = ins[0]
        if op == "seeker":
            _, gi, j, k, allowed = ins
            s = torch.index_select(group_scores[gi], 0, rows[j:j + 1])[0]
            if allowed >= 0:
                s = torch.where(regs[allowed].mask, s, 0.0)
            regs.append(comb.topk_result(s, k))
        elif op == "cached":
            i = 2 * ins[1]
            regs.append(comb.ResultSet(scores=cached[i], mask=cached[i + 1]))
        elif op == "maskand":
            a, b = regs[ins[1]], regs[ins[2]]
            regs.append(comb.ResultSet(scores=a.scores, mask=a.mask & b.mask))
        elif op == "difference":
            _, a, b, k = ins
            regs.append(comb.difference(regs[a], regs[b], k))
        else:
            _, deps, k = ins
            fn = {"intersect": comb.intersect, "union": comb.union,
                  "counter": comb.counter}[op]
            regs.append(fn([regs[d] for d in deps], k))
    return tuple(t for r in outs for t in (regs[r].scores, regs[r].mask))


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def run_fused(ex, plans, optimize=True, cost_model=None, cache=None):
    """Execute ``plans`` (one or a whole ``run_many`` batch) on the fused
    path; returns [(ResultSet, ExecInfo)] aligned with ``plans``.  The
    caller (Executor.run / Executor.run_many) owns the final sync."""
    eps = [optimize_plan(p, ex.seeker_stats, cost_model) if optimize
           else None for p in plans]
    progs = [_compile_plan(p, optimize, e, cache, i)
             for i, (p, e) in enumerate(zip(plans, eps))]

    tasks = [t for pr in progs for t in pr.tasks]
    # identical seekers (same frozen spec, e.g. a subtree shared across a
    # batch, where every request's cache lookups happen before any put)
    # collapse onto one head task BEFORE hashing: same spec means
    # same hashes, capacity rung and scores, so dupes share the head's
    # batch row and pay no host work
    heads: dict = {}
    for t in tasks:
        t.head = heads.setdefault(t.spec, t)
    _hash_tasks(ex, list(heads.values()))

    groups: dict[tuple, list] = {}
    for h in heads.values():
        h.group_key = _group_key(h.spec)
        groups.setdefault(h.group_key, []).append(h)
    group_out: dict[tuple, tuple] = {}
    launch_seconds: dict[tuple, float] = {}
    rec = otrace.current()
    mreg = obs.registry()
    for key in sorted(groups):
        kind_name = "/".join(str(p) for p in key)
        # compile-vs-execute split: a launch that built a program pays the
        # capture; steady-state launches land in exec.probe_seconds only
        tr0 = sum(seek.TRACE_COUNTS.values())
        t0 = time.perf_counter()
        with rec.span("probe:" + kind_name, seekers=len(groups[key])) as sp:
            group_out[key] = _launch_group(ex, key, groups[key])
        dt = time.perf_counter() - t0
        launch_seconds[key] = dt
        if sum(seek.TRACE_COUNTS.values()) > tr0:
            sp.set("compiled", True)
            mreg.counter("exec.compiles").inc()
            mreg.histogram("exec.compile_seconds").observe(dt)
        else:
            mreg.histogram("exec.probe_seconds").observe(dt)
    group_plans: dict[tuple, set] = {}
    for t in tasks:                    # dupes adopt their head's placement
        t.group_key = t.head.group_key
        t.row = t.head.row
        group_plans.setdefault(t.group_key, set()).add(t.plan_idx)

    out = []
    for pr in progs:
        plan_keys = sorted({t.group_key for t in pr.tasks})
        key_idx = {k: i for i, k in enumerate(plan_keys)}
        for t in pr.tasks:
            ins = pr.instrs[t.instr_idx]
            pr.instrs[t.instr_idx] = ("seeker", key_idx[t.group_key],
                                      ins[2], ins[3], ins[4])
        rows = np.array([t.row for t in pr.tasks], np.int32)
        gs = tuple(group_out[k][0] for k in plan_keys)
        cached = tuple(t for c in pr.cached
                       for t in (c.result.scores, c.result.mask))
        prog = tuple(pr.instrs)
        outs = (pr.out_reg,) + tuple(reg for _, reg, _ in pr.cache_puts)
        tr0 = sum(seek.TRACE_COUNTS.values())
        t0 = time.perf_counter()
        with rec.span("merge", instrs=len(pr.instrs)) as sp:
            got = ex.programs.run(
                ("DAG", prog, outs), "DAG",
                lambda r, *g, _p=prog, _o=outs, _n=len(gs): _run_dag(
                    _p, _o, _n, r, *g),
                (rows,), gs + cached)
            # the program's buffers are rewritten by its next replay: the
            # result and every cached seeker are copies
            regs = {}
            for i, reg in enumerate(outs):
                if reg not in regs:
                    regs[reg] = comb.ResultSet(scores=got[2 * i].clone(),
                                               mask=got[2 * i + 1].clone())
            result = regs[pr.out_reg]
            if obs.sync_timing():
                ex.synchronize()
        dag_s = time.perf_counter() - t0
        if sum(seek.TRACE_COUNTS.values()) > tr0:
            sp.set("compiled", True)
            mreg.counter("exec.compiles").inc()
            mreg.histogram("exec.compile_seconds").observe(dag_s)
        else:
            mreg.histogram("exec.dag_seconds").observe(dag_s)

        info = ExecInfo(optimized=optimize)
        info.order = pr.order
        info.cached_nodes = pr.cached_names
        info.seeker_runs = len(pr.tasks)
        # one launch per seeker group + the DAG program; groups == kinds
        # unless same-kind seekers differ in static shape args (MC n_cols,
        # C h/sampling), each of which is its own device program
        info.launches = len(plan_keys) + 1
        info.node_seconds["fused:dag"] = dag_s
        for key in plan_keys:
            # a batch's group launch is shared across plans; attribute an
            # equal share so per-plan node_seconds stay additive (+= so two
            # same-kind groups, e.g. MC n_cols=2 and 3, don't overwrite)
            name = "fused:" + "/".join(str(p) for p in key)
            info.node_seconds[name] = info.node_seconds.get(name, 0.0) + \
                launch_seconds[key] / len(group_plans[key])
        info.overflow_parts.extend(c.overflow for c in pr.cached)
        for key in plan_keys:
            rows_k = [t.row for t in pr.tasks if t.group_key == key]
            info.overflow_parts.append(OverflowSlice(group_out[key][1],
                                                     rows_k))
        for ckey, reg, task in pr.cache_puts:
            cache.put_seeker(ckey, regs[reg],
                             OverflowSlice(group_out[task.group_key][1],
                                           [task.row]), ex.n_tables)
        out.append((result, info))
    mreg.counter("exec.plans").inc(len(out))
    # physical device programs this call: one per group + one DAG per plan
    # (per-plan ExecInfo.launches attributes shared group launches to every
    # consumer, so summing those would overcount)
    mreg.counter("exec.launches").inc(len(groups) + len(progs))
    mreg.counter("exec.seeker_runs").inc(len(tasks))
    return out
