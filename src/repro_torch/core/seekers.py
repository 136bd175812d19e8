"""The four BLEND seekers as plain functions on tensors.

Every seeker maps (MatchEngine, hashed query) -> dense per-table scores
[n_tables]; combiners are elementwise set algebra over these vectors.
``allowed`` is the optimizer's threaded intermediate-result mask — the
analogue of the paper's ``WHERE TableId IN (...)`` query rewriting: postings
from dead tables are zeroed *before* the expensive group-by / validation
stages.

All probing goes through ``MatchEngine.probe`` (core/match.py); the MC bloom
stage and the correlation scoring epilogue route through the engine too.
Static capacities (``m_cap`` matches per value, ``row_cap`` numeric cells per
row) bound the windows; overflows are counted and surfaced, never silently
dropped.

Group-bys are scatter-adds of 0/1 contributions into f32: exact in any
summation order (atomics included) while a count stays below 2^24, so scores
are bit-identical to the JAX package's.  JAX's ``.at[].add(mode="drop")``
drops out-of-range keys where ``index_add_`` raises, so the scatters route
them to a dump slot past the end.  Only the unfused compaction stages
read device values on the host (their survivor counts, the C stage's
``nonzero``); the ``*_seg`` functions of the fused path use no boolean-mask
indexing, ``nonzero`` or ``.item()``, so they can be captured into CUDA
graphs (core/programs.py).

``TRACE_COUNTS`` counts the device programs built per kind: the fused
path's program cache marks one per new key, the counterpart of the JAX
package's count of jit traces.
"""
from __future__ import annotations

import collections

import torch

from repro_torch import obs

INT32_MAX = torch.iinfo(torch.int32).max

TRACE_COUNTS = collections.Counter()


def _mark_trace(kind: str):
    """Count one new device program of ``kind``; also bridged into the
    metrics registry (``exec.retraces``), so a caller with observability
    enabled sees program churn without reaching into this module."""
    TRACE_COUNTS[kind] += 1
    reg = obs.registry()
    reg.counter("exec.retraces").inc()
    reg.counter(f"exec.retraces.{kind}").inc()


def _scatter(size: int, key, vals, reduce: str):
    """f32 [size] ``reduce`` ("sum" or "amax") of ``vals`` at ``key`` over
    zeros; out-of-range keys go to a dump slot ``size`` that is cut off,
    so they are dropped with no host sync (``mode="drop"``)."""
    key = key.reshape(-1).to(torch.int64)
    vals = vals.reshape(-1).to(torch.float32)
    keep = (key >= 0) & (key < size)
    key = torch.where(keep, key, size)
    out = torch.zeros(size + 1, dtype=torch.float32, device=vals.device)
    if reduce == "sum":
        out.index_add_(0, key, vals)
    else:
        out.scatter_reduce_(0, key, vals, reduce=reduce)
    return out[:size]


def _scatter_add(size: int, key, vals):
    """f32 [size] sums of ``vals`` at ``key``; out-of-range keys are dropped
    (``.at[key].add(vals, mode="drop")``)."""
    return _scatter(size, key, vals, "sum")


def _scatter_max(size: int, key, vals):
    """f32 [size] maxima of ``vals`` at ``key`` over zeros, out-of-range keys
    dropped (``jnp.zeros(size).at[key].max(vals, mode="drop")``)."""
    return _scatter(size, key, vals, "amax")


def _first_occurrence(*keys, valid=None):
    """Mask of first occurrence of a key combo along axis 1.  Inputs are
    sorted within each valid run; passing ``valid`` masks keys to a sentinel
    first so run boundaries always register as a change."""
    first = None
    for k in keys:
        if valid is not None:
            k = torch.where(valid, k, torch.full_like(k, -1))
        prev = torch.cat([torch.full_like(k[:, :1], -1), k[:, :-1]], dim=1)
        f = k != prev
        first = f if first is None else (first | f)
    return first


def _rowkey(t, r, row_stride: int):
    return t.to(torch.int32) * row_stride + r.to(torch.int32)


# --------------------------------------------------------------------------
# SC seeker — single-column join discovery (Listing 1)
# --------------------------------------------------------------------------

def sc_seeker(engine, q_hash, q_mask, *, m_cap, n_tables, max_cols,
              allowed=None):
    """COUNT(DISTINCT CellValue) GROUP BY (TableId, ColumnId); table score =
    best column.  Returns (scores f32 [n_tables], overflow)."""
    idx = engine.dev
    pidx, valid, ovf = engine.probe(q_hash, q_mask, m_cap)
    t = idx["table"][pidx]
    c = idx["col"][pidx]
    contrib = valid & _first_occurrence(t, c, valid=valid)
    if allowed is not None:
        contrib &= allowed[t]
    scores_tc = _scatter_add(n_tables * max_cols, t * max_cols + c, contrib)
    return scores_tc.reshape(n_tables, max_cols).amax(dim=1), ovf


# --------------------------------------------------------------------------
# KW seeker — keyword search (SC without the ColumnId group key)
# --------------------------------------------------------------------------

def kw_seeker(engine, q_hash, q_mask, *, m_cap, n_tables, allowed=None):
    idx = engine.dev
    pidx, valid, ovf = engine.probe(q_hash, q_mask, m_cap)
    t = idx["table"][pidx]
    contrib = valid & _first_occurrence(t, valid=valid)
    if allowed is not None:
        contrib &= allowed[t]
    return _scatter_add(n_tables, t, contrib), ovf


# --------------------------------------------------------------------------
# MC seeker — multi-column join discovery (MATE-style, Listing 2)
# --------------------------------------------------------------------------

def _tuple_mask_or_ones(tuple_mask, nt, device):
    return torch.ones(nt, dtype=torch.bool, device=device) \
        if tuple_mask is None else tuple_mask


def _tuple_table_hits(t, ok, nt: int, n_tables: int):
    """f32 [nt, n_tables]: 1 where tuple i matched a row of the table (one
    tuple counts once per table)."""
    tup = torch.arange(nt, device=t.device)[:, None]
    return _scatter_max(nt * n_tables, tup * n_tables + t,
                        ok).reshape(nt, n_tables)


def _mc_scores(t, ok, nt: int, n_tables: int):
    """Matched-tuple count per table and surviving candidate rows per
    table."""
    scores = _tuple_table_hits(t, ok, nt, n_tables).sum(dim=0)
    row_counts = _scatter_add(n_tables, t, ok)
    return scores, row_counts


def _mc_candidates(engine, tuple_hashes, init_col, qk_lo, qk_hi, m_cap,
                   use_superkey, allowed, tuple_mask):
    idx = engine.dev
    nt = tuple_hashes.shape[0]
    h0 = torch.gather(tuple_hashes, 1, init_col[:, None])[:, 0]
    q_mask = _tuple_mask_or_ones(tuple_mask, nt, h0.device)
    pidx, valid, ovf = engine.probe(h0, q_mask, m_cap)
    t = idx["table"][pidx]
    r = idx["row"][pidx]
    if allowed is not None:
        valid &= allowed[t]
    if use_superkey:
        valid &= engine.bloom(pidx, qk_lo, qk_hi)
    return t, r, valid, ovf, q_mask


def mc_seeker(engine, tuple_hashes, init_col, qk_lo, qk_hi, *, m_cap,
              n_tables, n_cols, row_stride=1 << 22, use_superkey=True,
              allowed=None, tuple_mask=None):
    """tuple_hashes: [nt, n_cols] query tuple keys; init_col: [nt] index of
    the least-frequent (initiator) value; qk_lo/hi: [nt] query superkeys;
    tuple_mask: [nt] optional validity of (padded) tuples.

    Phase 1: probe the initiator value -> candidate rows.
    Phase 2: XASH superkey bloom filter  ((row_sk & q_sk) == q_sk).
    Phase 3: exact validation — every other column value must occur in the
             same (table, row).
    Returns (scores = matched-tuple count per table, row_counts = candidate
    rows that survive per table, overflow)."""
    idx = engine.dev
    nt = tuple_hashes.shape[0]
    t, r, valid, ovf, q_mask = _mc_candidates(engine, tuple_hashes, init_col,
                                              qk_lo, qk_hi, m_cap,
                                              use_superkey, allowed,
                                              tuple_mask)
    rowkey = _rowkey(t, r, row_stride)

    ok = valid
    for j in range(n_cols):                       # static, small
        pj, vj, _ = engine.probe(tuple_hashes[:, j].contiguous(), q_mask,
                                 m_cap)
        rkj = _rowkey(idx["table"][pj], idx["row"][pj], row_stride)
        rkj = torch.where(vj, rkj, torch.full_like(rkj, -1))
        member = (rowkey[:, :, None] == rkj[:, None, :]).any(dim=-1)
        ok &= member | (init_col == j)[:, None]
    scores, row_counts = _mc_scores(t, ok, nt, n_tables)
    return scores, row_counts, ovf


# --------------------------------------------------------------------------
# MC capacity compaction: the executor measures the survivor count (stage 1)
# and re-launches the expensive validation with compacted candidate buffers
# (stage 2) — where "WHERE TableId IN (IR)" actually reduces work.
# --------------------------------------------------------------------------

def mc_survivor_counts(engine, tuple_hashes, init_col, qk_lo, qk_hi, *, m_cap,
                       use_superkey=True, allowed=None, tuple_mask=None):
    """Stage 1: candidates per tuple surviving the threaded predicate +
    bloom prune (the planner picks the stage-2 capacity from the max)."""
    _, _, valid, _, _ = _mc_candidates(engine, tuple_hashes, init_col, qk_lo,
                                       qk_hi, m_cap, use_superkey, allowed,
                                       tuple_mask)
    return valid.sum(dim=1)


def mc_seeker_compact(engine, tuple_hashes, init_col, qk_lo, qk_hi, *, m_cap,
                      m_cap2, n_tables, n_cols, row_stride=1 << 22,
                      use_superkey=True, allowed=None, tuple_mask=None):
    """Stage 2: exact validation over compacted [nt, m_cap2] candidates."""
    idx = engine.dev
    nt = tuple_hashes.shape[0]
    t, r, valid, ovf, q_mask = _mc_candidates(engine, tuple_hashes, init_col,
                                              qk_lo, qk_hi, m_cap,
                                              use_superkey, allowed,
                                              tuple_mask)
    # compact: move surviving candidates to the front (stable), take m_cap2
    order = torch.argsort((~valid).to(torch.int8), dim=1,
                          stable=True)[:, :m_cap2]
    t = torch.gather(t, 1, order)
    r = torch.gather(r, 1, order)
    valid = torch.gather(valid, 1, order)
    rowkey = _rowkey(t, r, row_stride)

    ok = valid
    for j in range(n_cols):
        pj, vj, _ = engine.probe(tuple_hashes[:, j].contiguous(), q_mask,
                                 m_cap)
        rkj = _rowkey(idx["table"][pj], idx["row"][pj], row_stride)
        rkj = torch.sort(torch.where(vj, rkj, torch.full_like(rkj, INT32_MAX)),
                         dim=1).values
        member = engine.member(rkj, rowkey)
        ok &= member | (init_col == j)[:, None]
    scores, row_counts = _mc_scores(t, ok, nt, n_tables)
    return scores, row_counts, ovf


# --------------------------------------------------------------------------
# Correlation seeker — QCR in one pass (Listing 3)
# --------------------------------------------------------------------------

def _qcr_table_scores(engine, nidx, nvalid, cj, qb, *, n_tables, max_cols,
                      h_sample, sampling, min_support, allowed, seg=None,
                      n_seekers=1):
    """Row-joined numeric cells -> per-(seeker, table, join_col, num_col)
    segment sums -> QCR epilogue -> best triple per table: f32
    [n_seekers, n_tables].  ``seg`` is each join posting's seeker (all 0
    when None)."""
    idx = engine.dev
    ntab = idx["num_table"][nidx]
    ncol = idx["num_col"][nidx]
    nquad = idx["num_quadrant"][nidx]
    rank = idx["num_rank_conv" if sampling == "conv" else "num_rank_rand"][nidx]
    nvalid = nvalid & (rank < h_sample)
    if allowed is not None:
        nvalid &= allowed[ntab]
    agree = (nquad == qb[:, None]) & nvalid
    key = (ntab * max_cols + cj[:, None]) * max_cols + ncol
    dim = n_tables * max_cols * max_cols
    if seg is not None:
        key = seg.to(torch.int64)[:, None] * dim + key
    n_all = _scatter_add(n_seekers * dim, key, nvalid)
    n_agree = _scatter_add(n_seekers * dim, key, agree)
    qcr = engine.qcr(n_agree, n_all, min_support)
    return qcr.reshape(n_seekers, n_tables, -1).amax(dim=2)


def c_seeker(engine, qj_hash, q_mask, q_bit, *, m_cap, row_cap, n_tables,
             max_cols, h_sample, row_stride=1 << 22, sampling="conv",
             min_support=3, allowed=None):
    """qj_hash: join-key query keys; q_bit[i] = 1 iff the query target for
    key i is >= the target mean (the paper's k0/k1 split).

    QCR = (2*(n_I + n_III) - N) / N  computed per (table, join_col, num_col)
    triple via two segment-sums; table score = max |QCR| over triples with
    N >= min_support.  h-sampling filters the numeric side by the indexed
    convenience/random rank."""
    idx = engine.dev
    pidx, valid, ovf = engine.probe(qj_hash, q_mask, m_cap)
    t = idx["table"][pidx]
    rowkey = _rowkey(t, idx["row"][pidx], row_stride)
    nidx, nvalid = engine.rowjoin(rowkey.reshape(-1), valid.reshape(-1),
                                  row_cap)
    qb = q_bit[:, None].expand(pidx.shape).reshape(-1)
    scores = _qcr_table_scores(
        engine, nidx, nvalid, idx["col"][pidx].reshape(-1), qb,
        n_tables=n_tables, max_cols=max_cols, h_sample=h_sample,
        sampling=sampling, min_support=min_support, allowed=allowed)
    return scores[0], ovf


def c_survivor_counts(engine, qj_hash, q_mask, *, m_cap, allowed=None):
    """Stage 1 for the compacted correlation seeker: join-side matches that
    survive the threaded predicate."""
    pidx, valid, _ = engine.probe(qj_hash, q_mask, m_cap)
    if allowed is not None:
        valid &= allowed[engine.dev["table"][pidx]]
    return valid.sum()


def c_seeker_compact(engine, qj_hash, q_mask, q_bit, *, m_cap, cap2, row_cap,
                     n_tables, max_cols, h_sample, row_stride=1 << 22,
                     sampling="conv", min_support=3, allowed=None):
    """Stage 2: the numeric row-join + QCR scoring runs over the compacted
    [cap2] surviving join-side postings instead of [nq*m_cap]."""
    idx = engine.dev
    pidx, valid, ovf = engine.probe(qj_hash, q_mask, m_cap)
    t = idx["table"][pidx]
    if allowed is not None:
        valid &= allowed[t]
    rowkey = _rowkey(t, idx["row"][pidx], row_stride).reshape(-1)
    cj = idx["col"][pidx].reshape(-1)
    qb = q_bit[:, None].expand(pidx.shape).reshape(-1)
    # nonzero(size=cap2, fill_value=-1): the fill must be out-of-band —
    # filling with slot 0 would mark the pad entries valid whenever slot 0
    # itself survives, double-counting its postings cap2-surv times in the
    # QCR segment sums
    hits = torch.nonzero(valid.reshape(-1)).reshape(-1)[:cap2]
    keep = torch.full((cap2,), -1, dtype=torch.int64, device=hits.device)
    keep[:hits.shape[0]] = hits
    kv = keep >= 0
    keep = torch.where(kv, keep, torch.zeros_like(keep))
    rk = torch.where(kv, rowkey[keep], torch.full_like(rowkey[keep], -1))
    nidx, nvalid = engine.rowjoin(rk, kv & (rk >= 0), row_cap)
    scores = _qcr_table_scores(
        engine, nidx, nvalid, cj[keep], qb[keep], n_tables=n_tables,
        max_cols=max_cols, h_sample=h_sample, sampling=sampling,
        min_support=min_support, allowed=None)
    return scores[0], ovf


# --------------------------------------------------------------------------
# Segmented (fused-batch) seekers: core/fused.py runs all same-kind seekers
# of a plan, or of a whole query_many batch, as ONE device program.  The
# padded query arrays are concatenated with per-row seeker ids (``seg_id``)
# and per-row match capacities (``row_caps``, each seeker's own ladder
# rung); probing goes through ``MatchEngine.probe_capped`` and the group-by
# keys are prefixed with the seeker id, so one scatter gives a stacked
# [n_seekers, n_tables] score matrix whose rows equal the dedicated
# launches bit for bit (same windows, same 0/1 sums).  They run
# unrestricted: the optimizer's masks are applied in the DAG program.  No
# host sync, so each can be captured into a CUDA graph.
# --------------------------------------------------------------------------

def _seg_overflow(n_seekers: int, seg_id, ovf_rows):
    """Per-row overflow summed by seeker: int64 [n_seekers]."""
    out = torch.zeros(n_seekers, dtype=torch.int64, device=ovf_rows.device)
    return out.index_add_(0, seg_id.to(torch.int64),
                          ovf_rows.to(torch.int64))


def sc_seeker_seg(engine, q_hash, q_mask, seg_id, row_caps, *, m_cap,
                  n_seekers, n_tables, max_cols):
    """Batched ``sc_seeker``: (scores f32 [n_seekers, n_tables], overflow
    int64 [n_seekers])."""
    idx = engine.dev
    pidx, valid, ovf_rows = engine.probe_capped(q_hash, q_mask, m_cap,
                                                row_caps)
    t = idx["table"][pidx]
    c = idx["col"][pidx]
    contrib = valid & _first_occurrence(t, c, valid=valid)
    key = (seg_id.to(torch.int64)[:, None] * n_tables + t) * max_cols + c
    scores = _scatter_add(n_seekers * n_tables * max_cols, key, contrib)
    return scores.reshape(n_seekers, n_tables, max_cols).amax(dim=2), \
        _seg_overflow(n_seekers, seg_id, ovf_rows)


def kw_seeker_seg(engine, q_hash, q_mask, seg_id, row_caps, *, m_cap,
                  n_seekers, n_tables):
    """Batched ``kw_seeker`` (SC without the ColumnId group key)."""
    idx = engine.dev
    pidx, valid, ovf_rows = engine.probe_capped(q_hash, q_mask, m_cap,
                                                row_caps)
    t = idx["table"][pidx]
    contrib = valid & _first_occurrence(t, valid=valid)
    key = seg_id.to(torch.int64)[:, None] * n_tables + t
    scores = _scatter_add(n_seekers * n_tables, key, contrib)
    return scores.reshape(n_seekers, n_tables), \
        _seg_overflow(n_seekers, seg_id, ovf_rows)


def mc_seeker_seg(engine, tuple_hashes, init_col, qk_lo, qk_hi, seg_id,
                  row_caps, tuple_mask, *, m_cap, n_seekers, n_tables, n_cols,
                  row_stride):
    """Batched ``mc_seeker`` over the concatenated tuple blocks of all MC
    seekers of one width ``n_cols``; ``seg_id`` is per tuple.  The
    matched-tuple counts are summed by seeker after the per-tuple dedupe,
    so each stacked row equals the dedicated launch's scores."""
    idx = engine.dev
    nt = tuple_hashes.shape[0]
    h0 = torch.gather(tuple_hashes, 1,
                      init_col.to(torch.int64)[:, None])[:, 0]
    pidx, valid, ovf_rows = engine.probe_capped(h0, tuple_mask, m_cap,
                                                row_caps)
    t = idx["table"][pidx]
    valid = valid & engine.bloom(pidx, qk_lo, qk_hi)
    rowkey = _rowkey(t, idx["row"][pidx], row_stride)
    ok = valid
    for j in range(n_cols):                       # static, small
        pj, vj, _ = engine.probe_capped(tuple_hashes[:, j].contiguous(),
                                        tuple_mask, m_cap, row_caps)
        rkj = _rowkey(idx["table"][pj], idx["row"][pj], row_stride)
        rkj = torch.where(vj, rkj, torch.full_like(rkj, -1))
        member = (rowkey[:, :, None] == rkj[:, None, :]).any(dim=-1)
        ok = ok & (member | (init_col == j)[:, None])
    scores = torch.zeros((n_seekers, n_tables), dtype=torch.float32,
                         device=t.device)
    scores.index_add_(0, seg_id.to(torch.int64),
                      _tuple_table_hits(t, ok, nt, n_tables))
    return scores, _seg_overflow(n_seekers, seg_id, ovf_rows)


def c_seeker_seg(engine, qj_hash, q_mask, q_bit, seg_id, row_caps, *, m_cap,
                 row_cap, n_seekers, n_tables, max_cols, h_sample, row_stride,
                 sampling, min_support=3):
    """Batched ``c_seeker``: the QCR group-by key is prefixed with the
    seeker id of the originating join posting, so every segment sum (and
    every QCR ratio) is built from exactly the contributions the dedicated
    launch would see."""
    idx = engine.dev
    pidx, valid, ovf_rows = engine.probe_capped(qj_hash, q_mask, m_cap,
                                                row_caps)
    t = idx["table"][pidx]
    rowkey = _rowkey(t, idx["row"][pidx], row_stride)
    nidx, nvalid = engine.rowjoin(rowkey.reshape(-1), valid.reshape(-1),
                                  row_cap)
    qb = q_bit[:, None].expand(pidx.shape).reshape(-1)
    seg = seg_id[:, None].expand(pidx.shape).reshape(-1)
    scores = _qcr_table_scores(
        engine, nidx, nvalid, idx["col"][pidx].reshape(-1), qb,
        n_tables=n_tables, max_cols=max_cols, h_sample=h_sample,
        sampling=sampling, min_support=min_support, allowed=None, seg=seg,
        n_seekers=n_seekers)
    return scores, _seg_overflow(n_seekers, seg_id, ovf_rows)
