"""Sketch tier: per-table KMV / MinHash / row-sample sketches with error
bounds, the approximate discovery path behind ``Session.query(approx=...)``.

Each table gets a fixed-size summary that answers the seekers' questions
approximately, with confidence intervals; the session ranks top-k
candidates from the sketches and escalates only the contended boundary of
the ranking to the exact path.  The module is host NumPy, exactly as the
JAX package's ``repro.core.sketch``; the one device step of the tier is
the top-k over the estimates (query/session.py).

Determinism contract: a table's sketch is a pure function of its posting
arrays, the store seed and the ``SketchConfig``, never of build order,
table id or segment layout:

* KMV / MinHash summarize the set of distinct ``cell_hash`` values of a
  column (order-free by construction);
* the row sample picks the ``samples`` rows with the smallest splitmix64
  key derived from the row's cell hashes and the seed;
* MinHash permutation parameters derive from the seed alone.

So a static build, an L0 delta, a compaction merge, a snapshot reload and a
rebuild produce the same sketch for the same live table.

Estimators and their bounds:

* **Containment (SC/KW)**: bottom-k KMV with deterministically sound
  bounds.  Every distinct hash ``<= tau`` (the K-th smallest) is retained,
  so with ``matched`` exact hits and ``n_above`` query hashes above tau,
  ``lo = matched <= true <= matched + n_above = hi`` always holds; the
  Wilson interval of the below-tau match rate is clipped into ``[lo, hi]``.
  A column with fewer than K distinct values is summarized losslessly: its
  interval is a point, the exact score.
* **Correlation (C)**: the QCR agreement probability estimated from the
  row sample joined against the query keys, a Wilson interval on
  ``p = P(quadrant agrees | row joins)`` transferred through ``|2p - 1|``.
  These bounds hold at the stated confidence only, so ``epsilon=0``
  always escalates C; the one sound fact used there is that a table whose
  join-side containment upper bound is zero cannot join (score 0).
* **MC** has no sketch estimator: approximate MC runs the exact path.
* ``kmv_union_size`` / ``minhash_jaccard``: the classic distinct-union and
  Jaccard estimators over the same sketches.

Probes run on the host over a sorted sketch-posting view (``SketchView``,
memoized per index epoch by the executor): ``|Q| + matches`` binary
searches and one scatter.  On a sharded lake each shard has its own view
and the probes merge by one elementwise sum, which is exact because each
table's slots are nonzero on exactly one shard.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, fields

import numpy as np

from repro_torch.core.hashing import MISSING

__all__ = [
    "SketchConfig", "TableSketch", "SketchView", "SketchProbeResult",
    "ApproxParams", "ApproxInfo", "sketch_tables", "build_view",
    "z_for", "kmv_union_size", "minhash_jaccard", "escalation_set",
]

DEFAULT_KMV_K = 128
DEFAULT_MINHASH_M = 32
DEFAULT_SAMPLES = 64

#: sample-side support floor mirroring the exact seekers' QCR min_support
SAMPLE_MIN_SUPPORT = 3


@dataclass(frozen=True)
class SketchConfig:
    """Sketch geometry.  Part of the index identity: two stores only produce
    bit-identical sketches under the same config (snapshot manifests carry
    it; ``from_dict`` restores it)."""
    k: int = DEFAULT_KMV_K            # KMV bottom-k size (power of two)
    minhash_m: int = DEFAULT_MINHASH_M
    samples: int = DEFAULT_SAMPLES    # row-sample size per table

    def as_dict(self) -> dict:
        return {"k": self.k, "minhash_m": self.minhash_m,
                "samples": self.samples}

    @classmethod
    def from_dict(cls, d) -> "SketchConfig":
        return cls(k=int(d["k"]), minhash_m=int(d["minhash_m"]),
                   samples=int(d["samples"]))


@dataclass(eq=False)
class TableSketch:
    """Fixed-size summary of one table (see module docstring)."""
    kmv: np.ndarray          # u32 [n_cols, K] sorted asc; MISSING pad
    kmv_m: np.ndarray        # i32 [n_cols] retained distinct count per col
    tbl_kmv: np.ndarray      # u32 [K] table-level KMV (distinct anywhere)
    tbl_m: int               # retained count of tbl_kmv
    minhash: np.ndarray      # u32 [n_cols, M]
    samp_rows: np.ndarray    # i32 [s] sampled row ids (key order)
    samp_hash: np.ndarray    # u32 [s, n_cols] cell hash at (row, col)
    samp_quad: np.ndarray    # i8  [s, n_cols] quadrant at (row, col)
    n_rows: int
    n_cols: int

    def nbytes(self) -> int:
        return (self.kmv.nbytes + self.kmv_m.nbytes + self.tbl_kmv.nbytes +
                self.minhash.nbytes + self.samp_rows.nbytes +
                self.samp_hash.nbytes + self.samp_quad.nbytes)


# --------------------------------------------------------------------------
# construction (host-side numpy; pure function of posting arrays + seed)
# --------------------------------------------------------------------------

_U64 = np.uint64


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):       # u64 wraparound is the point
        x = (x + _U64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
        return x ^ (x >> _U64(31))


_MINHASH_PARAMS: dict = {}


def _minhash_params(seed: int, m: int):
    """Global (a, b) multiply-shift parameters, derived from the seed alone
    so every table of every segment uses the same permutations."""
    got = _MINHASH_PARAMS.get((seed, m))
    if got is None:
        rng = np.random.default_rng([seed, 0x6D696E68])     # 'minh'
        a = rng.integers(1, 2 ** 62, size=m, dtype=np.uint64) * _U64(2) \
            + _U64(1)                                        # odd multipliers
        b = rng.integers(0, 2 ** 62, size=m, dtype=np.uint64)
        got = _MINHASH_PARAMS[(seed, m)] = (a, b)
    return got


def _row_sample_keys(hashes2d: np.ndarray, seed: int) -> np.ndarray:
    """Content-addressed row keys: splitmix64 folded over the row's cell
    hashes.  Independent of table id and build order; ties (identical rows)
    break by row id in the caller's stable argsort."""
    nc, nr = hashes2d.shape
    acc = np.full(nr, _splitmix64(np.asarray(
        seed & 0xFFFFFFFFFFFFFFFF, np.uint64)), np.uint64)
    for c in range(nc):
        acc = _splitmix64(
            acc ^ (hashes2d[c].astype(np.uint64) +
                   _U64((0x9E3779B97F4A7C15 * (c + 1)) &
                        0xFFFFFFFFFFFFFFFF)))
    return acc


def sketch_tables(parts: dict, seed: int = 0,
                  config: SketchConfig | None = None) -> dict:
    """Per-table sketches from (unsorted OK) posting arrays.

    ``parts`` is a posting dict (``core.index.POSTING_KEYS`` layout); the
    arrays are canonically re-ordered by (table, col, row) internally, so
    the result is identical no matter which segment/merge order produced
    them.  Returns ``{global_table_id: TableSketch}`` — tables with no
    postings (zero columns) are absent, exactly as they are invisible to
    the exact seekers."""
    cfg = config or SketchConfig()
    K, M, S = cfg.k, cfg.minhash_m, cfg.samples
    ch, tid = np.asarray(parts["cell_hash"]), np.asarray(parts["table_id"])
    cid, rid = np.asarray(parts["col_id"]), np.asarray(parts["row_id"])
    quad = np.asarray(parts["quadrant"])
    out: dict = {}
    if not len(ch):
        return out
    order = np.lexsort((rid, cid, tid))
    ch, tid, cid, rid, quad = (a[order] for a in (ch, tid, cid, rid, quad))
    bounds = np.flatnonzero(np.diff(tid)) + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(tid)]])
    a_mh, b_mh = _minhash_params(seed, M)
    for s0, s1 in zip(starts, ends):
        t = int(tid[s0])
        nc = int(cid[s1 - 1]) + 1
        nr = (s1 - s0) // nc
        # LiveLake invariant: a table's postings are complete per column
        # (every cell posted), so the canonical order is a dense grid
        hashes2d = ch[s0:s1].reshape(nc, nr)
        quads2d = quad[s0:s1].reshape(nc, nr)
        kmv = np.full((nc, K), MISSING, np.uint32)
        kmv_m = np.zeros(nc, np.int32)
        minhash = np.zeros((nc, M), np.uint32)
        for c in range(nc):
            u = np.unique(hashes2d[c])
            m = min(len(u), K)
            kmv[c, :m] = u[:m]
            kmv_m[c] = m
            perm = (a_mh[None, :] * u.astype(np.uint64)[:, None] + b_mh)
            minhash[c] = (perm.min(axis=0) >> _U64(32)).astype(np.uint32)
        ut = np.unique(hashes2d)
        tm = min(len(ut), K)
        tbl_kmv = np.full(K, MISSING, np.uint32)
        tbl_kmv[:tm] = ut[:tm]
        keys = _row_sample_keys(hashes2d, seed)
        sel = np.argsort(keys, kind="stable")[: min(S, nr)]
        out[t] = TableSketch(
            kmv=kmv, kmv_m=kmv_m, tbl_kmv=tbl_kmv, tbl_m=tm,
            minhash=minhash, samp_rows=sel.astype(np.int32),
            samp_hash=hashes2d[:, sel].T.copy(),
            samp_quad=quads2d[:, sel].T.copy(), n_rows=nr, n_cols=nc)
    return out


# --------------------------------------------------------------------------
# sorted sketch-posting view (executor-side, epoch-memoized by the caller)
# --------------------------------------------------------------------------

@dataclass(eq=False)
class SketchView:
    """Sketches flattened into sorted host-side posting arrays.

    Three mini posting lists mirror the exact index's layout, but over
    fixed-size summaries: column-level KMV values (SC), table-level KMV
    values (KW), and sampled cell hashes (C).  A probe binary-searches the
    query hashes into the sorted array and scatter-counts the matched
    owners, so probe cost scales with matches — not tables x cols x K.

    Dead/absent table slots simply have no postings and a ``tau`` of
    MISSING (everything counts as "below tau", ``n_above == 0``), so every
    bound degenerates to the exact score 0 and per-shard views sum exactly.
    """
    # column-level KMV postings: slot = t * max_cols + c
    col_hash: np.ndarray        # u32 [Nc] sorted retained values
    col_owner: np.ndarray       # i32 [Nc]
    col_tau_order: np.ndarray   # i64 [T * max_cols] argsort of tau
    col_tau_sorted: np.ndarray  # u32 [T * max_cols]
    # table-level KMV postings: slot = t
    tbl_hash: np.ndarray        # u32 [Nt] sorted
    tbl_owner: np.ndarray       # i32 [Nt]
    tbl_tau_order: np.ndarray   # i64 [T]
    tbl_tau_sorted: np.ndarray  # u32 [T]
    # row-sample postings: every sampled cell, sorted by hash
    samp_hash: np.ndarray       # u32 [Ns] sorted
    samp_tbl: np.ndarray        # i32 [Ns]
    samp_row: np.ndarray        # i32 [Ns] sample-slot index (not row id)
    samp_col: np.ndarray        # i32 [Ns]
    samp_quad: np.ndarray       # i8  [T, S, max_cols]; -1 pads
    config: SketchConfig
    n_tables: int
    max_cols: int

    # ---------------------------------------------------------- containment
    def containment(self, qh: np.ndarray, z: float, level: str = "col"):
        """Bottom-k containment bounds per table, maxed over columns
        (``level="col"``, the SC score shape) or against the table-level
        KMV (``level="tbl"``, KW).  ``qh`` must be sorted distinct u32
        (``np.unique`` output) — the exact seekers are COUNT(DISTINCT), so
        distinct-counting *is* the exact semantics.  Returns five f32
        [n_tables] arrays ``(bound_lo, bound_hi, est, ci_lo, ci_hi)`` with
        ``bound_lo <= exact <= bound_hi`` deterministic and ``[ci_lo,
        ci_hi]`` the Wilson interval at the confidence behind ``z``."""
        if level == "col":
            hash_s, owner = self.col_hash, self.col_owner
            tau_order, tau_sorted = self.col_tau_order, self.col_tau_sorted
            n_slots, ncols = self.n_tables * self.max_cols, self.max_cols
        else:
            hash_s, owner = self.tbl_hash, self.tbl_owner
            tau_order, tau_sorted = self.tbl_tau_order, self.tbl_tau_sorted
            n_slots, ncols = self.n_tables, 1
        matched = _match_counts(hash_s, owner, n_slots, qh)
        m_below = _count_below(tau_order, tau_sorted, qh)
        outs = _containment_bounds(matched, m_below, float(len(qh)), z)
        return tuple(a.reshape(self.n_tables, ncols).max(axis=1)
                     for a in outs)

    # ---------------------------------------------------------- correlation
    def correlation(self, qh: np.ndarray, qbit: np.ndarray, z: float,
                    min_support: int):
        """Row-sample QCR estimate per table: binomial CI on the agreement
        probability over sampled joined rows, transferred through |2p - 1|
        and maxed over (join col, numeric col) pairs.  ``qh`` sorted
        distinct u32, ``qbit`` the query-side quadrant bit per hash.
        Returns f32 [n_tables] ``(est, ci_lo, ci_hi, support)`` with
        support = best pair's sampled join count (0 => no estimate)."""
        T, C = self.n_tables, self.max_cols
        lo = np.searchsorted(self.samp_hash, qh, side="left")
        hi = np.searchsorted(self.samp_hash, qh, side="right")
        counts = hi - lo
        zero = tuple(np.zeros(T, np.float32) for _ in range(4))
        if not counts.sum():
            return zero
        pos = np.concatenate([np.arange(l, h)
                              for l, h in zip(lo, hi) if h > l])
        qb_m = np.repeat(qbit, counts)
        t_m, s_m = self.samp_tbl[pos], self.samp_row[pos]
        c_m = self.samp_col[pos]
        quad_rows = self.samp_quad[t_m, s_m]           # [M, C]
        isnum = quad_rows >= 0
        agree = isnum & (quad_rows == qb_m[:, None])
        base = (t_m.astype(np.int64) * C + c_m) * C
        cell = (base[:, None] + np.arange(C, dtype=np.int64)[None, :])
        cell = cell.reshape(-1)
        n_all_flat = np.bincount(cell, weights=isnum.reshape(-1),
                                 minlength=T * C * C)
        n_agree_flat = np.bincount(cell, weights=agree.reshape(-1),
                                   minlength=T * C * C)
        # the Wilson math and the per-table max only touch the (join col,
        # num col) pairs that actually have enough sampled joins — a tiny
        # subset of the dense [T, C, C] grid
        ok = np.flatnonzero(n_all_flat >= min_support)
        if not ok.size:
            return zero
        n_all = n_all_flat[ok]
        p = n_agree_flat[ok] / n_all
        est_pair = np.abs(2.0 * p - 1.0)
        # Wilson score interval on the agreement rate (Wald under-covers at
        # the small sampled-join counts min_support admits) + 0.5/n
        # continuity, transferred through |2p - 1|
        z2 = z * z
        dw = 1.0 + z2 / n_all
        center = (p + z2 / (2.0 * n_all)) / dw
        se_w = np.sqrt(p * (1.0 - p) / n_all
                       + z2 / (4.0 * n_all * n_all)) / dw
        half_p = z * se_w + 0.5 / n_all
        pl = np.clip(np.minimum(center - half_p, p), 0.0, 1.0)
        ph = np.clip(np.maximum(center + half_p, p), 0.0, 1.0)
        el = np.abs(2.0 * pl - 1.0)
        eh = np.abs(2.0 * ph - 1.0)
        spans_half = (pl <= 0.5) & (ph >= 0.5)
        lo_pair = np.where(spans_half, 0.0, np.minimum(el, eh))
        hi_pair = np.maximum(el, eh)
        t_ok = (ok // (C * C)).astype(np.int64)
        out = []
        for vals in (est_pair, lo_pair, hi_pair, n_all):
            acc = np.zeros(T, np.float64)
            np.maximum.at(acc, t_ok, vals)
            out.append(acc.astype(np.float32))
        return tuple(out)


def build_view(sketches: dict, n_tables: int, max_cols: int,
               config: SketchConfig, alive=None) -> SketchView:
    """Flatten per-table sketches into the sorted posting view.  ``alive``
    masks out tombstoned tables (their segment sketches still exist but
    must not answer queries).  O(total sketch cells log) — paid once per
    index epoch, like the exact tier's device pack."""
    K, S = config.k, config.samples
    col_tau = np.full(n_tables * max_cols, MISSING, np.uint32)
    tbl_tau = np.full(n_tables, MISSING, np.uint32)
    samp_quad = np.full((n_tables, S, max_cols), -1, np.int8)
    col_h, col_o = [], []
    tbl_h, tbl_o = [], []
    sm_h, sm_t, sm_s, sm_c = [], [], [], []
    for t, sk in sketches.items():
        if t >= n_tables or (alive is not None and not alive[t]):
            continue
        nc = min(sk.n_cols, max_cols)
        for c in range(nc):
            m = int(sk.kmv_m[c])
            col_h.append(sk.kmv[c, :m])
            col_o.append(np.full(m, t * max_cols + c, np.int32))
            if m == K:                    # saturated: tau = K-th smallest
                col_tau[t * max_cols + c] = sk.kmv[c, K - 1]
        tbl_h.append(sk.tbl_kmv[:sk.tbl_m])
        tbl_o.append(np.full(sk.tbl_m, t, np.int32))
        if sk.tbl_m == K:
            tbl_tau[t] = sk.tbl_kmv[K - 1]
        s = len(sk.samp_rows)
        samp_quad[t, :s, :nc] = sk.samp_quad[:, :nc]
        sh = sk.samp_hash[:, :nc]                       # [s, nc]
        sm_h.append(sh.reshape(-1))
        sm_t.append(np.full(s * nc, t, np.int32))
        sm_s.append(np.repeat(np.arange(s, dtype=np.int32), nc))
        sm_c.append(np.tile(np.arange(nc, dtype=np.int32), s))

    def _sorted(hs, os):
        h = (np.concatenate(hs) if hs else np.empty(0, np.uint32))
        o = (np.concatenate(os) if os else np.empty(0, np.int32))
        order = np.argsort(h, kind="stable")
        return h[order], o[order]

    col_hash, col_owner = _sorted(col_h, col_o)
    tbl_hash, tbl_owner = _sorted(tbl_h, tbl_o)
    s_hash = (np.concatenate(sm_h) if sm_h else np.empty(0, np.uint32))
    s_order = np.argsort(s_hash, kind="stable")
    cat = lambda xs: (np.concatenate(xs) if xs       # noqa: E731
                      else np.empty(0, np.int32))
    col_tau_order = np.argsort(col_tau, kind="stable")
    tbl_tau_order = np.argsort(tbl_tau, kind="stable")
    return SketchView(
        col_hash=col_hash, col_owner=col_owner,
        col_tau_order=col_tau_order, col_tau_sorted=col_tau[col_tau_order],
        tbl_hash=tbl_hash, tbl_owner=tbl_owner,
        tbl_tau_order=tbl_tau_order, tbl_tau_sorted=tbl_tau[tbl_tau_order],
        samp_hash=s_hash[s_order], samp_tbl=cat(sm_t)[s_order],
        samp_row=cat(sm_s)[s_order], samp_col=cat(sm_c)[s_order],
        samp_quad=samp_quad, config=config, n_tables=n_tables,
        max_cols=max_cols)


# --------------------------------------------------------------------------
# normal quantile (no scipy): Acklam's rational approximation of Phi^-1
# --------------------------------------------------------------------------

_ACK_A = (-3.969683028665376e+01, 2.209460984245205e+02,
          -2.759285104469687e+02, 1.383577518672690e+02,
          -3.066479806614716e+01, 2.506628277459239e+00)
_ACK_B = (-5.447609879822406e+01, 1.615858368580409e+02,
          -1.556989798598866e+02, 6.680131188771972e+01,
          -1.328068155288572e+01)
_ACK_C = (-7.784894002430293e-03, -3.223964580411365e-01,
          -2.400758277161838e+00, -2.549732539343734e+00,
          4.374664141464968e+00, 2.938163982698783e+00)
_ACK_D = (7.784695709041462e-03, 3.224671290700398e-01,
          2.445134137142996e+00, 3.754408661907416e+00)


def _norm_ppf(p: float) -> float:
    if not 0.0 < p < 1.0:
        raise ValueError(f"quantile {p} outside (0, 1)")
    a, b, c, d = _ACK_A, _ACK_B, _ACK_C, _ACK_D
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
                + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        return -_norm_ppf(1 - p)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
            + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r
                            + b[4]) * r + 1)


def z_for(confidence: float, comparisons: int = 1) -> float:
    """Two-sided normal critical value at ``confidence``, Bonferroni-split
    over ``comparisons`` simultaneous intervals (a table score is a max over
    columns / column pairs, so its per-component intervals must hold
    jointly)."""
    if not 0.0 < confidence < 1.0:
        raise ValueError(f"confidence {confidence} outside (0, 1)")
    alpha = (1.0 - confidence) / max(comparisons, 1)
    return _norm_ppf(1.0 - alpha / 2.0)


# --------------------------------------------------------------------------
# host probe primitives (binary search + scatter over the sorted view)
# --------------------------------------------------------------------------

def _match_counts(hash_sorted: np.ndarray, owner: np.ndarray, n_slots: int,
                  qh: np.ndarray) -> np.ndarray:
    """matched[slot] = |Q ∩ retained(slot)| for sorted distinct ``qh``:
    2|Q| binary searches into the posting array, then one bincount over the
    matched owners — O(|Q| log N + matches)."""
    lo = np.searchsorted(hash_sorted, qh, side="left")
    hi = np.searchsorted(hash_sorted, qh, side="right")
    if not (hi - lo).sum():
        return np.zeros(n_slots, np.float64)
    pos = np.concatenate([np.arange(l, h) for l, h in zip(lo, hi) if h > l])
    return np.bincount(owner[pos], minlength=n_slots).astype(np.float64)


def _count_below(tau_order: np.ndarray, tau_sorted: np.ndarray,
                 qh: np.ndarray) -> np.ndarray:
    """m_below[slot] = |{q in Q : q <= tau[slot]}| for every slot at once
    without a per-slot search: bucket the |Q| query hashes into the sorted
    tau array, histogram, cumulative-sum, unsort — O(|Q| log S + S)."""
    S = tau_sorted.shape[0]
    p = np.searchsorted(tau_sorted, qh, side="left")
    below_sorted = np.cumsum(np.bincount(p, minlength=S + 1)[:S])
    m_below = np.empty(S, np.float64)
    m_below[tau_order] = below_sorted
    return m_below


def _containment_bounds(matched: np.ndarray, m_below: np.ndarray,
                        nq_real: float, z: float):
    """Per-slot containment bounds from the sound match/below-tau counts.

    Returns (bound_lo, bound_hi, est, ci_lo, ci_hi) f32 arrays:
    ``bound_lo = matched <= true <= matched + n_above = bound_hi``
    deterministically; ``[ci_lo, ci_hi]`` is the binomial-extrapolation
    interval clipped into those sound bounds.  A slot whose sketch is
    lossless (``n_above == 0``) has the point interval [matched, matched];
    the Wilson math only runs on the saturated subset, which keeps the
    probe cheap when most columns fit inside K."""
    n_above_all = nq_real - m_below
    lo32 = matched.astype(np.float32)
    hi32 = (matched + n_above_all).astype(np.float32)
    est32, ci_lo32, ci_hi32 = lo32.copy(), lo32.copy(), lo32.copy()
    sat = np.flatnonzero(n_above_all > 0)
    if sat.size:
        m, n_above = matched[sat], n_above_all[sat]
        denom = np.maximum(m_below[sat], 1.0)
        p = m / denom
        est = m + p * n_above
        # Wilson score interval on the below-tau containment rate (the
        # plain Wald interval under-covers badly at the m_below ~ tens this
        # regime produces), plus the binomial realization noise of the
        # above-tau count itself — the truth fluctuates around p * n_above
        # even at known p
        z2 = z * z
        dw = 1.0 + z2 / denom
        center = (p + z2 / (2.0 * denom)) / dw
        se_w = np.sqrt(p * (1.0 - p) / denom
                       + z2 / (4.0 * denom * denom)) / dw
        half = z * np.sqrt(se_w * se_w * n_above * n_above
                           + center * (1.0 - center) * n_above) + 1.0
        mid = m + center * n_above
        est32[sat] = est.astype(np.float32)
        ci_lo32[sat] = np.clip(np.minimum(mid - half, est),
                               m, m + n_above).astype(np.float32)
        ci_hi32[sat] = np.clip(np.maximum(mid + half, est),
                               m, m + n_above).astype(np.float32)
    return lo32, hi32, est32, ci_lo32, ci_hi32


# --------------------------------------------------------------------------
# library estimators over raw sketches (coverage suite / examples)
# --------------------------------------------------------------------------

def kmv_union_size(kmv_a: np.ndarray, m_a: int, kmv_b: np.ndarray, m_b: int,
                   k: int, confidence: float = 0.95):
    """Distinct-count estimate of the union of two sketched value sets.

    Merging two bottom-k KMV sketches yields the bottom-k sketch of the
    union; if both inputs retained every distinct hash the union size is
    exact (zero-width interval), otherwise the classic (K-1)/tau estimator
    with relative standard error ~ 1/sqrt(K-2) at the stated confidence.
    Returns ``(est, ci_lo, ci_hi)``."""
    merged = np.unique(np.concatenate([kmv_a[:m_a], kmv_b[:m_b]]))
    exact = m_a < k and m_b < k        # both sides losslessly summarized
    n_seen = len(merged)
    if exact or n_seen < k:
        return float(n_seen), float(n_seen), float(n_seen)
    tau = float(merged[k - 1]) + 1.0
    est = (k - 1) / (tau / 2.0 ** 32)
    rel = z_for(confidence) / math.sqrt(max(k - 2, 1))
    lo = max(float(n_seen), est * (1.0 - rel))
    return est, lo, est * (1.0 + rel) + 1.0


def minhash_jaccard(sig_a: np.ndarray, sig_b: np.ndarray,
                    confidence: float = 0.95):
    """Jaccard similarity from MinHash signatures: collision-rate estimate
    with a binomial CI over the M independent permutations.  Returns
    ``(est, ci_lo, ci_hi)``."""
    sig_a, sig_b = np.asarray(sig_a), np.asarray(sig_b)
    m = len(sig_a)
    p = float(np.mean(sig_a == sig_b))
    half = z_for(confidence) * math.sqrt(p * (1.0 - p) / m) + 0.5 / m
    return p, max(0.0, p - half), min(1.0, p + half)


# --------------------------------------------------------------------------
# approx query surface: params, probe result, escalation rule
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ApproxParams:
    """The epsilon/confidence contract of ``Session.query(approx=...)``.

    * ``epsilon`` — ranking tolerance.  A top-k contender whose interval is
      wider than epsilon (relative to its upper bound for the count-valued
      SC/KW estimators, absolute for the [0,1]-valued correlation score)
      escalates to the exact path.  ``epsilon=0`` therefore returns ids
      bit-identical to the exact path.
    * ``confidence`` — nominal coverage of the reported per-hit intervals
      (and, for C, of the escalation bounds themselves)."""
    epsilon: float = 0.05
    confidence: float = 0.95

    def key(self) -> tuple:
        return (round(float(self.epsilon), 12),
                round(float(self.confidence), 12))

    @classmethod
    def of(cls, approx) -> "ApproxParams | None":
        """Normalize the ``approx=`` argument: False/None -> None, True ->
        defaults, a dict/ApproxParams -> explicit parameters."""
        if approx is None or approx is False:
            return None
        if approx is True:
            return cls()
        if isinstance(approx, cls):
            return approx
        if isinstance(approx, dict):
            unknown = set(approx) - {"epsilon", "confidence"}
            if unknown:
                raise ValueError(f"unknown approx parameters {sorted(unknown)}"
                                 f" (expected epsilon/confidence)")
            return cls(epsilon=float(approx.get("epsilon", 0.05)),
                       confidence=float(approx.get("confidence", 0.95)))
        raise TypeError(f"approx must be bool/dict/ApproxParams, "
                        f"got {type(approx)!r}")


@dataclass
class SketchProbeResult:
    """Host-side per-table estimates of one seeker's scores.

    ``bound_lo <= exact <= bound_hi`` holds deterministically for SC/KW and
    at the stated confidence for C (``sound=False``); ``[ci_lo, ci_hi]`` is
    the reported interval at the stated confidence."""
    kind: str
    estimator: str
    est: np.ndarray          # f32 [n_tables]
    bound_lo: np.ndarray
    bound_hi: np.ndarray
    ci_lo: np.ndarray
    ci_hi: np.ndarray
    sound: bool
    seconds: float = 0.0
    launches: int = 0        # device-program dispatches (0: host-side probe)
    #: C only: sound join-impossibility mask (containment upper bound == 0)
    impossible: np.ndarray | None = None


@dataclass
class ApproxInfo:
    """What the approximate path did for one query (``QueryResult.approx``,
    surfaced through ``DiscoveryResponse.approx``)."""
    params: ApproxParams
    kind: str
    estimator: str
    escalated: int            # tables resolved on the exact path
    candidates: int           # tables whose upper bound reached the top-k bar
    threshold: float          # the k-th largest lower bound
    est: np.ndarray = field(repr=False, default=None)
    ci_lo: np.ndarray = field(repr=False, default=None)
    ci_hi: np.ndarray = field(repr=False, default=None)
    escalated_ids: list = field(default_factory=list)
    fallback: str | None = None    # why the exact path ran wholesale
    probe_seconds: float = 0.0

    def interval(self, table_id: int) -> tuple:
        """(estimate, ci_lo, ci_hi) for one table id."""
        t = int(table_id)
        return (float(self.est[t]), float(self.ci_lo[t]),
                float(self.ci_hi[t]))

    def as_dict(self, ids=None) -> dict:
        d = {"epsilon": self.params.epsilon,
             "confidence": self.params.confidence, "kind": self.kind,
             "estimator": self.estimator, "escalated": self.escalated,
             "candidates": self.candidates, "threshold": self.threshold,
             "fallback": self.fallback,
             "probe_seconds": self.probe_seconds}
        if ids is not None and self.est is not None:
            d["estimates"] = {int(t): {"est": float(self.est[int(t)]),
                                       "ci_lo": float(self.ci_lo[int(t)]),
                                       "ci_hi": float(self.ci_hi[int(t)])}
                              for t in ids}
        return d


def escalation_set(probe: SketchProbeResult, k: int,
                   params: ApproxParams) -> tuple:
    """The contended boundary of the ranking: table ids to resolve exactly.

    ``T`` = k-th largest lower bound.  A table escalates iff its upper
    bound reaches ``T`` (it could displace the provisional top-k) AND its
    interval is wider than epsilon.  With ``epsilon > 0`` the contract is
    statistical, so the bounds are the confidence intervals; with
    ``epsilon=0`` the deterministic bounds take over (for SC/KW the sound
    sandwich, for C the sound [0, possible] envelope) and every
    non-degenerate contender escalates, which makes the final ids
    bit-identical to the exact path (non-contenders are provably below the
    bar; degenerate intervals ARE the exact score).  Returns
    ``(escalate_ids, candidates, threshold)``."""
    eps = float(params.epsilon)
    if eps > 0:
        lo, hi = probe.ci_lo, probe.ci_hi
    elif probe.sound:
        lo, hi = probe.bound_lo, probe.bound_hi
    else:
        lo = np.zeros_like(probe.bound_lo)
        hi = np.where(probe.impossible, 0.0, 1.0).astype(np.float32)
    n = len(lo)
    kk = min(max(k, 1), n)
    thresh = float(np.partition(lo, n - kk)[n - kk])
    width = hi - lo
    if probe.kind == "C":
        wide = width > eps                       # absolute: QCR lives in [0,1]
    else:
        wide = width > eps * np.maximum(hi, 1.0)  # relative: count-valued
    esc = (hi >= thresh) & (hi > 0) & wide
    cand = int(np.count_nonzero((hi >= thresh) & (hi > 0)))
    return np.flatnonzero(esc), cand, thresh


def copy_sketches(sketches: dict) -> dict:
    """``{table id: TableSketch}`` rebuilt field by field from another
    index's sketches (for example the JAX package's), arrays copied, so an
    index handed them keeps none of the other system's objects."""
    names = [f.name for f in fields(TableSketch)]
    return {int(t): TableSketch(**{
        n: getattr(s, n).copy() if isinstance(getattr(s, n), np.ndarray)
        else int(getattr(s, n)) for n in names})
        for t, s in sketches.items()}
