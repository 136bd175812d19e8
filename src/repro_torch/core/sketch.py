"""Sketch tier, build half: per-table KMV / MinHash / row-sample sketches.

Every segment build of a live lake (store/segments.py
``segment_from_arrays``) computes its tables' sketches here, and a
snapshot's manifest records the ``SketchConfig``, exactly as the JAX
package's ``repro.core.sketch`` does, so the two systems hold bit-identical
sketches for the same live tables.

Determinism contract: a table's sketch is a pure function of its posting
arrays, the store seed and the ``SketchConfig`` — never of build order,
table id or segment layout:

* KMV / MinHash summarize the set of distinct ``cell_hash`` values of a
  column (order-free by construction);
* the row sample picks the ``samples`` rows with the smallest splitmix64
  key derived from the row's cell hashes and the seed;
* MinHash permutation parameters derive from the seed alone.

So an L0 delta, a compaction merge, a snapshot reload and a rebuild produce
the same sketch for the same live table.  The probe half (sketch views,
estimators and the approximate query path) comes with the approximate
tier.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.hashing import MISSING

DEFAULT_KMV_K = 128
DEFAULT_MINHASH_M = 32
DEFAULT_SAMPLES = 64


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

