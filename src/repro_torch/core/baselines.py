"""Standalone discovery systems + federated pipelines (the paper's baselines).

Each baseline owns its *own* index structures (the paper's storage argument —
Table VIII) and runs as an isolated system; complex tasks federate them with
application-level glue, which is exactly what BLEND's unified index +
optimizer beat in Table III.

* ``JosieLike``   — single-column join search: per-value posting lists keyed
                    by (table, column) sets (JOSIE's token->sets index).
* ``MateLike``    — multi-column join: its own inverted index + XASH column,
                    candidate fetch in the "DB" (vectorized) but row-by-row
                    exact validation in application code (the paper's noted
                    bottleneck), no intermediate-result filters.
* ``QcrLike``     — correlation sketch index: per (table, join_col, num_col)
                    pair, the h smallest-hash (key, quadrant) sketch entries,
                    materialized offline (fixed h — resizing requires
                    re-indexing, unlike BLEND's query-time h).
* ``UnionBaseline`` — per-column domain-signature overlap (Starmie stand-in:
                    no contrastive model offline, but the same evaluation
                    interface; documented as a syntactic proxy).

A line-for-line copy of the JAX package's ``core/baselines.py`` (host
NumPy over the port's own ``core/hashing`` and ``core/lake``): ``query``
and ``storage_bytes`` return exactly what the JAX package's do.
"""
from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

from repro_torch.core.hashing import hash_array, hash_value
from repro_torch.core.lake import DataLake


class JosieLike:
    """Token -> list[(table, col)] posting dict; query = multiset overlap."""

    def __init__(self, lake: DataLake):
        self.postings: dict[int, set] = defaultdict(set)
        for t, tab in enumerate(lake.tables):
            for c, col in enumerate(tab.columns):
                for h in hash_array(col):
                    self.postings[int(h)].add((t, c))
        self.n_tables = lake.n_tables

    def storage_bytes(self) -> int:
        n = sum(len(v) for v in self.postings.values())
        return len(self.postings) * 12 + n * 8

    def query(self, values, k=10):
        scores = defaultdict(set)
        for v in values:
            for (t, c) in self.postings.get(hash_value(v), ()):
                scores[(t, c)].add(hash_value(v))
        table_best = defaultdict(int)
        for (t, c), s in scores.items():
            table_best[t] = max(table_best[t], len(s))
        ranked = sorted(table_best.items(), key=lambda kv: -kv[1])[:k]
        return [t for t, s in ranked if s > 0]


class MateLike:
    """Inverted index + XASH superkeys; app-level row validation."""

    def __init__(self, lake: DataLake):
        from repro_torch.core.hashing import superkeys_for_rows
        self.lake = lake
        self.postings: dict[int, list] = defaultdict(list)
        self.rows: dict[tuple, list] = {}
        self.superkeys: dict[tuple, int] = {}
        for t, tab in enumerate(lake.tables):
            col_hashes = [hash_array(col) for col in tab.columns]
            all_h = np.concatenate(col_hashes)
            all_r = np.tile(np.arange(tab.n_rows), tab.n_cols)
            sks = superkeys_for_rows(all_h, np.zeros_like(all_h), all_r,
                                     tab.n_rows)
            for r in range(tab.n_rows):
                self.rows[(t, r)] = [int(ch[r]) for ch in col_hashes]
                self.superkeys[(t, r)] = int(sks[r])
            for c, ch in enumerate(col_hashes):
                for r, h in enumerate(ch):
                    self.postings[int(h)].append((t, c, r))

    def storage_bytes(self) -> int:
        n = sum(len(v) for v in self.postings.values())
        return len(self.postings) * 12 + n * 12 + len(self.superkeys) * 16

    def query(self, tuples, k=10, allowed=None, count_fps=False):
        """Returns (top-k table ids, n_validated_rows, tp, fp)."""
        from repro_torch.core.hashing import row_superkey
        tp = fp = validated = 0
        matched = defaultdict(set)
        for qi, tup in enumerate(tuples):
            hs = np.array([hash_value(v) for v in tup], np.uint32)
            qk = int(row_superkey(hs, np.zeros(len(tup), np.int64)))
            # candidate rows from the first value's postings (no initiator
            # frequency optimization — that's BLEND's planner)
            cands = self.postings.get(int(hs[0]), ())
            seen = set()
            for (t, c, r) in cands:
                if (t, r) in seen:
                    continue
                seen.add((t, r))
                if allowed is not None and t not in allowed:
                    continue
                if (self.superkeys[(t, r)] & qk) != qk:
                    continue
                # application-level exact validation, row by row
                validated += 1
                row = self.rows[(t, r)]
                if all(int(h) in row for h in hs):
                    matched[t].add(qi)
                    tp += 1
                else:
                    fp += 1
        ranked = sorted(matched.items(), key=lambda kv: -len(kv[1]))[:k]
        return [t for t, _ in ranked], validated, tp, fp


class QcrLike:
    """Offline per-(table, join_col, num_col) sketches of the h smallest
    (hash(key), quadrant) pairs — fixed h at build time."""

    def __init__(self, lake: DataLake, h: int = 256):
        self.h = h
        self.sketches: dict[tuple, list] = {}
        for t, tab in enumerate(lake.tables):
            numeric = []
            for c, col in enumerate(tab.columns):
                try:
                    vals = np.array([float(v) for v in col])
                except (TypeError, ValueError):
                    continue
                numeric.append((c, vals >= vals.mean()))
            for cj, col in enumerate(tab.columns):
                if any(cj == c for c, _ in numeric):
                    continue     # baseline: categorical join keys only
                key_hashes = hash_array(col)
                order = np.argsort(key_hashes)[: self.h]
                for cn, quad in numeric:
                    self.sketches[(t, cj, cn)] = [
                        (int(key_hashes[i]), bool(quad[i])) for i in order]

    def storage_bytes(self) -> int:
        return sum(len(v) for v in self.sketches.values()) * 5 + \
            len(self.sketches) * 24

    def query(self, join_values, target_values, k=10, allowed=None):
        tgt = np.array([float(v) for v in target_values])
        qbit = tgt >= tgt.mean()
        qmap = {hash_value(v): bool(b) for v, b in zip(join_values, qbit)}
        scores = {}
        for (t, cj, cn), entries in self.sketches.items():
            if allowed is not None and t not in allowed:
                continue
            n = agree = 0
            for h, b in entries:
                if h in qmap:
                    n += 1
                    agree += int(qmap[h] == b)
            if n >= 3:
                qcr = abs(2 * agree - n) / n
                scores[t] = max(scores.get(t, 0.0), qcr)
        ranked = sorted(scores.items(), key=lambda kv: -kv[1])[:k]
        return [t for t, _ in ranked]


class UnionBaseline:
    """Per-table column domain signatures; union score = best greedy column
    matching overlap (syntactic Starmie stand-in)."""

    def __init__(self, lake: DataLake, sig_size: int = 64):
        self.sig_size = sig_size
        self.sigs = []
        for tab in lake.tables:
            cols = []
            for col in tab.columns:
                hs = sorted(int(h) for h in set(hash_array(col)))[:sig_size]
                cols.append(set(hs))
            self.sigs.append(cols)

    def storage_bytes(self) -> int:
        return sum(len(s) for cols in self.sigs for s in cols) * 8

    def query(self, table_idx: int, k=10):
        q_cols = self.sigs[table_idx]
        scores = []
        for t, cols in enumerate(self.sigs):
            if t == table_idx:
                scores.append(-1.0)
                continue
            total = 0.0
            used = set()
            for qc in q_cols:
                best, best_c = 0.0, None
                for c, cc in enumerate(cols):
                    if c in used or not qc or not cc:
                        continue
                    ov = len(qc & cc) / len(qc | cc)
                    if ov > best:
                        best, best_c = ov, c
                if best_c is not None:
                    used.add(best_c)
                    total += best
            scores.append(total)
        order = np.argsort(-np.array(scores))[:k]
        return [int(t) for t in order if scores[t] > 0]
