"""Data-lake containers + seeded synthetic lake generators with ground truth.

Tables hold columns as python lists / numpy arrays of mixed values (strings,
ints, floats, None).  Generators mirror the paper's benchmark settings:
joinable lakes (JOSIE / Fig 5), multi-column joinable rows (MATE / Table V),
unionable clusters (Starmie / Table VI), correlation lakes (QCR / Table VII),
and imputation scenarios (Table III).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Table:
    name: str
    columns: list            # list of 1-D value sequences (same length)
    col_names: list = field(default_factory=list)

    def __post_init__(self):
        if not self.col_names:
            self.col_names = [f"c{i}" for i in range(len(self.columns))]

    @property
    def n_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def n_cols(self) -> int:
        return len(self.columns)

    def row(self, r: int):
        return [c[r] for c in self.columns]


@dataclass
class DataLake:
    tables: list

    @property
    def n_tables(self) -> int:
        return len(self.tables)

    def __getitem__(self, i: int) -> Table:
        return self.tables[i]

    def stats(self) -> dict:
        return {"tables": self.n_tables,
                "columns": sum(t.n_cols for t in self.tables),
                "rows": sum(t.n_rows for t in self.tables)}


def _vocab(rng, size):
    return [f"tok_{i}" for i in range(size)]


def synthetic_lake(n_tables=100, rows=40, cols=4, vocab=2000, seed=0,
                   numeric_cols=1) -> DataLake:
    """Generic lake: categorical columns from a shared vocabulary + numeric
    columns (so every seeker has work to do)."""
    rng = np.random.default_rng(seed)
    voc = _vocab(rng, vocab)
    tables = []
    for t in range(n_tables):
        nr = int(rng.integers(max(4, rows // 2), rows + 1))
        columns = []
        for c in range(cols - numeric_cols):
            columns.append([voc[i] for i in rng.integers(0, vocab, nr)])
        for c in range(numeric_cols):
            columns.append(list(np.round(rng.normal(0, 10, nr), 3)))
        tables.append(Table(f"t{t}", columns))
    return DataLake(tables)


def joinable_lake(n_tables=200, rows=50, vocab=5000, overlap_levels=10, seed=0):
    """Lake with controlled single-column overlap against a query column.

    Returns (lake, query_values, ground_truth) where ground_truth[t] = number
    of distinct query values appearing in some single column of table t.
    """
    rng = np.random.default_rng(seed)
    voc = _vocab(rng, vocab)
    q_size = 40
    query = [voc[i] for i in rng.choice(vocab, q_size, replace=False)]
    tables, truth = [], np.zeros(n_tables, np.int32)
    for t in range(n_tables):
        n_overlap = int(rng.integers(0, min(q_size, overlap_levels * 4)))
        chosen = list(rng.choice(q_size, n_overlap, replace=False))
        col = [query[i] for i in chosen]
        col += [voc[i] for i in rng.integers(0, vocab, rows - len(col))]
        rng.shuffle(col)
        other = [voc[i] for i in rng.integers(0, vocab, rows)]
        num = list(np.round(rng.normal(0, 5, rows), 3))
        tables.append(Table(f"t{t}", [col, other, num]))
        truth[t] = n_overlap
    return DataLake(tables), query, truth


def mc_joinable_lake(n_tables=80, rows=60, vocab=4000, seed=0, n_cols=2):
    """Lake for multi-column join: some tables contain aligned query tuples,
    others contain the same values misaligned (MATE's FP source).

    Returns (lake, query_tuples, truth) where truth[t] = number of query
    tuples exactly joinable with a row of table t (aligned).
    """
    rng = np.random.default_rng(seed)
    voc = _vocab(rng, vocab)
    n_q = 20
    q_tuples = [tuple(voc[i] for i in rng.choice(vocab, n_cols, replace=False))
                for _ in range(n_q)]
    tables, truth = [], np.zeros(n_tables, np.int32)
    for t in range(n_tables):
        cols = [[voc[i] for i in rng.integers(0, vocab, rows)]
                for _ in range(n_cols + 1)]
        mode = t % 3
        n_hit = int(rng.integers(0, n_q // 2))
        rows_idx = rng.choice(rows, n_hit, replace=False)
        hits = rng.choice(n_q, n_hit, replace=False)
        if mode in (0, 1):    # aligned: tuple values in the same row
            for r, qi in zip(rows_idx, hits):
                for c in range(n_cols):
                    cols[c][r] = q_tuples[qi][c]
            truth[t] = n_hit
        else:                 # misaligned: values present but in different rows
            for r, qi in zip(rows_idx, hits):
                for c in range(n_cols):
                    cols[c][(r + c + 1) % rows] = q_tuples[qi][c]
            truth[t] = 0
        tables.append(Table(f"t{t}", cols))
    return DataLake(tables), q_tuples, truth


def unionable_lake(n_clusters=10, per_cluster=8, rows=40, seed=0):
    """Clusters of unionable tables: tables in a cluster share column domains.

    Returns (lake, cluster_of_table) — tables with the same cluster id are
    the union-search ground truth for each other.
    """
    rng = np.random.default_rng(seed)
    tables, labels = [], []
    for c in range(n_clusters):
        domains = []
        for d in range(3):
            base = [f"cl{c}_d{d}_v{i}" for i in range(60)]
            domains.append(base)
        for j in range(per_cluster):
            columns = [list(rng.choice(dom, rows)) for dom in domains]
            tables.append(Table(f"cl{c}_t{j}", columns))
            labels.append(c)
    order = rng.permutation(len(tables))
    tables = [tables[i] for i in order]
    labels = [labels[i] for i in order]
    return DataLake(tables), np.array(labels)


def correlation_lake(n_tables=60, rows=80, seed=0, numeric_join_keys=False):
    """Lake for correlation discovery: tables join with the query on a key
    column; one numeric column correlates with the query target with a known
    coefficient.

    Returns (lake, join_values, target_values, truth_corr[t]).
    """
    rng = np.random.default_rng(seed)
    n_keys = rows
    if numeric_join_keys:
        keys = list(range(1000, 1000 + n_keys))
    else:
        keys = [f"key_{i}" for i in range(n_keys)]
    target = rng.normal(0, 1, n_keys)
    tables, truth = [], np.zeros(n_tables, np.float64)
    for t in range(n_tables):
        rho = float(rng.uniform(-1, 1))
        noise = rng.normal(0, 1, n_keys)
        y = rho * target + np.sqrt(max(1 - rho ** 2, 1e-9)) * noise
        perm = rng.permutation(n_keys)
        cols = [[keys[i] for i in perm],
                list(np.round(y[perm], 5)),
                list(rng.normal(50, 20, n_keys).round(3))]
        tables.append(Table(f"t{t}", cols, ["key", "corr_col", "noise_col"]))
        truth[t] = abs(np.corrcoef(target, y)[0, 1])
    return DataLake(tables), keys, list(np.round(target, 5)), truth
