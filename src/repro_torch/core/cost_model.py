"""Learning-based seeker cost estimation (the paper's ML optimizer).

One ridge regression per seeker type on the paper's three features:
cardinality of Q, number of columns in Q, and the average frequency of Q's
values in the lake (for MC: product of per-column average frequencies).
Trained offline on measured runtimes of randomly sampled queries; predicting
is part of the online optimization step.
"""
from __future__ import annotations

import time

import numpy as np

SEEKER_TYPES = ("KW", "SC", "MC", "C")
# Rule-based ranking (Rules 1-3): KW always first, MC always last, SC over C.
RULE_RANK = {"KW": 0, "SC": 1, "C": 2, "MC": 3}


def features(card: float, n_cols: float, avg_freq: float) -> np.ndarray:
    return np.array([1.0, np.log1p(card), float(n_cols), np.log1p(avg_freq)])


class CostModel:
    def __init__(self):
        self.weights: dict[str, np.ndarray] = {}

    def fit(self, kind: str, X: np.ndarray, y: np.ndarray, l2: float = 1e-3):
        A = X.T @ X + l2 * np.eye(X.shape[1])
        self.weights[kind] = np.linalg.solve(A, X.T @ y)

    def predict(self, kind: str, card, n_cols, avg_freq) -> float:
        w = self.weights.get(kind)
        if w is None:
            return float(card)          # fallback: bigger queries are slower
        return float(features(card, n_cols, avg_freq) @ w)

    def trained(self, kind: str) -> bool:
        return kind in self.weights


def train_cost_model(executor, lake, n_samples: int = 60, seed: int = 0,
                     kinds=("SC", "KW", "MC", "C")) -> CostModel:
    """Sample random queries from the lake, execute each seeker standalone,
    and fit per-type regressions on the measured runtimes."""
    from repro_torch.core.plan import Seekers

    rng = np.random.default_rng(seed)
    model = CostModel()
    for kind in kinds:
        X, y = [], []
        for _ in range(n_samples):
            t = lake.tables[int(rng.integers(0, lake.n_tables))]
            n = int(rng.integers(3, max(4, min(30, t.n_rows))))
            rows = rng.choice(t.n_rows, n, replace=False)
            if kind in ("SC", "KW"):
                vals = [t.columns[0][r] for r in rows]
                spec = (Seekers.SC(vals, k=10) if kind == "SC"
                        else Seekers.KW(vals, k=10))
            elif kind == "MC":
                if t.n_cols < 2:
                    continue
                tups = [(t.columns[0][r], t.columns[1][r]) for r in rows]
                spec = Seekers.MC(tups, k=10)
            else:
                num_cols = [c for c in range(t.n_cols)
                            if executor.index.quadrant is not None]
                vals = [t.columns[0][r] for r in rows]
                tgt = list(np.round(rng.normal(0, 1, n), 4))
                spec = Seekers.Correlation(vals, tgt, k=10)
            stats = executor.seeker_stats(spec)
            t0 = time.perf_counter()
            executor.run_seeker(spec)
            dt = time.perf_counter() - t0
            X.append(features(*stats))
            y.append(dt)
        if X:
            model.fit(kind, np.stack(X), np.array(y))
    return model
