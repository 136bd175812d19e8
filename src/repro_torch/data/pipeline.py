"""Deterministic training-data pipeline, fed by BLEND discovery.

The discovery layer selects lake tables (e.g. a KW-seeker domain filter, an
SC-seeker dedup pass); selected tables are tokenized (value-hash % vocab) into
a flat stream, and batches are *step-indexed*: batch(i) is a pure function of
(seed, i), so a restarted job replays the exact same data order from the
checkpoint step — the fault-tolerance contract.

The JAX package's ``data/pipeline.py`` on the port: ``select_tables`` runs
the port's ``Executor`` (on its device) and reads the ids off its
``ResultSet``; tokens and batches stay numpy, and the trainer moves each
batch to its device.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.executor import Executor
from repro_torch.core.hashing import hash_value
from repro_torch.core.lake import DataLake
from repro_torch.core.plan import Plan


def select_tables(lake: DataLake, plan: Plan, executor: Executor) -> list:
    """Run a discovery plan and return the selected table objects."""
    rs, _ = executor.run(plan, optimize=True)
    return [lake.tables[int(t)] for t in rs.ids()]


def tokenize_tables(tables, vocab: int, bos: int = 1) -> np.ndarray:
    """Row-major value-hash tokenization of the selected tables."""
    toks = []
    for tab in tables:
        for r in range(tab.n_rows):
            toks.append(bos)
            for v in tab.row(r):
                toks.append(2 + hash_value(v) % (vocab - 2))
    return np.array(toks, np.int32)


class TokenStream:
    """Step-indexed deterministic batcher over a token array."""

    def __init__(self, tokens: np.ndarray, batch: int, seq_len: int,
                 seed: int = 0):
        self.tokens = tokens
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.n_windows = max(len(tokens) - seq_len - 1, 1)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        starts = rng.integers(0, self.n_windows, self.batch)
        rows = np.stack([self.tokens[s:s + self.seq_len] for s in starts])
        return {"tokens": rows.astype(np.int32)}
