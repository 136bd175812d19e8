"""Combiners: set algebra over dense per-table result vectors.

A seeker's result set is (scores f32 [n_tables], mask bool [n_tables]) with
the mask holding its top-k selection — combiners are elementwise AND / OR /
ANDNOT / + over these vectors (the paper's combiners are SQL set ops).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class ResultSet:
    scores: torch.Tensor         # f32 [n_tables]
    mask: torch.Tensor           # bool [n_tables]

    @staticmethod
    def rank(s, m):
        """Rank host-side (scores, mask) arrays: selected ids, score desc."""
        ids = np.nonzero(m)[0]
        return ids[np.argsort(-s[ids], kind="stable")]

    def ids(self):
        """Selected table ids sorted by score desc (host-side)."""
        return self.rank(self.scores.cpu().numpy(), self.mask.cpu().numpy())


def topk_result(scores, k: int) -> ResultSet:
    """Select the top-k positive-score tables into a ResultSet.  Ties break
    toward the lowest index, as ``lax.top_k`` does: a stable descending
    sort, not ``torch.topk``."""
    k = min(k, scores.shape[0])
    ids = torch.sort(scores, descending=True, stable=True).indices[:k]
    mask = torch.zeros(scores.shape[0], dtype=torch.bool,
                       device=scores.device)
    mask[ids] = scores[ids] > 0
    return ResultSet(scores=torch.where(mask, scores, 0.0), mask=mask)


def intersect(results, k: int | None = None) -> ResultSet:
    mask = results[0].mask
    scores = results[0].scores
    for r in results[1:]:
        mask = mask & r.mask
        scores = scores + r.scores
    scores = torch.where(mask, scores, 0.0)
    return _maybe_topk(scores, mask, k)


def union(results, k: int | None = None) -> ResultSet:
    mask = results[0].mask
    scores = results[0].scores
    for r in results[1:]:
        mask = mask | r.mask
        scores = torch.maximum(scores, r.scores)
    scores = torch.where(mask, scores, 0.0)
    return _maybe_topk(scores, mask, k)


def difference(a: ResultSet, b: ResultSet, k: int | None = None) -> ResultSet:
    mask = a.mask & ~b.mask
    scores = torch.where(mask, a.scores, 0.0)
    return _maybe_topk(scores, mask, k)


def counter(results, k: int | None = None) -> ResultSet:
    """Count occurrences of each table across the input sets, rank by count
    (the paper's union-search aggregator)."""
    counts = torch.zeros_like(results[0].scores)
    for r in results:
        counts = counts + r.mask.to(torch.float32)
    mask = counts > 0
    return _maybe_topk(counts, mask, k)


def _maybe_topk(scores, mask, k):
    if k is None:
        return ResultSet(scores=scores, mask=mask)
    return topk_result(scores, k)
