"""Lowering: logical IR -> the existing physical ``Plan`` DAG.

The physical executor (core/executor.py) and optimizer (core/optimizer.py)
stay the backend unchanged — lowering just emits ``Plan.add`` calls.  Node
names are deterministic (``sc0, and1, ...`` in post-order), and emission is
memoized per interned IR node: after the rewriter's hash-consing, a subtree
shared by two branches becomes ONE plan node, which the executor's per-name
memo then runs exactly once.
"""
from __future__ import annotations

from repro_torch.core.plan import CombinerSpec, Plan
from repro_torch.query import logical as L

_KINDS = {L.And: "intersect", L.Or: "union", L.Sub: "difference",
          L.Counter: "counter"}


def lower(e: L.Expr) -> tuple[Plan, dict]:
    """Emit a physical plan for ``e``.  Returns ``(plan, node_of)`` where
    ``node_of`` maps each IR node to its plan-node name.  Combiners with
    ``k=None`` lower cut-free (``UNCUT``); a seeker root keeps its own k."""
    plan = Plan()
    node_of: dict = {}
    counts: dict = {}

    def name_for(tag: str) -> str:
        i = counts.get(tag, 0)
        counts[tag] = i + 1
        return f"{tag}{i}"

    def emit(n: L.Expr) -> str:
        got = node_of.get(n)
        if got is not None:
            return got
        if isinstance(n, L.Seek):
            name = name_for(n.kind.lower())
            plan.add(name, n.spec())
        else:
            deps = [emit(c) for c in n.children()]
            kind = _KINDS[type(n)]
            k = n.k if n.k is not None else L.UNCUT
            name = name_for(kind)
            plan.add(name, CombinerSpec(kind, k), deps)
        node_of[n] = name
        return name

    out = emit(e)
    plan.output = out
    return plan, node_of
