"""BLEND's two-phase plan optimizer (Section VII-B).

Four steps on the plan DAG:
1. **EG identification** — seekers feeding the same *Intersection* combiner
   form an execution group (the only reorderable combiner: Difference is
   non-commutative; Union/Counter gain nothing from ordering).
2. **EG ordering** — topological over the hyper-DAG (handled by the executor's
   dependency-driven traversal).
3. **Operator ranking** — rule-based across types (KW ≺ SC ≺ C ≺ MC, Rules
   1-3) and the learned cost model within a type.
4. **Query rewriting** — the surviving-table mask of each executed seeker is
   threaded into the next seeker (Intersection: ``allowed=mask``;
   Difference: subtrahend restricted to the minuend's tables; Counter/Union:
   no rewriting), mirroring the paper's predicate injection.

Statistics are segment-aware on live lakes: ``stats_fn`` (the executor's
``seeker_stats``) sums per-segment ``host_counts`` with tombstoned postings
excluded (``live_only=True``), so the ranking reflects the live lake even
while dropped tables still occupy probe-window slots awaiting compaction.
Match *capacities*, by contrast, are sized from the tombstone-inclusive
counts — a masked posting fills a window slot all the same.

Theorem 1 (output preservation) is tested property-style in
tests/test_optimizer.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.cost_model import RULE_RANK, CostModel
from repro_torch.core.plan import Plan, SeekerSpec


@dataclass
class ExecutionGroup:
    combiner: str                 # combiner node name
    seekers: list                 # ordered seeker node names


@dataclass
class ExecutionPlan:
    plan: Plan
    groups: dict = field(default_factory=dict)   # combiner name -> EG
    ranked: dict = field(default_factory=dict)   # seeker name -> rank index


def identify_groups(plan: Plan):
    """EGs: seeker-only dep sets of Intersection combiners."""
    groups = {}
    for node in plan.nodes.values():
        if node.is_seeker:
            continue
        if node.spec.kind != "intersect":
            continue
        seekers = [d for d in node.deps if plan.nodes[d].is_seeker]
        if len(seekers) >= 2:
            groups[node.name] = ExecutionGroup(node.name, seekers)
    return groups


def rank_seekers(plan: Plan, names, stats_fn, cost_model: CostModel | None):
    """Order seeker nodes by (rule rank, learned cost estimate)."""

    def key(name):
        spec: SeekerSpec = plan.nodes[name].spec
        rule = RULE_RANK[spec.kind]
        if cost_model is not None and cost_model.trained(spec.kind):
            est = cost_model.predict(spec.kind, *stats_fn(spec))
        else:
            est = stats_fn(spec)[0]           # fallback: |Q|
        return (rule, est)

    return sorted(names, key=key)


def optimize(plan: Plan, stats_fn, cost_model: CostModel | None = None):
    """Returns an ExecutionPlan with ranked execution groups."""
    plan.validate()
    ep = ExecutionPlan(plan=plan, groups=identify_groups(plan))
    for eg in ep.groups.values():
        eg.seekers = rank_seekers(plan, eg.seekers, stats_fn, cost_model)
        for i, s in enumerate(eg.seekers):
            ep.ranked[s] = i
    return ep
