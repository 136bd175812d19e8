"""Plan API: declarative discovery-task definition (the paper's Listing 4).

    plan = Plan()
    plan.add('kw', Seekers.KW(keywords, k=10))
    for col in example_cols:
        plan.add(col, Seekers.SC(values, k=100))
    plan.add('counter', Combiners.Counter(k=10), example_cols)
    plan.add('union', Combiners.Union(k=40), ['kw', 'counter'])

A plan is a DAG of seeker / combiner nodes; the grammar is validated at add
time (expression ::= seeker(Q) | combiner(expression+)).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class SeekerSpec:
    kind: str                    # 'SC' | 'KW' | 'MC' | 'C'
    k: int
    values: tuple = ()           # SC/KW: values; MC: tuples; C: join keys
    target: tuple = ()           # C: numeric target values
    h: int = 256                 # C: sketch sample size (query-time!)
    sampling: str = "conv"       # C: 'conv' | 'rand'

    @property
    def n_cols(self) -> int:
        if self.kind == "MC":
            return len(self.values[0]) if self.values else 0
        return 2 if self.kind == "C" else 1


@dataclass(frozen=True)
class CombinerSpec:
    kind: str                    # 'intersect' | 'union' | 'difference' | 'counter'
    k: int


class Seekers:
    @staticmethod
    def SC(values, k=10):
        return SeekerSpec("SC", k, tuple(values))

    @staticmethod
    def KW(keywords, k=10):
        return SeekerSpec("KW", k, tuple(keywords))

    @staticmethod
    def MC(tuples, k=10):
        return SeekerSpec("MC", k, tuple(tuple(t) for t in tuples))

    @staticmethod
    def Correlation(join_values, target_values, k=10, h=256, sampling="conv"):
        return SeekerSpec("C", k, tuple(join_values), tuple(target_values),
                          h, sampling)


class Combiners:
    @staticmethod
    def Intersect(k=10):
        return CombinerSpec("intersect", k)

    @staticmethod
    def Union(k=10):
        return CombinerSpec("union", k)

    @staticmethod
    def Difference(k=10):
        return CombinerSpec("difference", k)

    @staticmethod
    def Counter(k=10):
        return CombinerSpec("counter", k)


@dataclass
class Node:
    name: str
    spec: object
    deps: list = field(default_factory=list)

    @property
    def is_seeker(self) -> bool:
        return isinstance(self.spec, SeekerSpec)


class Plan:
    """A DAG of named seeker/combiner nodes; the last added node (or an
    explicit ``output``) is the plan result."""

    def __init__(self):
        self.nodes: dict[str, Node] = {}
        self.order: list[str] = []
        self.output: str | None = None

    def add(self, name: str, spec, deps=None):
        if name in self.nodes:
            raise ValueError(f"duplicate node {name!r}")
        deps = list(deps) if deps else []
        if isinstance(spec, SeekerSpec):
            if deps:
                raise ValueError("seekers take no deps (grammar: seeker(Q))")
        elif isinstance(spec, CombinerSpec):
            if len(deps) < 2:
                raise ValueError("combiners need >= 2 inputs")
            if spec.kind == "difference" and len(deps) != 2:
                raise ValueError("difference takes exactly 2 inputs")
            missing = [d for d in deps if d not in self.nodes]
            if missing:
                raise ValueError(f"unknown deps {missing}")
        else:
            raise TypeError(spec)
        self.nodes[name] = Node(name, spec, deps)
        self.order.append(name)
        self.output = name
        return self

    def seekers(self):
        return [n for n in self.nodes.values() if n.is_seeker]

    def copy(self) -> "Plan":
        """Shallow structural copy (nodes are immutable-by-convention; the
        dict/order/output skeleton is duplicated so pruning a copy never
        mutates the original)."""
        p = Plan()
        p.nodes = dict(self.nodes)
        p.order = list(self.order)
        p.output = self.output
        return p

    def reachable(self, root: str | None = None) -> set:
        """Node names reachable from ``root`` (default: the plan output)
        through dep edges.  Shared by ``validate`` and the BlendQL
        rewriter's dead-subtree pruning (query/rules.py)."""
        root = self.output if root is None else root
        if root is None:
            return set()
        seen: set = set()
        stack = [root]
        while stack:
            name = stack.pop()
            if name in seen:
                continue
            seen.add(name)
            stack.extend(self.nodes[name].deps)
        return seen

    def prune_unreachable(self) -> list:
        """Remove nodes unreachable from the output; returns their names."""
        keep = self.reachable()
        removed = [n for n in self.order if n not in keep]
        if removed:
            self.nodes = {n: v for n, v in self.nodes.items() if n in keep}
            self.order = [n for n in self.order if n in keep]
        return removed

    def validate(self):
        # acyclicity is by construction (deps must pre-exist); check that
        # every node is reachable from the output — a dead subtree means the
        # plan author wired a dep list wrong (or wants prune_unreachable())
        if self.output is None:
            raise ValueError("empty plan")
        reach = self.reachable()
        dead = [n for n in self.order if n not in reach]
        if dead:
            raise ValueError(
                f"nodes unreachable from output {self.output!r}: {dead} "
                f"(Plan.prune_unreachable() drops them)")
        return True

    def consumers(self, name: str):
        return [n for n in self.nodes.values() if name in n.deps]
