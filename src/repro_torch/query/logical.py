"""BlendQL logical-plan IR: composable discovery expressions.

Leaves are the four seekers (paper Section VI); interior nodes are the four
combiners (Section VII-A) with SQL-set-op semantics.  Expressions are frozen
dataclasses, so structural equality / hashing come for free — the rewriter's
hash-consing and the lowering memo both key on the node itself.

Fluent form (operator overloading)::

    expr = sc(values, k=100) & kw(words) | corr(join, target)
    expr = mc(positives) - mc(outdated)          # difference
    expr = counter(sc(col_a), sc(col_b), k=10)   # union-search aggregator

``expr.to_sql()`` prints the equivalent BlendQL string (parse-able by
``repro_torch.query.parse``), ``expr.render()`` pretty-prints the tree for
``session.explain``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.core.plan import SeekerSpec

#: combiners whose ``k`` is None are lowered with this cut-free limit —
#: ``topk_result`` clamps to n_tables, so "huge" means "keep every positive".
UNCUT = 1 << 20


def _literal(v) -> str:
    """Render one query value as a BlendQL literal."""
    if isinstance(v, bool):
        raise TypeError("bool query values are not supported")
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v).replace("'", "''")
    return f"'{s}'"


def _kwargs_sql(pairs) -> str:
    out = []
    for name, val, default in pairs:
        if val != default:
            out.append(f"{name}={_literal(val) if isinstance(val, str) else val}")
    return (", " + ", ".join(out)) if out else ""


class Expr:
    """Base class: every IR node supports ``& | -`` composition."""

    def __and__(self, other: "Expr") -> "And":
        return And((self, _expr(other)))

    def __or__(self, other: "Expr") -> "Or":
        return Or((self, _expr(other)))

    def __sub__(self, other: "Expr") -> "Sub":
        return Sub(self, _expr(other))

    def top(self, k: int) -> "Expr":
        """Return a copy with the result limit set to ``k``."""
        return replace(self, k=k)

    # -- traversal helpers -------------------------------------------------
    def children(self) -> tuple:
        return ()

    def with_children(self, kids) -> "Expr":
        raise NotImplementedError

    def label(self) -> str:
        raise NotImplementedError

    def render(self, indent: int = 0, _shared=None) -> str:
        """Pretty tree rendering (used by ``session.explain``)."""
        if _shared is None:
            counts: dict = {}
            _count_occurrences(self, counts)
            _shared = {e for e, n in counts.items() if n > 1}
        pad = "  " * indent
        tag = "  <shared>" if indent and self in _shared else ""
        lines = [f"{pad}{self.label()}{tag}"]
        for c in self.children():
            lines.append(c.render(indent + 1, _shared))
        return "\n".join(lines)

    def fingerprint(self, top: int | None = None) -> str:
        """Canonical content hash of this query (query/fingerprint.py):
        rewritten to normal form, commutative children order-blind — the
        identity the query cache serves repeats under."""
        from repro_torch.query.fingerprint import fingerprint_query
        return fingerprint_query(self, top=top)

    def to_sql(self) -> str:
        """Full BlendQL statement for this expression (round-trips through
        ``repro_torch.query.parse.parse``)."""
        k = getattr(self, "k", None)
        body = self._sql()
        if isinstance(self, Seek):          # the leaf carries its own k
            return f"SELECT TABLES WHERE {body}"
        if k is not None:
            return f"SELECT TOP {k} TABLES WHERE {self._sql(top_level=True)}"
        return f"SELECT TABLES WHERE {body}"

    def _sql(self, top_level: bool = False) -> str:
        raise NotImplementedError


def _count_occurrences(e: Expr, counts: dict):
    counts[e] = counts.get(e, 0) + 1
    for c in e.children():
        _count_occurrences(c, counts)


def _expr(x) -> Expr:
    if not isinstance(x, Expr):
        raise TypeError(f"expected a BlendQL expression, got {type(x)!r}")
    return x


# --------------------------------------------------------------------- leaves
@dataclass(frozen=True)
class Seek(Expr):
    """Seeker leaf; ``kind`` ∈ SC | KW | MC | C (paper Listings 1-3)."""
    kind: str
    values: tuple
    k: int = 100
    target: tuple = ()               # C: numeric target values
    h: int = 256                     # C: sketch sample size
    sampling: str = "conv"           # C: 'conv' | 'rand'

    def spec(self) -> SeekerSpec:
        return SeekerSpec(self.kind, self.k, self.values, self.target,
                          self.h, self.sampling)

    def label(self) -> str:
        n = len(self.values)
        extra = f", h={self.h}" if self.kind == "C" else ""
        return f"{self.kind.lower()}(|Q|={n}, k={self.k}{extra})"

    def _sql(self, top_level: bool = False) -> str:
        name = self.kind.lower() if self.kind != "C" else "corr"
        if self.kind == "MC":
            args = ", ".join("(" + ", ".join(_literal(v) for v in t) + ")"
                             for t in self.values)
            return f"mc({args}, k={self.k})"
        if self.kind == "C":
            joins = "[" + ", ".join(_literal(v) for v in self.values) + "]"
            tgt = "[" + ", ".join(_literal(v) for v in self.target) + "]"
            opts = f", k={self.k}" + _kwargs_sql([("h", self.h, 256),
                                                  ("sampling", self.sampling,
                                                   "conv")])
            return f"corr({joins}, {tgt}{opts})"
        args = ", ".join(_literal(v) for v in self.values)
        return f"{name}({args}, k={self.k})"


def sc(values, k: int = 100) -> Seek:
    """Joinable-table search (single column; JOSIE-style)."""
    return Seek("SC", tuple(values), k)


def kw(words, k: int = 100) -> Seek:
    """Keyword search over all columns."""
    return Seek("KW", tuple(words), k)


def mc(tuples, k: int = 100) -> Seek:
    """Multi-column join search (MATE-style superkeys)."""
    return Seek("MC", tuple(tuple(t) for t in tuples), k)


def corr(join_values, target_values, k: int = 100, h: int = 256,
         sampling: str = "conv") -> Seek:
    """Correlation discovery (QCR): joinable + correlating columns."""
    return Seek("C", tuple(join_values), k, tuple(target_values), h, sampling)


# ------------------------------------------------------------------ combiners
@dataclass(frozen=True)
class And(Expr):
    """Intersection (n-ary after the flatten rule)."""
    kids: tuple
    k: int | None = None
    eg: bool = field(default=False, compare=False)   # mask-threading annotation

    def children(self):
        return self.kids

    def with_children(self, kids):
        return replace(self, kids=tuple(kids))

    def label(self):
        eg = ", eg=mask-threaded" if self.eg else ""
        return f"intersect(k={self.k}{eg})"

    def _sql(self, top_level: bool = False):
        body = " AND ".join(c._sql() for c in self.kids)
        return body if top_level else f"({body})"


@dataclass(frozen=True)
class Or(Expr):
    """Union (max-score semantics, n-ary after the flatten rule)."""
    kids: tuple
    k: int | None = None

    def children(self):
        return self.kids

    def with_children(self, kids):
        return replace(self, kids=tuple(kids))

    def label(self):
        return f"union(k={self.k})"

    def _sql(self, top_level: bool = False):
        body = " OR ".join(c._sql() for c in self.kids)
        return body if top_level else f"({body})"


@dataclass(frozen=True)
class Sub(Expr):
    """Difference: tables matching ``left`` but not ``right``."""
    left: Expr
    right: Expr
    k: int | None = None

    def children(self):
        return (self.left, self.right)

    def with_children(self, kids):
        l, r = kids
        return replace(self, left=l, right=r)

    def label(self):
        return f"difference(k={self.k})"

    def _sql(self, top_level: bool = False):
        body = f"{self.left._sql()} EXCEPT {self.right._sql()}"
        return body if top_level else f"({body})"


@dataclass(frozen=True)
class Counter(Expr):
    """Count-based aggregator (the paper's union-search combiner)."""
    kids: tuple
    k: int | None = None

    def children(self):
        return self.kids

    def with_children(self, kids):
        return replace(self, kids=tuple(kids))

    def label(self):
        return f"counter(k={self.k})"

    def _sql(self, top_level: bool = False):
        args = ", ".join(c._sql() for c in self.kids)
        if self.k is not None:
            args += f", k={self.k}"
        return f"counter({args})"


def counter(*exprs, k: int | None = None) -> Counter:
    """``counter(e1, e2, ...)``: rank tables by how many inputs matched."""
    if len(exprs) == 1 and isinstance(exprs[0], (list, tuple)):
        exprs = tuple(exprs[0])
    if len(exprs) < 2:
        raise ValueError("counter() needs >= 2 input expressions")
    return Counter(tuple(_expr(e) for e in exprs), k)


def walk(e: Expr):
    """Post-order traversal."""
    for c in e.children():
        yield from walk(c)
    yield e
