"""Canonical fingerprints: the content-addressed identity of a query.

The query cache (serve/cache.py) keys on *semantic* identity, not on object
identity or source text: ``a & b`` and ``b & a`` must hit the same entry, and
a query written fluently, as BlendQL text, or as a legacy ``Plan`` must all
resolve to one fingerprint when they describe the same work.  Three layers:

* ``fingerprint_spec``  — one seeker leaf.  Query values are rendered through
  the same canonicalization as ``core.hashing.hash_value`` (integral floats
  join like ints) and reduced to the executor's set semantics: SC/KW values
  sort + dedupe; MC tuples dedupe raw, then sort (a tuple's values are
  position-independent in the row-membership validation, so within-tuple
  order is canonicalized away too); C pairs dedupe in written order only —
  the k0/k1 target-mean split is pair-order-sensitive at the ulp level.
* ``fingerprint_expr`` / ``fingerprint_plan`` — the DAG.  Children of
  order-blind combiners are sorted by child fingerprint — union and counter
  at any arity, intersect only at two inputs (``_order_blind``: a permuted
  >= 3-ary f32 score sum can differ by an ulp, so those spellings keep their
  own entries); ``difference`` stays ordered.  Duplicate children are kept:
  a legacy plan that sums a seeker twice is *not* the same computation as
  the folded expression.  Expressions are fingerprinted post-rewrite
  (``rules.canonical_expr``), so nesting differences the flatten rule
  removes never split cache entries.
* ``index_epoch_key`` — the invalidation key ``(epoch, index fingerprint)``:
  any LiveLake mutation bumps the epoch, and the fingerprint pins the cache
  to one resident store so a cache handle can never serve ids from a
  different index object.

Hashes are blake2b over stable literal renderings — never Python ``hash``,
which is salted per process for strings.
"""
from __future__ import annotations

import hashlib
import itertools

import numpy as np

from repro_torch.core.plan import Plan, SeekerSpec
from repro_torch.query import logical as L

_KIND_OF = {L.And: "intersect", L.Or: "union", L.Sub: "difference",
            L.Counter: "counter"}


def _order_blind(kind: str, n_kids: int) -> bool:
    """Is this combiner's result *bit*-independent of its input order?
    Union (elementwise max) and counter (sums of 0/1 mask floats) are exact
    at any arity.  Intersect sums f32 scores sequentially: commutative at 2
    inputs, but at >= 3 a permutation re-associates the sum and fractional
    (QCR) scores can move by an ulp — those spellings must NOT share a cache
    entry, or a hit could differ from that spelling's own cold run."""
    if kind in ("union", "counter"):
        return True
    return kind == "intersect" and n_kids <= 2


def _h(*parts) -> str:
    d = hashlib.blake2b(digest_size=16)
    for p in parts:
        d.update(str(p).encode())
        d.update(b"\x1f")
    return d.hexdigest()


def _literal(v) -> str:
    """Stable literal form of one query value, canonicalized the way
    ``hash_value`` canonicalizes (2.0 joins like 2, bools like ints, numpy
    scalars like their Python equivalents)."""
    if v is None:
        return "none"
    if isinstance(v, (bool, np.bool_)):
        v = int(v)
    elif isinstance(v, np.integer):
        v = int(v)
    elif isinstance(v, np.floating):
        v = float(v)
    elif isinstance(v, str) and type(v) is not str:
        v = str(v)                       # np.str_ and other str subclasses
    if isinstance(v, float) and v.is_integer():
        v = int(v)
    return f"{type(v).__name__}:{v!r}"


def fingerprint_spec(spec: SeekerSpec) -> str:
    """Content hash of one seeker leaf under the executor's set semantics."""
    if spec.kind == "MC":
        # dedupe raw tuples (executor: dict.fromkeys), then canonicalize:
        # within-tuple order is position-independent, the tuple *multiset*
        # is not (two permuted duplicates score twice)
        tuples = list(dict.fromkeys(spec.values))
        q = sorted("|".join(sorted(_literal(v) for v in t)) for t in tuples)
        return _h("seek", "MC", spec.k, *q)
    if spec.kind == "C":
        # pairs dedupe in written order but are NOT sorted: the executor's
        # k0/k1 split thresholds on tgt.mean(), and an f64 mean over permuted
        # pairs can move by an ulp and flip a boundary qbit — permuted corr
        # spellings are different computations and keep their own entries
        pairs = list(dict.fromkeys(zip(spec.values, spec.target)))
        q = [f"{_literal(a)}->{_literal(b)}" for a, b in pairs]
        return _h("seek", "C", spec.k, spec.h, spec.sampling, *q)
    # SC / KW: plain IN (...) set semantics
    q = sorted({_literal(v) for v in spec.values})
    return _h("seek", spec.kind, spec.k, *q)


def fingerprint_expr(e: L.Expr) -> str:
    """Content hash of a logical expression DAG (hash-consed or not — shared
    and duplicated-but-equal subtrees fingerprint identically).  Canonical
    caching should fingerprint the *rewritten* tree (``fingerprint_query``)
    so flatten/fold normalization is already applied."""
    memo: dict = {}

    def fp(n: L.Expr) -> str:
        got = memo.get(n)
        if got is not None:
            return got
        if isinstance(n, L.Seek):
            f = fingerprint_spec(n.spec())
        else:
            kids = [fp(c) for c in n.children()]
            kind = _KIND_OF[type(n)]
            if _order_blind(kind, len(kids)):
                kids = sorted(kids)
            k = n.k if n.k is not None else L.UNCUT
            f = _h("comb", kind, k, *kids)
        memo[n] = f
        return f

    return fp(e)


def fingerprint_query(e: L.Expr, top: int | None = None) -> str:
    """Normalize through the rewrite rules, then fingerprint — the canonical
    query identity (``(a & b).fingerprint() == (b & a).fingerprint()``,
    nested vs flat AND chains collapse, duplicate siblings fold)."""
    from repro_torch.query.rules import canonical_expr
    return fingerprint_expr(canonical_expr(e, top=top))


def fingerprint_plan(plan: Plan) -> str:
    """Content hash of a physical plan DAG from its output node.  Produces
    the same digest as ``fingerprint_expr`` on the expression it was lowered
    from (combiners with ``k=None`` lower to ``UNCUT``), so legacy plans and
    BlendQL expressions share cache entries."""
    memo: dict = {}

    def fp(name: str) -> str:
        got = memo.get(name)
        if got is not None:
            return got
        node = plan.nodes[name]
        if node.is_seeker:
            f = fingerprint_spec(node.spec)
        else:
            kids = [fp(d) for d in node.deps]
            if _order_blind(node.spec.kind, len(kids)):
                kids = sorted(kids)
            f = _h("comb", node.spec.kind, node.spec.k, *kids)
        memo[name] = f
        return f

    if plan.output is None:
        raise ValueError("cannot fingerprint an empty plan")
    return fp(plan.output)


_NONCES = itertools.count(1)


def object_nonce(obj) -> int:
    """Process-unique identity stamp for one object (index, cost model...).
    ``id()`` is not enough: CPython reuses freed addresses, so a shared
    QueryCache could match a dead object's key against a same-shaped
    successor — a nonce lives exactly as long as the object and is never
    reused.  Falls back to ``id`` for objects that refuse attributes."""
    n = getattr(obj, "_cache_nonce", None)
    if n is None:
        n = next(_NONCES)
        try:
            obj._cache_nonce = n
        except AttributeError:
            return id(obj)
    return n


def index_fingerprint(index) -> str:
    """Identity of the resident index object (static ``UnifiedIndex`` or a
    LiveLake ``SegmentStore``).  Together with the epoch this is the cache
    invalidation key: same process, same store, same epoch — anything else
    never matches."""
    kind = "store" if hasattr(index, "segments") else "static"
    return _h(kind, object_nonce(index), index.n_tables, index.n_postings,
              index.row_stride)


def index_epoch_key(index) -> tuple:
    """``(epoch, index fingerprint)`` — every LiveLake mutation
    (``add_table`` / ``drop_table`` / ``compact``) bumps the epoch, so a
    cache validated against this key can never serve stale table ids.
    Static indexes are immutable: epoch pinned to 0."""
    return (getattr(index, "epoch", 0), index_fingerprint(index))
