"""Rule-based rewriter: canonicalization passes over the logical IR.

Each rule is a named function ``rule(expr) -> expr`` (pure; returns the input
object unchanged when it does not apply), so rules are individually testable
and ``session.explain`` can list exactly which ones fired.  ``rewrite`` runs
the default pipeline to a fixpoint and records applied rule names — the
logical analogue of the paper's Section VII-B query-rewriting step, which
stays in the physical optimizer (core/optimizer.py) for ranking and mask
threading.

Dead-subtree pruning operates on the lowered physical plan and shares
``Plan.reachable()`` with ``Plan.validate()`` (one traversal, two clients).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.query import logical as L


def _map_children(e: L.Expr, fn) -> L.Expr:
    kids = e.children()
    if not kids:
        return e
    new = tuple(fn(c) for c in kids)
    if all(a is b for a, b in zip(new, kids)):
        return e
    return e.with_children(new)


def _bottom_up(e: L.Expr, visit) -> L.Expr:
    return visit(_map_children(e, lambda c: _bottom_up(c, visit)))


# ---------------------------------------------------------------------- rules
def flatten_and_or(e: L.Expr) -> L.Expr:
    """AND(AND(a,b),c) -> AND(a,b,c); same for OR.  A nested combiner with an
    explicit ``k`` is a cut point and is left in place (merging it would drop
    its intermediate top-k)."""

    def visit(n):
        if not isinstance(n, (L.And, L.Or)):
            return n
        kids = []
        changed = False
        for c in n.children():
            if type(c) is type(n) and c.k is None:
                kids.extend(c.children())
                changed = True
            else:
                kids.append(c)
        return n.with_children(kids) if changed else n

    return _bottom_up(e, visit)


def fold_idempotent(e: L.Expr) -> L.Expr:
    """X & X -> X and X | X -> X: drop structurally duplicate children of
    AND/OR (set semantics make them no-ops).  Counter is left alone — its
    score *is* the occurrence count."""

    def visit(n):
        if not isinstance(n, (L.And, L.Or)):
            return n
        seen, kids = set(), []
        for c in n.children():
            if c in seen:
                continue
            seen.add(c)
            kids.append(c)
        if len(kids) == len(n.children()):
            return n
        if len(kids) == 1:
            # a single-input combiner is just its input plus the cut: fold
            # the limit into the child (top-k of top-k = top-min(k))
            kid = kids[0]
            if n.k is None:
                return kid
            ck = getattr(kid, "k", None)
            return replace(kid, k=n.k if ck is None else min(ck, n.k))
        return n.with_children(kids)

    return _bottom_up(e, visit)


def push_limit(e: L.Expr, top: int | None = None) -> L.Expr:
    """Fold the query's ``SELECT TOP k`` into the root operator and keep
    interior combiners cut-free: only the root limits the result, interior
    nodes with ``k=None`` lower to an uncut pass-through, so no
    intermediate cut can hide a table the root would keep."""
    if top is None:
        return e
    if isinstance(e, L.Seek):
        return e if e.k <= top else replace(e, k=top)
    k = top if e.k is None else min(e.k, top)
    return e if k == e.k else e.top(k)


def hash_cons(e: L.Expr) -> L.Expr:
    """Intern structurally identical subtrees into single shared instances.
    Lowering memoizes per instance-equal node, so a seeker appearing in two
    branches becomes ONE physical plan node and executes exactly once."""
    interned: dict = {}

    def visit(n):
        canon = interned.get(n)
        if canon is not None:
            return canon
        interned[n] = n
        return n

    return _bottom_up(e, visit)


def annotate_masks(e: L.Expr) -> L.Expr:
    """Mark intersect nodes with >= 2 seeker children as execution-group
    candidates (``eg=True``): the physical optimizer will rank their seekers
    and thread the surviving-table mask through the group."""

    def visit(n):
        if isinstance(n, L.And) and not n.eg and \
                sum(isinstance(c, L.Seek) for c in n.children()) >= 2:
            return replace(n, eg=True)
        return n

    return _bottom_up(e, visit)


DEFAULT_RULES = (flatten_and_or, fold_idempotent, push_limit, hash_cons,
                 annotate_masks)


@dataclass
class RewriteResult:
    expr: L.Expr
    applied: list          # rule names, in application order

    def __iter__(self):    # (expr, applied) unpacking convenience
        return iter((self.expr, self.applied))


def rewrite(e: L.Expr, top: int | None = None,
            rules=DEFAULT_RULES, max_passes: int = 8) -> RewriteResult:
    """Run the rule pipeline to a fixpoint, recording which rules changed
    the tree.  ``top`` is the SELECT TOP k limit (push_limit's parameter)."""
    applied = []
    for _ in range(max_passes):
        changed = False
        for rule in rules:
            if rule is push_limit:
                new = rule(e, top)
                fired = new != e
            elif rule is hash_cons:
                # interning preserves structural equality; it "fires" when
                # some subtree occurs twice as distinct instances
                fired = _has_duplicate_instances(e)
                new = rule(e)
            elif rule is annotate_masks:
                new = rule(e)
                fired = _egs(new) != _egs(e)   # eg is compare=False
            else:
                new = rule(e)
                fired = new != e
            if fired:
                if rule.__name__ not in applied:
                    applied.append(rule.__name__)
                changed = True
            e = new
        if not changed:
            break
    return RewriteResult(e, applied)


def _has_duplicate_instances(e: L.Expr) -> bool:
    groups: dict = {}
    for n in L.walk(e):
        groups.setdefault(n, set()).add(id(n))
    return any(len(ids) > 1 for ids in groups.values())


def _egs(e: L.Expr) -> tuple:
    """eg annotations are compare=False; collect them for change detection."""
    return tuple(n.eg for n in L.walk(e) if isinstance(n, L.And))


def canonical_expr(e: L.Expr, top: int | None = None) -> L.Expr:
    """The normal form the query cache fingerprints (query/fingerprint.py):
    the full rule pipeline run to fixpoint, result only.  Rewriting before
    hashing means nesting and duplication differences the rules remove —
    ``(a & b) & c`` vs ``a & b & c``, ``x | x`` vs ``x`` — never split cache
    entries; the commutative child ordering itself is canonicalized inside
    the fingerprint, not here, so execution order is untouched."""
    return rewrite(e, top=top).expr


# ------------------------------------------------- physical-plan dead pruning
def prune_dead_nodes(plan) -> list:
    """Drop plan nodes unreachable from the output (shares the traversal
    with ``Plan.validate``).  Returns the removed node names."""
    return plan.prune_unreachable()
