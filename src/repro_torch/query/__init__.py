"""BlendQL: the declarative query frontend over the BLEND engine.

Layering::

    blendql string --parse.py--> logical IR --rules.py--> canonical IR
                                   (logical.py)              |
    fluent expressions -----------------^          lower.py  v
                                                   physical Plan
                                                   (core/plan.py ->
                                                    core/optimizer.py ->
                                                    core/executor.py)

Entry points: ``connect(lake, **executor_opts) -> Session``;
``Session.query`` (fluent), ``Session.sql`` (BlendQL text),
``Session.explain`` (rule + plan + timing transcript).
"""
from repro_torch.query.logical import (And, Counter, Expr, Or, Seek, Sub,
                                       corr, counter, kw, mc, sc)
from repro_torch.query.lower import lower
from repro_torch.query.fingerprint import (fingerprint_expr, fingerprint_plan,
                                           fingerprint_query, index_epoch_key)
from repro_torch.query.parse import BlendQLError, parse
from repro_torch.query.rules import DEFAULT_RULES, rewrite
from repro_torch.query.session import (Compiled, Explain, QueryResult,
                                       Session, connect, recover, restore)

__all__ = [
    "And", "BlendQLError", "Compiled", "Counter", "DEFAULT_RULES", "Expr",
    "Explain", "Or", "QueryResult", "Seek", "Session", "Sub", "connect",
    "corr", "counter", "fingerprint_expr", "fingerprint_plan",
    "fingerprint_query", "index_epoch_key", "kw", "lower", "mc", "parse",
    "recover", "restore", "rewrite", "sc",
]
