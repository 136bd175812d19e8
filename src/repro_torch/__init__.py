"""BLEND on PyTorch and CUDA: the port of the JAX package ``repro``.

``import repro_torch as blend; blend.connect(lake).query(expr)`` — the same
names as the JAX package's ``blend`` module.  Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.
"""
from repro_torch.query import (And, BlendQLError, Compiled, Counter,
                               DEFAULT_RULES, Expr, Explain, Or, QueryResult,
                               Seek, Session, Sub, connect, corr, counter,
                               fingerprint_query, kw, lower, mc, parse,
                               recover, restore, rewrite, sc)

__all__ = [
    "And", "BlendQLError", "Compiled", "Counter", "DEFAULT_RULES", "Expr",
    "Explain", "Or", "QueryResult", "Seek", "Session", "Sub", "connect",
    "corr", "counter", "fingerprint_query", "kw", "lower", "mc", "parse",
    "recover", "restore", "rewrite", "sc",
]
