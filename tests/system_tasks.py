"""The six end-to-end tasks of tests/test_system.py as functions of a
package's own modules, so that one definition runs on the JAX package and
on the port (on the CPU or the card).  This module imports neither
package: a task takes a namespace ``ns`` with

* ``lake``: the package's ``core.lake`` module,
* ``build_index``: its ``core.index.build_index``,
* ``executor(index)``: an ``Executor`` over ``index``,
* ``Plan``, ``Seekers``, ``Combiners``: its ``core.plan`` names,
* ``baselines``: its ``core.baselines`` module,
* ``pipeline``: its ``data.pipeline`` module,

and returns what the test's assertions read: the ranked ids as a list of
ints, each baseline's answer, and the lake and inputs they check against.
"""
from __future__ import annotations


def _ids(rs) -> list:
    return [int(t) for t in rs.ids()]


def negative_examples(ns) -> dict:
    """MC(positives) - MC(negatives) (the paper's Fig 1 / Table III)."""
    lake, tuples, _ = ns.lake.mc_joinable_lake(n_tables=60, seed=21)
    ex = ns.executor(ns.build_index(lake))
    pos, neg = tuples[:10], tuples[10:14]
    plan = ns.Plan()
    plan.add("pos", ns.Seekers.MC(pos, k=60))
    plan.add("neg", ns.Seekers.MC(neg, k=60))
    plan.add("out", ns.Combiners.Difference(k=20), ["pos", "neg"])
    rs, _ = ex.run(plan, optimize=True)
    return {"lake": lake, "pos": pos, "neg": neg, "ids": _ids(rs)}


def imputation(ns) -> dict:
    """MC(complete rows) & SC(partial column), and the federated MATE +
    JOSIE pipeline's answers on the same lake."""
    lake = ns.lake.synthetic_lake(n_tables=80, rows=30, vocab=500, seed=13)
    ex = ns.executor(ns.build_index(lake))
    t0 = lake.tables[5]
    complete = [(t0.columns[0][r], t0.columns[1][r]) for r in range(5)]
    partial = [t0.columns[0][r] for r in range(5, 15)]
    plan = ns.Plan()
    plan.add("examples", ns.Seekers.MC(complete, k=80))
    plan.add("query", ns.Seekers.SC(partial, k=80))
    plan.add("out", ns.Combiners.Intersect(k=10), ["examples", "query"])
    rs, _ = ex.run(plan, optimize=True)
    mate = ns.baselines.MateLike(lake).query(complete, k=80)
    josie = ns.baselines.JosieLike(lake).query(partial, k=80)
    return {"ids": _ids(rs), "mate": mate, "josie": josie}


def multi_objective(ns) -> dict:
    """Listing 4: keyword + union search + correlation, aggregated; the
    optimized and unoptimized runs."""
    lake = ns.lake.synthetic_lake(n_tables=60, rows=30, vocab=400, seed=17,
                                  numeric_cols=1)
    ex = ns.executor(ns.build_index(lake))
    t0 = lake.tables[0]
    plan = ns.Plan()
    plan.add("kw", ns.Seekers.KW([t0.columns[0][0], t0.columns[1][1]], k=10))
    for c in range(2):
        plan.add(f"col{c}", ns.Seekers.SC(list(t0.columns[c][:10]), k=30))
    plan.add("counter", ns.Combiners.Counter(k=10), ["col0", "col1"])
    plan.add("corr", ns.Seekers.Correlation(list(t0.columns[0][:20]),
                                            list(range(20)), k=10))
    plan.add("union", ns.Combiners.Union(k=40), ["kw", "counter", "corr"])
    rs_opt, _ = ex.run(plan, optimize=True)
    rs_no, _ = ex.run(plan, optimize=False)
    return {"ids": _ids(rs_opt), "ids_unoptimized": _ids(rs_no)}


def union_via_counter(ns) -> dict:
    """Union discovery = per-column SC seekers + Counter (paper §VII-A)."""
    lake, labels = ns.lake.unionable_lake(n_clusters=5, per_cluster=6, seed=3)
    ex = ns.executor(ns.build_index(lake))
    qi = 0
    qt = lake.tables[qi]
    plan = ns.Plan()
    for c in range(qt.n_cols):
        plan.add(f"c{c}", ns.Seekers.SC(list(qt.columns[c]), k=60))
    plan.add("out", ns.Combiners.Counter(k=10),
             [f"c{c}" for c in range(qt.n_cols)])
    rs, _ = ex.run(plan)
    return {"ids": _ids(rs), "labels": labels, "query": qi}


def correlation_vs_qcr(ns) -> dict:
    """The correlation seeker's top 10 and the QCR sketch baseline's."""
    lake, keys, target, truth = ns.lake.correlation_lake(n_tables=40, seed=23)
    ex = ns.executor(ns.build_index(lake))
    rs = ex.run_seeker(ns.Seekers.Correlation(keys, target, k=10, h=512))
    base = ns.baselines.QcrLike(lake, h=64).query(keys, target, k=10)
    return {"ids": _ids(rs)[:10], "qcr": base, "truth": truth}


def discovery_fed_pipeline(ns) -> dict:
    """BLEND selects tables -> tokenize -> deterministic batches."""
    lake = ns.lake.synthetic_lake(n_tables=40, rows=20, vocab=300, seed=29)
    ex = ns.executor(ns.build_index(lake))
    plan = ns.Plan()
    plan.add("kw", ns.Seekers.KW([lake.tables[3].columns[0][0]], k=8))
    tabs = ns.pipeline.select_tables(lake, plan, ex)
    toks = ns.pipeline.tokenize_tables(tabs, vocab=512)
    stream = ns.pipeline.TokenStream(toks, batch=2, seq_len=16, seed=1)
    slot = {id(t): i for i, t in enumerate(lake.tables)}
    return {"ids": [slot[id(t)] for t in tabs], "tokens": toks,
            "batches": [stream.batch_at(s)["tokens"] for s in (0, 5, 5, 9)]}


TASKS = {
    "negative_examples": negative_examples,
    "imputation": imputation,
    "multi_objective": multi_objective,
    "union_via_counter": union_via_counter,
    "correlation_vs_qcr": correlation_vs_qcr,
    "discovery_fed_pipeline": discovery_fed_pipeline,
}
