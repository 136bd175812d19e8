"""tests/test_system.py's six end-to-end tasks on repro_torch, on the CPU,
against the JAX package: the four complex discovery tasks of Table III,
system-vs-baseline agreement, and the discovery-fed training pipeline
(``repro_torch.data.pipeline``).

Each task (``tests/system_tasks.py``) runs once on the JAX package's
modules (``sorted`` backend, its default) and once on the port's, on both
port backends: the port's ids equal the JAX package's exactly, and every
property tests/test_system.py asserts holds for the port's answer.  The
port's baselines (``repro_torch.core.baselines``) return exactly the JAX
package's ``query`` answers and ``storage_bytes``; tokens and batches are
equal array for array.  The storage comparison of tests/test_index.py:73
runs against the port's ``UnifiedIndex``.
"""
import functools
import types

import numpy as np
import pytest

from repro.core import baselines as ref_baselines
from repro.core import lake as ref_lake
from repro.core import plan as ref_plan
from repro.core.executor import Executor as RefExecutor
from repro.core.index import build_index as ref_build_index
from repro.data import pipeline as ref_pipeline
from repro_torch.core import baselines, lake as port_lake, plan as port_plan
from repro_torch.core.executor import Executor
from repro_torch.core.index import build_index
from repro_torch.data import pipeline

from conftest import brute_force_mc
import system_tasks

BACKENDS = ("sorted", "bucket")
TASKS = sorted(system_tasks.TASKS)


def _ns(lake, plan, build, executor, base, pipe):
    return types.SimpleNamespace(
        lake=lake, build_index=build, executor=executor, Plan=plan.Plan,
        Seekers=plan.Seekers, Combiners=plan.Combiners, baselines=base,
        pipeline=pipe)


REF = _ns(ref_lake, ref_plan, ref_build_index, RefExecutor, ref_baselines,
          ref_pipeline)


def port_ns(backend):
    return _ns(port_lake, port_plan, build_index,
               lambda idx: Executor(idx, backend=backend, device="cpu"),
               baselines, pipeline)


@functools.lru_cache(maxsize=None)
def _ref(task):
    return system_tasks.TASKS[task](REF)


@functools.lru_cache(maxsize=None)
def _port(task, backend):
    return system_tasks.TASKS[task](port_ns(backend))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("task", TASKS)
def test_task_ids_equal_jax(task, backend):
    want, got = _ref(task), _port(task, backend)
    assert got["ids"] == want["ids"]
    for key in ("mate", "josie", "qcr", "ids_unoptimized"):
        if key in want:
            assert got[key] == want[key], key


@pytest.mark.parametrize("backend", BACKENDS)
def test_negative_examples_task(backend):
    r = _port("negative_examples", backend)
    lake = r["lake"]
    got = set(r["ids"])
    pos_t = set(np.nonzero(brute_force_mc(lake, r["pos"]))[0].tolist())
    neg_t = set(np.nonzero(brute_force_mc(lake, r["neg"]))[0].tolist())
    assert got and got <= pos_t - neg_t


@pytest.mark.parametrize("backend", BACKENDS)
def test_imputation_task_matches_federated_baseline(backend):
    r = _port("imputation", backend)
    blend_ids = set(r["ids"])
    assert blend_ids <= (set(r["mate"][0]) & set(r["josie"]))
    assert 5 in blend_ids                       # the source table must win


@pytest.mark.parametrize("backend", BACKENDS)
def test_multi_objective_plan_runs(backend):
    r = _port("multi_objective", backend)
    assert set(r["ids"]) == set(r["ids_unoptimized"])
    assert len(r["ids"]) > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_union_search_via_counter(backend):
    r = _port("union_via_counter", backend)
    labels, qi = r["labels"], r["query"]
    ids = [t for t in r["ids"] if t != qi][:5]
    assert sum(labels[t] == labels[qi] for t in ids) >= 4, (ids, labels[ids])


@pytest.mark.parametrize("backend", BACKENDS)
def test_correlation_vs_qcr_baseline(backend):
    r = _port("correlation_vs_qcr", backend)
    truth = r["truth"]
    assert truth[r["ids"]].mean() >= truth[r["qcr"]].mean() - 0.1


@pytest.mark.parametrize("backend", BACKENDS)
def test_discovery_fed_training_pipeline(backend):
    r, want = _port("discovery_fed_pipeline", backend), \
        _ref("discovery_fed_pipeline")
    assert 1 <= len(r["ids"]) <= 8
    assert r["tokens"].dtype == np.int32
    np.testing.assert_array_equal(r["tokens"], want["tokens"])
    b = r["batches"]
    np.testing.assert_array_equal(b[1], b[2])   # step-indexed: replayable
    assert b[0].shape == (2, 16) and b[0].dtype == np.int32
    for got, ref in zip(b, want["batches"]):
        np.testing.assert_array_equal(got, ref)


def test_select_tables_returns_the_lakes_tables():
    """``select_tables`` hands back the lake's own table objects, in the
    executor's ranked order."""
    lake = port_lake.synthetic_lake(n_tables=40, rows=20, vocab=300, seed=29)
    ex = Executor(build_index(lake), device="cpu")
    plan = port_plan.Plan()
    plan.add("kw", port_plan.Seekers.KW([lake.tables[3].columns[0][0]], k=8))
    tabs = pipeline.select_tables(lake, plan, ex)
    rs, _ = ex.run(plan, optimize=True)
    assert [id(t) for t in tabs] == [id(lake.tables[int(i)])
                                     for i in rs.ids()]


# ---------------------------------------------------------------- baselines

LAKES = {
    "small": lambda m: m.synthetic_lake(n_tables=60, rows=24, cols=4,
                                        vocab=800, seed=7),
    "numeric": lambda m: m.synthetic_lake(n_tables=50, rows=30, vocab=400,
                                          seed=17, numeric_cols=1),
    "correlation": lambda m: m.correlation_lake(n_tables=30, seed=23)[0],
}


@pytest.mark.parametrize("name", sorted(LAKES))
def test_baselines_equal_jax(name):
    ref, port = LAKES[name](ref_lake), LAKES[name](port_lake)
    t0 = port.tables[1]
    values = list(t0.columns[0][:12])
    tuples = [(t0.columns[0][r], t0.columns[1][r]) for r in range(8)]
    target = [float(i % 7) for i in range(len(t0.columns[0]))]
    for cls, query in (
            ("JosieLike", lambda b: b.query(values, k=10)),
            ("MateLike", lambda b: b.query(tuples, k=10)),
            ("MateLike", lambda b: b.query(tuples, k=10, allowed={1, 2, 3})),
            ("QcrLike", lambda b: b.query(list(t0.columns[0]), target,
                                          k=10)),
            ("UnionBaseline", lambda b: b.query(1, k=10))):
        want = getattr(ref_baselines, cls)(ref)
        got = getattr(baselines, cls)(port)
        assert got.storage_bytes() == want.storage_bytes(), cls
        assert query(got) == query(want), cls


def test_storage_smaller_than_baselines():
    """tests/test_index.py:73 on the port: the unified index is leaner than
    the sum of standalone indexes (Table VIII claim, at test scale)."""
    lake = port_lake.synthetic_lake(n_tables=60, rows=24, cols=4, vocab=800,
                                    seed=7)
    combined = (baselines.JosieLike(lake).storage_bytes()
                + baselines.MateLike(lake).storage_bytes()
                + baselines.QcrLike(lake).storage_bytes()
                + baselines.UnionBaseline(lake).storage_bytes())
    index = build_index(lake)
    assert index.storage_bytes() < combined
    assert index.storage_bytes() == ref_build_index(
        ref_lake.synthetic_lake(n_tables=60, rows=24, cols=4, vocab=800,
                                seed=7)).storage_bytes()
