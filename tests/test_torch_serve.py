"""repro_torch's discovery engine on the CPU (``serve/engine.py``:
``DiscoveryEngine.serve`` / ``serve_many``), against the JAX package's
engine (its ``sorted`` backend: its ``bucket`` backend does not trace on
this JAX), sequential ``serve`` and tests/oracle.py, on both port backends.

The cases are the JAX package's engine cases: tests/test_match_engine.py
(``serve_many`` equals serial ``serve``), tests/test_blendql.py (the
response carries the ExecInfo), tests/test_fused.py (fused ``serve_many``
builds no new program, cached seekers drop out of the fused batch, the
epoch invalidates the cache on the fused path, fused and unfused batches
agree, launches surface in responses and ``explain``) and
tests/test_livelake.py (the engine's mutations; the exact half of the
cached live session's parity through mutations).  Their request builders
run with their modules' names bound to the port's objects.
"""
import types

import numpy as np
import pytest
import torch

import blend as ref_blend
import repro_torch as blend
import test_match_engine
from examples import serve_discovery
from repro.core.lake import Table as RefTable
from repro.core.lake import synthetic_lake
from repro.core.plan import Plan as RefPlan
from repro.core.plan import Seekers as RefSeekers
from repro.serve.engine import DiscoveryEngine as RefEngine
from repro_torch.core import seekers as seek
from repro_torch.core.lake import Table
from repro_torch.core.plan import Combiners, Plan, Seekers
from repro_torch.serve.engine import DiscoveryEngine, to_host

from oracle import oracle_run
from test_livelake import extra_table, small_live_lake

BACKENDS = ("sorted", "bucket")


def _rebind(fn, **names):
    """``fn`` with some of its module's names bound to the port's."""
    return types.FunctionType(fn.__code__, {**fn.__globals__, **names},
                              fn.__name__, fn.__defaults__, fn.__closure__)


mixed_plan = _rebind(test_match_engine._mixed_plan, Plan=Plan,
                     Seekers=Seekers, Combiners=Combiners)
build_request = _rebind(serve_discovery.build_request, blend=blend)


def _engine(lake, backend, **kw):
    return DiscoveryEngine(lake, backend=backend, device="cpu", **kw)


def _same(got, want, msg=""):
    """Port response == JAX response: ids, scores, overflow, launches."""
    assert got.table_ids == want.table_ids, msg
    np.testing.assert_array_equal(got.scores, np.asarray(want.scores),
                                  err_msg=msg)
    assert got.overflow == want.overflow, msg
    assert got.launches == want.launches, msg


def _bitwise(a, b, msg=""):
    """Two port responses agree bit for bit."""
    assert a.table_ids == b.table_ids, msg
    assert a.scores.dtype == b.scores.dtype == np.float32
    np.testing.assert_array_equal(a.scores, b.scores, err_msg=msg)
    assert a.overflow == b.overflow, msg


@pytest.fixture(scope="module")
def fused_lake():
    """tests/test_fused.py's lake."""
    return synthetic_lake(n_tables=24, rows=16, cols=4, vocab=300, seed=11)


def test_to_host_is_one_exact_copy_of_mixed_dtypes():
    gen = torch.Generator().manual_seed(0)
    parts = [torch.rand(7, generator=gen), torch.rand(5, generator=gen) > .5,
             torch.randint(0, 9, (3,), generator=gen, dtype=torch.int64),
             torch.rand(2, 3, generator=gen), torch.zeros(0)]
    got = to_host(parts)
    for g, t in zip(got, parts):
        np.testing.assert_array_equal(g, t.reshape(-1).numpy())
        assert g.dtype == t.numpy().dtype and g.flags.owndata
    assert to_host([]) == []


# ------------------------------------------------ tests/test_match_engine.py

@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_many_matches_serial(backend):
    """``serve_many`` (unfused and fused) equals serial ``serve`` bit for
    bit, and the JAX package's engine; unoptimized, the oracle."""
    lake = synthetic_lake(n_tables=40, rows=20, vocab=300, seed=11)
    eng, ref = _engine(lake, backend), RefEngine(lake)
    rng, ref_rng = np.random.default_rng(1), np.random.default_rng(1)
    plans = [mixed_plan(lake, rng, 8, 4) for _ in range(4)]
    ref_plans = [test_match_engine._mixed_plan(lake, ref_rng, 8, 4)
                 for _ in range(4)]
    serial = [eng.serve(p) for p in plans]
    for fused in (False, True):
        for a, b, p, rp in zip(serial, eng.serve_many(plans, fused=fused),
                               plans, ref_plans):
            _bitwise(a, b, f"fused={fused}")
            _same(a, ref.serve(rp))
    for p in plans:
        scores, mask = oracle_run(lake, eng.session.compile(p).plan)
        got = eng.serve(p, optimize=False)
        np.testing.assert_array_equal(got.scores, scores)
        assert got.table_ids == [int(t) for t in np.nonzero(mask)[0][
            np.argsort(-scores[mask], kind="stable")]]


# ---------------------------------------------------- tests/test_blendql.py

@pytest.mark.parametrize("backend", BACKENDS)
def test_discovery_response_carries_exec_info(small_lake, backend):
    engine, ref = _engine(small_lake, backend), RefEngine(small_lake)
    t = small_lake.tables[3]

    def expr(b):
        return (b.mc([(t.columns[0][r], t.columns[1][r]) for r in range(4)],
                     k=30)
                & b.sc(list(t.columns[0][:8]), k=30)).top(10)

    r, want = engine.serve(expr(blend)), ref.serve(expr(ref_blend))
    assert r.table_ids and r.order and r.node_seconds
    assert set(r.node_seconds) == set(r.order)   # every run node is timed
    assert r.overflow >= 0 and r.total_node_seconds > 0
    assert r.applied_rules                            # push_limit at least
    _same(r, want)
    assert r.order == want.order and r.applied_rules == want.applied_rules
    assert r.plan_nodes == want.plan_nodes
    batch = engine.serve_many([expr(blend), expr(blend).to_sql()])
    assert all(b.order and b.node_seconds for b in batch)
    for b in batch:
        _bitwise(b, r)


# ------------------------------------------------------ tests/test_fused.py

@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_serve_many_zero_retrace(fused_lake, backend):
    lake = fused_lake
    engine, ref = _engine(lake, backend), RefEngine(lake)

    def batch(b, tabs):
        return [(b.sc(list(lake.tables[t].columns[0][:6]), k=12)
                 & b.kw([lake.tables[t].columns[1][0]], k=12)).top(8)
                for t in tabs]

    engine.serve_many(batch(blend, (2, 4, 6)), fused=True)
    before = dict(seek.TRACE_COUNTS)
    got = engine.serve_many(batch(blend, (8, 10, 12)), fused=True)
    assert dict(seek.TRACE_COUNTS) == before
    want = ref.serve_many(batch(ref_blend, (8, 10, 12)), fused=True)
    for g, w, q in zip(got, want, batch(blend, (8, 10, 12))):
        _same(g, w)
        _bitwise(g, engine.serve(q))


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_cached_seekers_drop_out_of_batch(fused_lake, backend):
    lake = fused_lake
    session = blend.connect(lake, cache=True, backend=backend, device="cpu")
    cold = blend.connect(lake, backend=backend, device="cpu")
    ref = ref_blend.connect(lake, cache=True)
    t = lake.tables[2]

    def queries(b):
        sc = b.sc(list(t.columns[0][:8]), k=20)
        return ((sc | b.kw([t.columns[1][0]], k=20)).top(10),
                (sc | b.mc([(t.columns[0][r], t.columns[1][r])
                            for r in range(4)], k=20)).top(10))

    (q1, q2), (rq1, rq2) = queries(blend), queries(ref_blend)
    r1 = session.query(q1, fused=True)
    assert r1.cache.status == "miss" and r1.info.seeker_runs == 2
    r2 = session.query(q2, fused=True)                 # shares sc: partial
    assert r2.cache.status == "partial"
    assert r2.info.cached_nodes and r2.info.seeker_runs == 1
    want = cold.query(q2)
    assert r2.ids == want.ids and torch.equal(r2.scores, want.scores)
    r3 = session.query(q2, fused=True)                 # exact-result hit
    assert r3.cache.status == "hit" and r3.ids == r2.ids
    for got, rq in ((r1, rq1), (r2, rq2), (r3, rq2)):
        w = ref.query(rq, fused=True)
        assert got.cache.as_dict() == w.cache.as_dict()
        assert got.ids == w.ids
        np.testing.assert_array_equal(got.scores.numpy(),
                                      np.asarray(w.scores))
        assert got.info.cached_nodes == w.info.cached_nodes


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_cache_epoch_invalidation(fused_lake, backend):
    lake = fused_lake
    session = blend.connect(lake, live=True, cache=True, backend=backend,
                            device="cpu")
    ref = ref_blend.connect(lake, live=True, cache=True)
    t = lake.tables[2]

    def query(b):
        return (b.sc(list(t.columns[0][:6]), k=20)
                & b.kw([t.columns[1][0]], k=20)).top(10)

    session.query(query(blend), fused=True)
    ref.query(query(ref_blend), fused=True)
    cols = [[t.columns[0][0], "zq1"], ["zq2", "zq3"]]
    tid = session.add_table(Table("fx_inv", cols))
    assert ref.add_table(RefTable("fx_inv", cols)) == tid
    r = session.query(query(blend), fused=True)        # epoch moved: cold
    assert r.cache.status == "miss"
    cold = blend.connect(session.live, live=True, backend=backend,
                         device="cpu")
    want = cold.query(query(blend))
    assert r.ids == want.ids and torch.equal(r.scores, want.scores)
    w = ref.query(query(ref_blend), fused=True)
    assert w.cache.status == "miss" and r.ids == w.ids
    np.testing.assert_array_equal(r.scores.numpy(), np.asarray(w.scores))
    session.drop_table(tid)
    assert session.query(query(blend), fused=True).cache.status == "miss"


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_serve_many_parity_and_launches(fused_lake, backend):
    lake = fused_lake
    engine, ref = _engine(lake, backend), RefEngine(lake)
    kinds = ["imputation", "union", "enrichment"]
    rng, ref_rng = np.random.default_rng(0), np.random.default_rng(0)
    reqs = [build_request(lake, rng, kinds[i % 3]) for i in range(6)]
    ref_reqs = [serve_discovery.build_request(lake, ref_rng, kinds[i % 3])
                for i in range(6)]
    unfused = engine.serve_many(reqs)
    fused = engine.serve_many(reqs, fused=True)
    ref_fused = ref.serve_many(ref_reqs, fused=True)
    for a, b, w, q in zip(unfused, fused, ref_fused, reqs):
        _bitwise(a, b)
        assert 0 < b.launches <= 4 + 1
        assert b.launches <= a.launches
        _same(b, w)
        _bitwise(b, engine.serve(q, fused=True))


@pytest.mark.parametrize("backend", BACKENDS)
def test_launches_surfaced_in_response_and_explain(fused_lake, backend):
    lake = fused_lake
    session = blend.connect(lake, backend=backend, device="cpu")
    t = lake.tables[2]
    q = (blend.sc(list(t.columns[0][:6]), k=12)
         & blend.kw([t.columns[1][0]], k=12)).top(8)
    engine = DiscoveryEngine(lake, session=session)
    r_u = engine.serve(q)
    r_f = engine.serve(q, fused=True)
    assert r_u.launches >= 3                    # 2 seekers + combiner
    assert r_f.launches == 3                    # SC group + KW group + DAG
    _bitwise(r_f, r_u)
    assert "launches: 3" in str(session.explain(q, fused=True))
    with pytest.raises(ValueError, match="session"):
        DiscoveryEngine(lake, session=session, device="cpu")


# --------------------------------------------------- tests/test_livelake.py

@pytest.mark.parametrize("backend", BACKENDS)
def test_discovery_engine_live_mutations(backend):
    lake = small_live_lake()
    eng = _engine(lake, backend, live=True)
    ref = RefEngine(lake, live=True)
    t = extra_table(0)
    tid = eng.add_table(t)
    assert ref.add_table(t) == tid

    def both(q):
        got = eng.serve(blend.kw(q, k=30))
        _same(got, ref.serve(ref_blend.kw(q, k=30)))
        return got.table_ids

    assert tid in both([t.columns[0][0]])
    eng.drop_table(tid)
    ref.drop_table(tid)
    assert tid not in both([t.columns[0][0]])
    eng.compact()
    ref.compact()
    both([t.columns[0][0], lake.tables[2].columns[0][0]])
    static = _engine(lake, backend)
    with pytest.raises(RuntimeError, match="live=True"):
        static.add_table(t)


@pytest.mark.parametrize("backend", BACKENDS)
def test_cached_live_session_exact_parity_through_mutations(backend):
    """The exact half of tests/test_livelake.py's cached live session
    through mutations: every spec's ids and scores, cached, equal the JAX
    package's cached live session at every stage; ``approx=`` raises
    (ROADMAP queue A, item A7)."""
    lake = small_live_lake(seed=65)
    session = blend.connect(lake, live=True, cache=True, backend=backend,
                            device="cpu")
    ref = ref_blend.connect(lake, live=True, cache=True)
    vals = list(lake.tables[3].columns[0][:8])
    target = [float(i) for i in range(8)]

    def plans(plan_cls, seekers):
        out = []
        for spec in (seekers.SC(vals, k=10), seekers.KW(vals, k=10),
                     seekers.Correlation(vals, target, k=10, h=64)):
            p = plan_cls()
            p.add("out", spec)
            out.append(p)
        return out

    def check(stage):
        for p, rp in zip(plans(Plan, Seekers), plans(RefPlan, RefSeekers)):
            for _ in range(2):
                got, want = session.query(p), ref.query(rp)
                assert got.cache.status == want.cache.status, stage
                assert got.ids == want.ids, stage
                np.testing.assert_array_equal(got.scores.numpy(),
                                              np.asarray(want.scores))

    check("initial")
    for s in (session, ref):
        s.add_table(extra_table(6))
    check("after add")
    for s in (session, ref):
        s.drop_table(lake.n_tables)
        s.drop_table(5)
    check("after drop")
    for s in (session, ref):
        s.compact()
    check("after compact")
    with pytest.raises(NotImplementedError, match="ROADMAP.*A7"):
        session.query(plans(Plan, Seekers)[0], approx={"epsilon": 0.0})
