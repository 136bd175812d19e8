"""repro_torch's fused path on the CPU, against the port's unfused walk, the
JAX package's ``sorted`` fused path and tests/oracle.py, bit for bit.

Plans and the lake come from tests/test_fused.py (``flat_plan``,
``deep_plan``, ``seekers_for``); the index arrays are handed to both systems
(``UnifiedIndex.from_numpy``).  The reference ``bucket`` engine does not
trace on this JAX, so the reference side always runs ``backend="sorted"``.
On the CPU each fused program runs eagerly; the program cache still marks
each new key in ``seekers.TRACE_COUNTS``, so the reference's
retrace-freedom contracts are checked here as key discipline.
"""
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

import blend as ref_blend
import repro_torch as blend
from repro.core.executor import Executor as RefExecutor
from repro.core.index import build_index as ref_build_index
from repro.core.plan import CombinerSpec, Combiners, Plan, Seekers
from repro.query import logical as ref_logical
from repro_torch.core import seekers as seek
from repro_torch.core.executor import ExecInfo, Executor
from repro_torch.core.index import UnifiedIndex, hash_keys
from repro_torch.query import logical as port_logical

from oracle import oracle_ids, oracle_run
from test_fused import deep_plan, flat_plan, lake, plan_trees  # noqa: F401

BACKENDS = ("sorted", "bucket")
COMBINERS = ("intersect", "union", "counter", "difference")


@pytest.fixture(scope="module")
def ref_ex(lake):
    return RefExecutor(ref_build_index(lake))


def _port_ex(ref_ex, backend):
    return Executor(UnifiedIndex.from_numpy(vars(ref_ex.index)),
                    backend=backend, device="cpu")


@pytest.fixture(scope="module")
def port_ex(ref_ex):
    return {b: _port_ex(ref_ex, b) for b in BACKENDS}


def _same(rs, ref_rs, msg=""):
    np.testing.assert_array_equal(rs.scores.numpy(),
                                  np.asarray(ref_rs.scores), err_msg=msg)
    np.testing.assert_array_equal(rs.mask.numpy(), np.asarray(ref_rs.mask),
                                  err_msg=msg)


def assert_fused_parity(ref_ex, ex, plan, optimize=True):
    """Port fused == port unfused == reference fused (``sorted``): scores,
    masks, ids, overflow, order; launches and node_seconds keys equal the
    reference's fused run."""
    a, ia = ex.run(plan, optimize=optimize)
    b, ib = ex.run(plan, optimize=optimize, fused=True)
    c, ic = ref_ex.run(plan, optimize=optimize, fused=True)
    _same(a, c)
    _same(b, c)
    assert [int(t) for t in b.ids()] == [int(t) for t in c.ids()] == \
        [int(t) for t in a.ids()]
    assert ib.overflow == ia.overflow == ic.overflow
    assert ib.order == ia.order == ic.order
    assert ib.launches == ic.launches
    assert set(ib.node_seconds) == set(ic.node_seconds)
    return ia, ib


# --------------------------------------------------------------- parity

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("optimize", [True, False])
@pytest.mark.parametrize("comb", COMBINERS)
def test_fused_parity_flat_plan(lake, ref_ex, port_ex, backend, comb,
                                optimize):
    ia, ib = assert_fused_parity(ref_ex, port_ex[backend],
                                 flat_plan(lake, comb), optimize)
    assert ib.launches <= 4 + 1                  # n_kinds + 1
    assert ib.launches < ia.launches or ia.launches <= ib.launches == 5


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("optimize", [True, False])
def test_fused_deep_dag_parity_and_launches(lake, ref_ex, port_ex, backend,
                                            optimize):
    ia, ib = assert_fused_parity(ref_ex, port_ex[backend], deep_plan(lake),
                                 optimize)
    assert ib.launches <= 4 + 1
    assert ia.launches > ib.launches


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_same_kind_multiple_groups(lake, ref_ex, port_ex, backend):
    """MC n_cols 2 and 3 are two device programs: launches = 2 + 1 and
    each group keeps its own node_seconds entry."""
    t = lake.tables[2]
    p = Plan()
    p.add("mc2", Seekers.MC([(t.columns[0][r], t.columns[1][r])
                             for r in range(4)], k=12))
    p.add("mc3", Seekers.MC([(t.columns[0][r], t.columns[1][r],
                              t.columns[2][r]) for r in range(4)], k=12))
    p.add("root", Combiners.Union(k=8), ["mc2", "mc3"])
    _, ib = assert_fused_parity(ref_ex, port_ex[backend], p)
    assert ib.launches == 2 + 1
    assert {"fused:MC/2", "fused:MC/3"} <= set(ib.node_seconds)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", ["sc", "kw", "mc", "c"])
def test_fused_single_seeker_plan(lake, ref_ex, port_ex, backend, kind):
    from test_fused import seekers_for
    plan = Plan()
    plan.add("solo", seekers_for(lake)[kind])
    _, ib = assert_fused_parity(ref_ex, port_ex[backend], plan)
    assert ib.launches == 2                      # one group + the DAG top-k


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", ["union", "intersect", "counter"])
def test_fused_cut_free_combiner_k_none(lake, ref_ex, port_ex, backend,
                                        kind):
    t = lake.tables[2]
    p = Plan()
    p.add("sc", Seekers.SC(t.columns[0][:6], k=12))
    p.add("kw", Seekers.KW([t.columns[1][0]], k=12))
    p.add("root", CombinerSpec(kind, None), ["sc", "kw"])
    assert_fused_parity(ref_ex, port_ex[backend], p)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("comb", COMBINERS)
def test_fused_matches_oracle(lake, ref_ex, port_ex, backend, comb):
    plan = flat_plan(lake, comb)
    rs, _ = port_ex[backend].run(plan, optimize=False, fused=True)
    scores, mask = oracle_run(lake, plan)
    np.testing.assert_array_equal(rs.scores.numpy(), scores)
    assert [int(t) for t in rs.ids()] == oracle_ids(scores, mask)


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_many_equals_single_runs_and_overflow_in_one_fetch(
        lake, ref_ex, port_ex, backend):
    """A batch of plans shares its group launches; each plan's result and
    overflow equal its own fused run, and ``materialize_overflow`` resolves
    the whole batch at once."""
    ex = port_ex[backend]
    plans = [flat_plan(lake, c, tab=tab)
             for c, tab in zip(COMBINERS, (2, 5, 9, 2))] + [deep_plan(lake)]
    outs = ex.run_many(plans)
    ref_outs = ref_ex.run_many(plans)
    ExecInfo.materialize_overflow([info for _, info in outs])
    for plan, (rs, info), (ref_rs, ref_info) in zip(plans, outs, ref_outs):
        single, single_info = ex.run(plan, fused=True)
        _same(rs, ref_rs)
        np.testing.assert_array_equal(rs.scores.numpy(),
                                      single.scores.numpy())
        assert info._overflow is not None
        assert info.overflow == single_info.overflow == ref_info.overflow
        assert (info.order, info.launches, info.seeker_runs) == \
            (ref_info.order, ref_info.launches, ref_info.seeker_runs)


# ------------------------------------------- the modules under the path

def test_scatters_drop_out_of_range_keys_like_jax():
    """The dump-slot scatters equal ``.at[key].add/max(mode="drop")`` for
    the keys the seekers make (never negative: JAX would wrap those)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    key = rng.integers(0, 50, 400)
    vals = rng.integers(0, 2, 400).astype(np.float32)
    want_add = jnp.zeros(40, jnp.float32).at[key].add(vals, mode="drop")
    want_max = jnp.zeros(40, jnp.float32).at[key].max(vals, mode="drop")
    got_add = seek._scatter_add(40, torch.from_numpy(key),
                                torch.from_numpy(vals))
    got_max = seek._scatter_max(40, torch.from_numpy(key),
                                torch.from_numpy(vals))
    np.testing.assert_array_equal(got_add.numpy(), np.asarray(want_add))
    np.testing.assert_array_equal(got_max.numpy(), np.asarray(want_max))


@pytest.mark.parametrize("backend", BACKENDS)
def test_probe_capped_matches_reference(ref_ex, port_ex, backend):
    rng = np.random.default_rng(3)
    idx = ref_ex.index
    q = np.concatenate([rng.choice(idx.cell_hash, 40),
                        rng.integers(0, 2 ** 32, 8, dtype=np.uint32)])
    q_mask = rng.random(len(q)) < 0.9
    caps = rng.choice([1, 2, 4, 8], len(q)).astype(np.int32)
    want = ref_ex.engine.probe_capped(q, q_mask, 8, caps)
    got = port_ex[backend].engine.probe_capped(
        torch.from_numpy(hash_keys(q)), torch.from_numpy(q_mask), 8,
        torch.from_numpy(caps))
    valid = np.asarray(want[1])
    assert valid.any() and (np.asarray(want[2]) > 0).any()
    np.testing.assert_array_equal(got[1].numpy(), valid)
    np.testing.assert_array_equal(got[0].numpy()[valid],
                                  np.asarray(want[0])[valid])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_segmented_seekers_match_reference(lake, ref_ex, port_ex, backend):
    """Each seeker group's stacked [n_seekers, n_tables] scores and
    overflow vector equal the reference's ``*_seeker_seg`` on the same
    batch (both hashed and padded by their own ``_hash_tasks`` /
    ``_launch_group``)."""
    from repro.core import fused as ref_fused
    from repro_torch.core import fused as port_fused
    t = lake.tables[4]
    plan = deep_plan(lake)
    plan.add("mc3", Seekers.MC([(t.columns[0][r], t.columns[1][r],
                                 t.columns[2][r]) for r in range(5)], k=9))
    plan.add("c8", Seekers.Correlation(list(t.columns[0][:9]),
                                       [float(i) for i in range(9)], k=9,
                                       h=8, sampling="rand"))
    plan.add("top", Combiners.Union(k=9), ["root", "mc3", "c8"])
    plan.output = "top"

    def groups(mod, ex):
        pr = mod._compile_plan(plan, False, None, None, 0)
        mod._hash_tasks(ex, pr.tasks)
        keys = {}
        for task in pr.tasks:
            keys.setdefault(mod._group_key(task.spec), []).append(task)
        return {k: mod._launch_group(ex, k, v) for k, v in keys.items()}

    got = groups(port_fused, port_ex[backend])
    want = groups(ref_fused, ref_ex)
    assert set(got) == set(want) and len(got) == 6
    for key, (scores, ovf) in want.items():
        np.testing.assert_array_equal(got[key][0].numpy(),
                                      np.asarray(scores), err_msg=str(key))
        np.testing.assert_array_equal(got[key][1].numpy(), np.asarray(ovf),
                                      err_msg=str(key))


# ------------------------------------------------- program-key discipline

def test_fused_zero_new_programs_within_buckets(lake, ref_ex):
    """New values in the same capacity / width buckets build no program,
    as they make no new trace in the reference."""
    for backend in BACKENDS:
        ex = _port_ex(ref_ex, backend)
        start = dict(seek.TRACE_COUNTS)
        ex.run(deep_plan(lake, tab=2), fused=True)        # warm
        ref_ex.run(deep_plan(lake, tab=2), fused=True)
        warm = dict(seek.TRACE_COUNTS)
        for kind in ("SC_seg", "KW_seg", "MC_seg", "C_seg", "DAG"):
            assert warm.get(kind, 0) > start.get(kind, 0), kind
        n_programs = len(ex.programs)
        from repro.core import seekers as ref_seek
        ref_before = dict(ref_seek.TRACE_COUNTS)
        for tab in (5, 9, 14):                          # new values
            ex.run(deep_plan(lake, tab=tab), fused=True)
            ref_ex.run(deep_plan(lake, tab=tab), fused=True)
        assert dict(seek.TRACE_COUNTS) == warm
        assert len(ex.programs) == n_programs
        assert dict(ref_seek.TRACE_COUNTS) == ref_before


def _qa(api, lake, tab):
    t = lake.tables[tab]
    return (api.sc(list(t.columns[0][:6]), k=12)
            & api.kw([t.columns[1][0]], k=12)).top(8)


def _qb(api, lake, tab):
    t = lake.tables[tab]
    return (api.mc([(t.columns[0][r], t.columns[1][r]) for r in range(3)],
                   k=12) | api.kw([t.columns[1][0]], k=12)).top(8)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_batch_reorder_reuses_programs(lake, backend):
    session = blend.connect(lake, backend=backend, device="cpu")
    session.query_many([_qa(blend, lake, 2), _qb(blend, lake, 4)])
    before = dict(seek.TRACE_COUNTS)
    got = session.query_many([_qb(blend, lake, 6), _qa(blend, lake, 8)])
    assert dict(seek.TRACE_COUNTS) == before
    want = ref_blend.connect(lake).query_many(
        [_qb(ref_blend, lake, 6), _qa(ref_blend, lake, 8)])
    for g, w in zip(got, want):
        assert g.ids == w.ids
        np.testing.assert_array_equal(g.scores.numpy(), np.asarray(w.scores))


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_batch_dedupes_identical_seekers(lake, backend):
    """Identical seekers across a batch collapse onto one batch row: the
    seeker-count bucket stays at the deduped width (no new program) and the
    results equal a single unfused query."""
    session = blend.connect(lake, backend=backend, device="cpu")
    q = _qa(blend, lake, 3)
    session.query_many([q])
    before = dict(seek.TRACE_COUNTS)
    rs = session.query_many([q, q, q])
    assert dict(seek.TRACE_COUNTS) == before
    cold = session.query(q)
    assert rs[0].ids == rs[1].ids == rs[2].ids == cold.ids
    assert [r.info.seeker_runs for r in rs] == [2, 2, 2]


# ------------------------------------------------------- the Session

def _mixed(api, lake):
    t = lake.tables[4]
    return [_qa(api, lake, 2), _qb(api, lake, 5),
            (api.corr(list(t.columns[0][:8]), list(map(float, range(8))),
                      k=12) - api.kw([t.columns[1][1]], k=12)).top(6),
            api.counter(api.sc(list(t.columns[0][:5]), k=12),
                        api.kw([t.columns[2][0]], k=12)).top(10),
            "SELECT TOP 5 TABLES WHERE kw('tok_1', 'tok_2', k=10)"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fused", [True, False])
def test_query_many_matches_sequential_query(lake, backend, fused):
    session = blend.connect(lake, backend=backend, device="cpu")
    got = session.query_many(_mixed(blend, lake), fused=fused)
    seq = [session.query(q) for q in _mixed(blend, lake)]
    want = ref_blend.connect(lake).query_many(_mixed(ref_blend, lake),
                                              fused=fused)
    assert len(got) == len(seq) == len(want) == 5
    for g, s, w in zip(got, seq, want):
        assert g.ids == s.ids == w.ids
        np.testing.assert_array_equal(g.scores.numpy(), s.scores.numpy())
        np.testing.assert_array_equal(g.scores.numpy(), np.asarray(w.scores))
        assert (g.info.launches, g.info.overflow) == \
            (w.info.launches, w.info.overflow)
        assert g.seconds > 0
    assert session.query_many([]) == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_query_fused_matches_reference_session(lake, backend):
    session = blend.connect(lake, backend=backend, device="cpu")
    ref = ref_blend.connect(lake)
    for q, rq in zip(_mixed(blend, lake), _mixed(ref_blend, lake)):
        got, want = session.query(q, fused=True), ref.query(rq, fused=True)
        assert got.ids == want.ids == session.query(q).ids
        np.testing.assert_array_equal(got.scores.numpy(),
                                      np.asarray(want.scores))
        assert got.info.launches == want.info.launches


@pytest.mark.parametrize("backend", BACKENDS)
def test_explain_fused_shows_collapsed_launches(lake, backend):
    session = blend.connect(lake, backend=backend, device="cpu")
    q = _qa(blend, lake, 2)
    ex = session.explain(q, fused=True)
    ref_ex = ref_blend.connect(lake).explain(_qa(ref_blend, lake, 2),
                                             fused=True)
    assert "launches: 3" in str(ex)            # SC group + KW group + DAG
    assert (ex.launches, ex.ids, ex.exec_order, ex.overflow) == \
        (ref_ex.launches, ref_ex.ids, ref_ex.exec_order, ref_ex.overflow)
    assert set(ex.node_seconds) == set(ref_ex.node_seconds)
    assert session.explain(q).launches >= ex.launches


# --------------------------------------------- random DAGs stay identical

def _materialize(tree, lake, tab, api, logical):
    """tests/test_fused.py's tree -> expression, for either package."""
    kind = tree[0]
    if kind == "leaf":
        cols = lake.tables[tab].columns
        return {"sc": api.sc(list(cols[0][:6]), k=12),
                "kw": api.kw([cols[1][0], cols[1][2]], k=12),
                "mc": api.mc([(cols[0][r], cols[1][r]) for r in range(3)],
                             k=12),
                "c": api.corr(list(cols[0][:8]),
                              list(map(float, range(8))), k=12)}[tree[1]]
    kids = [_materialize(c, lake, tab, api, logical) for c in tree[1:]]
    if kind in ("and", "or"):
        uniq = list(dict.fromkeys(kids))
        if len(uniq) == 1:
            return uniq[0]
        return (logical.And if kind == "and" else logical.Or)(tuple(uniq))
    if kind == "sub":
        return logical.Sub(kids[0], kids[1])
    return logical.Counter(tuple(kids))


def _check_tree(lake, tab, tree, backend):
    session = blend.connect(lake, backend=backend, device="cpu")
    ref = ref_blend.connect(lake)
    e = _materialize(tree, lake, tab, blend, port_logical)
    re_ = _materialize(tree, lake, tab, ref_blend, ref_logical)
    if isinstance(e, port_logical.Seek):
        e, re_ = e & (e | e), re_ & (re_ | re_)
    for optimize in (True, False):
        a = session.query(e, optimize=optimize)
        b = session.query(e, optimize=optimize, fused=True)
        c = ref.query(re_, optimize=optimize, fused=True)
        np.testing.assert_array_equal(a.scores.numpy(), b.scores.numpy())
        np.testing.assert_array_equal(a.result.mask.numpy(),
                                      b.result.mask.numpy())
        np.testing.assert_array_equal(b.scores.numpy(), np.asarray(c.scores))
        assert a.ids == b.ids == c.ids


def _random_tree(rng, depth):
    kinds = ["sc", "kw", "mc", "c"]
    if depth == 0:
        return ("leaf", kinds[rng.integers(4)])
    op = ["and", "or", "sub", "counter", "leaf"][rng.integers(5)]
    if op == "leaf":
        return ("leaf", kinds[rng.integers(4)])
    if op == "sub":
        return ("sub", _random_tree(rng, depth - 1),
                _random_tree(rng, depth - 1))
    return (op, *[_random_tree(rng, depth - 1)
                  for _ in range(int(rng.integers(2, 4)))])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_random_dag_fused_parity(lake, backend, seed):
    """Random DAGs drawn from numpy seeds (the hypothesis property below
    draws more where hypothesis is installed)."""
    rng = np.random.default_rng(seed)
    tab = int(rng.integers(8))
    _check_tree(lake, tab, _random_tree(rng, int(rng.integers(1, 4))),
                backend)


@settings(max_examples=6, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.data())
def test_property_random_dag_fused_parity(lake, data):
    tab, tree = data.draw(plan_trees())
    for backend in BACKENDS:
        _check_tree(lake, tab, tree, backend)
