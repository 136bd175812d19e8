"""repro_torch's query cache on the CPU (``serve/cache.py``, the Session's
cache plumbing, the fused path's subplan-cache branch), against the JAX
package's cached session (its ``sorted`` backend: its ``bucket`` backend
does not trace on this JAX), a cold port session and tests/oracle.py.

tests/test_query_cache.py's 24 contracts run against the port: each
reference test function (and the helpers it calls) runs with its module's
names bound to the port's objects, on both port backends where it runs a
session.  Its hypothesis property and its cost-model case, which import
the JAX package inside the test, are restated here on the port.  Beside
them, the port's cached answers, statuses and overflow equal the JAX
package's at every step of a mutation script, fused and unfused, and a
partial hit on the fused path equals a cold run after the seeker's
program has been replayed with other values.
"""
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

import blend as ref_blend
import repro_torch as blend
import test_query_cache as ref_tests
from repro_torch.core import lake as port_lake
from repro_torch.core import plan as port_plan
from repro_torch.core.cost_model import train_cost_model
from repro_torch.core.executor import Executor
from repro_torch.core.index import build_index
from repro_torch.query import fingerprint as port_fp
from repro_torch.serve.cache import QueryCache
from repro_torch.serve.engine import DiscoveryEngine
from repro_torch.store import LiveLake

from oracle import oracle_run

BACKENDS = ("sorted", "bucket")

#: contracts that run no session
PURE = (
    "test_fingerprint_commutative_and_normalized",
    "test_fingerprint_order_blindness_limited_to_exact_merges",
    "test_fingerprint_numpy_scalars_match_python_values",
    "test_fingerprint_value_set_semantics",
    "test_fingerprint_plan_agrees_with_expr",
    "test_oversized_entries_are_refused_not_evicting_everything",
    "test_drain_exclusion_predicate",
)
#: contracts that open sessions themselves
SESSIONS = (
    "test_index_epoch_key_moves_on_every_mutation",
    "test_shared_cache_never_crosses_index_objects",
    "test_optimize_flag_is_part_of_the_result_key",
    "test_mutation_invalidation_bit_identical_to_cold_rebuild",
    "test_interleaved_queries_and_mutations_match_cold_session",
    "test_lru_eviction_under_byte_budget",
    "test_connect_cache_argument_forms",
    "test_discovery_engine_cache_telemetry_and_drain_exclusion",
    "test_sync_false_hit_does_not_block_and_batch_dup_is_served",
)
#: contracts that take the module's ``cached_session`` fixture
ON_CACHED_SESSION = (
    "test_exact_hit_serves_identical_ids",
    "test_partial_hit_reuses_shared_seeker_bit_identically",
    "test_plan_cache_memoizes_compilation",
    "test_legacy_plan_queries_share_cache_entries",
    "test_explain_renders_cache_section",
    "test_repeat_query_latency_much_faster_than_cold",
)


def _port_names(backend: str) -> dict:
    """tests/test_query_cache.py's names, bound to the port's objects; a
    session or executor runs on the CPU with ``backend``."""

    def connect(lake, **kw):
        return blend.connect(lake, device="cpu", backend=backend, **kw)

    class Engine(DiscoveryEngine):
        def __init__(self, lake, **kw):
            if kw.get("session") is None:
                kw = {"device": "cpu", "backend": backend, **kw}
            super().__init__(lake, **kw)

    ns = types.SimpleNamespace(**{n: getattr(blend, n)
                                  for n in blend.__all__})
    ns.connect = connect
    return {
        "blend": ns, "Executor": lambda idx, **kw: Executor(
            idx, device="cpu", backend=backend, **kw),
        "build_index": build_index, "DataLake": port_lake.DataLake,
        "Table": port_lake.Table, "synthetic_lake": port_lake.synthetic_lake,
        "Combiners": port_plan.Combiners, "Plan": port_plan.Plan,
        "Seekers": port_plan.Seekers,
        "fingerprint_expr": port_fp.fingerprint_expr,
        "fingerprint_plan": port_fp.fingerprint_plan,
        "fingerprint_query": port_fp.fingerprint_query,
        "index_epoch_key": port_fp.index_epoch_key,
        "lower": blend.lower, "rewrite": blend.rewrite,
        "QueryCache": QueryCache, "DiscoveryEngine": Engine,
        "LiveLake": LiveLake,
    }


def _port_module(backend: str) -> dict:
    """tests/test_query_cache.py's namespace with every function it
    defines rebound to the port's names (so its helpers build port lakes,
    tables and expressions)."""
    ns = {**vars(ref_tests), **_port_names(backend)}
    for name, fn in vars(ref_tests).items():
        if isinstance(fn, types.FunctionType) and \
                fn.__module__ == ref_tests.__name__:
            ns[name] = types.FunctionType(fn.__code__, ns, name,
                                          fn.__defaults__, fn.__closure__)
    return ns


@pytest.fixture(scope="module", params=BACKENDS)
def port(request):
    """(backend, the rebound namespace, a cached port session on the
    reference's cache lake)."""
    ns = _port_module(request.param)
    return request.param, ns, ns["blend"].connect(ns["cache_lake"](),
                                                  cache=True)


@pytest.mark.parametrize("name", PURE)
def test_reference_cache_contract_holds_for_port(name):
    _port_module("sorted")[name]()


@pytest.mark.parametrize("name", SESSIONS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_reference_session_contract_holds_for_port(name, backend):
    _port_module(backend)[name]()


@pytest.mark.parametrize("name", ON_CACHED_SESSION)
def test_reference_cached_session_contract_holds_for_port(name, port):
    _, ns, session = port
    ns[name](session)


# --------------------------------------------------------------------------
# the contracts that import the JAX package inside the test, on the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_shared_cache_keys_on_executor_config_and_cost_model(backend):
    """tests/test_query_cache.py's case on the port: entries made under
    another capacity ladder or cost model are never served."""
    ns = _port_module(backend)
    connect = ns["blend"].connect
    lake = ns["cache_lake"](seed=101, n_tables=8)
    ll = LiveLake(lake)
    qc = QueryCache()
    q = ns["query_pool"](lake, k=8)[0]
    s1 = connect(ll, live=True, cache=qc)
    s1.query(q)
    assert s1.query(q).cache.status == "hit"
    s2 = connect(ll, live=True, cache=qc, m_cap_max=64)
    r = s2.query(q)
    assert r.cache.status != "hit"
    assert r.ids == connect(ll, live=True, m_cap_max=64).query(q).ids
    s2.query(q)
    assert s2.query(q).cache.status == "hit"
    s2.cost_model = train_cost_model(s2.executor, lake, n_samples=4)
    assert s2.query(q).cache.status != "hit"
    assert s2.query(q).ids == connect(ll, live=True, m_cap_max=64,
                                      cost_model=s2.cost_model).query(q).ids


@settings(max_examples=5, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large,
                                 HealthCheck.function_scoped_fixture])
@given(st.lists(st.tuples(st.sampled_from(["query", "add", "drop",
                                           "compact"]),
                          st.integers(0, 10 ** 6)),
                min_size=2, max_size=8),
       st.sampled_from(BACKENDS), st.booleans())
def test_property_cache_parity_under_random_interleaving(ops, backend,
                                                         fused):
    """tests/test_query_cache.py's property on the port, fused and
    unfused: any interleaving of queries and mutations gives the cached
    session the cold session's ids and scores at every epoch."""
    ns = _port_module(backend)
    lake = ns["cache_lake"](seed=41, n_tables=10)
    ll = LiveLake(lake)
    cached = ns["blend"].connect(ll, live=True, cache=True)
    cold = ns["blend"].connect(ll, live=True)
    pool = ns["query_pool"](lake, k=12)

    def same(q, msg):
        got, want = cached.query(q, fused=fused), cold.query(q)
        assert got.ids == want.ids, msg
        assert torch.equal(got.scores, want.scores), msg

    for i, (op, arg) in enumerate(ops):
        if op == "add":
            cached.add_table(ns["extra_table"](50 + arg % 40,
                                               rows=6 + arg % 9))
        elif op == "drop" and len(ll.live_ids()) > 4:
            live = sorted(ll.live_ids())
            cached.drop_table(live[arg % len(live)])
        elif op == "compact":
            cached.compact(full=arg % 2 == 0)
        else:
            same(pool[arg % len(pool)], (i, op))
    for q in pool:
        same(q, "final")


# --------------------------------------------------------------------------
# against the JAX package's cached session
# --------------------------------------------------------------------------

def _assert_same(got, want, msg=""):
    assert got.ids == want.ids, msg
    np.testing.assert_array_equal(got.scores.numpy(),
                                  np.asarray(want.scores), err_msg=msg)
    assert got.info.overflow == want.info.overflow, msg


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_cached_session_equals_reference_through_mutations(backend, fused):
    """A cached port session and the JAX package's cached session over
    the same live lake: every query's ids, scores, overflow and cache
    status are equal (miss, partial and hit alike), after every add, drop
    and compaction, and the first query after each mutation misses."""
    ns = _port_module(backend)
    lake = ref_tests.cache_lake(seed=21)
    port_s = ns["blend"].connect(lake, live=True, cache=True)
    ref_s = ref_blend.connect(lake, live=True, cache=True)
    pools = ns["query_pool"](lake), ref_tests.query_pool(lake)

    def sweep(step):
        statuses = []
        for q, rq in zip(*pools):
            for _ in range(2):
                got = port_s.query(q, fused=fused)
                want = ref_s.query(rq, fused=fused)
                _assert_same(got, want, f"{step} {q}")
                assert got.cache.as_dict() == want.cache.as_dict(), step
                statuses.append(got.cache.status)
        return statuses

    assert sweep("initial")[1::2] == ["hit"] * 4
    victim = port_s.query(pools[0][0]).ids[0]
    mutations = (
        ("add", lambda s: s.add_table(ref_tests.extra_table(0))),
        ("drop", lambda s: s.drop_table(victim)),
        ("compact", lambda s: s.compact()),
    )
    ref_s.query(pools[1][0])                 # the same hit on both
    for step, mutate in mutations:
        assert mutate(port_s) == mutate(ref_s)
        statuses = sweep(step)
        assert statuses[0] == "miss" and statuses[1::2] == ["hit"] * 4
    assert port_s.cache.stats() == ref_s.cache.stats()


@pytest.mark.parametrize("backend", BACKENDS)
def test_cached_answers_equal_oracle(backend):
    """On a static lake, the cached session's first and repeated answers
    to every query of the pool equal tests/oracle.py (plans unoptimized,
    as the oracle runs them)."""
    ns = _port_module(backend)
    lake = ref_tests.cache_lake(seed=5)
    s = ns["blend"].connect(lake, cache=True)
    for q in ns["query_pool"](lake):
        plan = s.compile(q).plan
        scores, mask = oracle_run(lake, plan)
        for _ in range(2):
            got = s.query(q, optimize=False)
            np.testing.assert_array_equal(got.scores.numpy(), scores)
            np.testing.assert_array_equal(got.result.mask.numpy(), mask)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_partial_hit_survives_a_replay_of_its_program(backend):
    """``sc`` over values A is cached, then ``sc`` over values B of the
    same width runs the same group and DAG programs with new values; a
    later ``sc | corr`` served A's ``sc`` from the cache, and equals a
    cold run, as does the stored entry itself."""
    ns = _port_module(backend)
    lake = ref_tests.cache_lake(seed=7)
    s = ns["blend"].connect(lake, cache=True)
    cold = ns["blend"].connect(lake)
    t, u = lake.tables[3], lake.tables[9]
    sc_a = blend.sc(list(t.columns[0][:8]), k=20)
    sc_b = blend.sc(list(u.columns[0][:8]), k=20)
    corr = blend.corr(list(t.columns[0][:8]), [float(i) for i in range(8)],
                      k=20, h=64)
    s.query(sc_a, fused=True)
    programs = len(s.executor.programs)
    b = s.query(sc_b, fused=True)
    assert b.cache.status == "miss" and len(s.executor.programs) == programs
    assert not torch.equal(b.scores, cold.query(sc_a).scores)
    r = s.query(sc_a | corr, fused=True)
    assert r.cache.status == "partial" and r.info.seeker_runs == 1
    want = cold.query(sc_a | corr)
    assert r.ids == want.ids and torch.equal(r.scores, want.scores)
    spec = s.compile(sc_a).plan.nodes[s.compile(sc_a).plan.output].spec
    entry = s.cache.get_seeker(s.cache.seeker_key(spec))
    assert torch.equal(entry.result.scores, cold.query(sc_a).scores)
