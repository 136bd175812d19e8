"""repro_torch's batching server on the CPU (``serve/server.py``,
``serve/client.py``, ``serve/loadgen.py``, ``Explain``'s ``== server ==``).

The JAX package's contracts run against the port: each reference test
function, and every helper of its module, is rebound (``types.FunctionType``)
to a namespace where the lake, expression, engine, server, client, load
generator, error and observability names are the port's, with every engine
on the CPU and on each port backend.  That covers tests/test_serving.py in
its ``static``, ``live`` and ``sharded`` modes, the server, client and
load-generator contracts
of tests/test_recovery.py and the serving contracts of tests/test_obs.py.
Two contracts import the JAX package inside the test and are restated on
the port.  Beside them: the port's server answers equal the JAX package's
server (``sorted``) on the same lake and traffic, the port's ``make_trace``
equals the JAX package's event for event, and ``Explain`` renders the same
``== server ==`` text for the same stats.
"""
import sys
import threading
import types

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

import blend as ref_blend
import repro_torch as blend
import test_obs as ref_obs_tests
import test_recovery as ref_recovery
import test_serving as ref_serving
from repro import obs as ref_obs
from repro.core.lake import Table as RefTable
from repro.serve.engine import DiscoveryEngine as RefEngine
from repro.serve.loadgen import make_trace as ref_make_trace
from repro.serve.server import DiscoveryServer as RefServer
from repro_torch import errors, faults, obs
from repro_torch.core import lake as port_lake
from repro_torch.obs import metrics as port_metrics
from repro_torch.serve import batching, client, loadgen, server
from repro_torch.serve.engine import DiscoveryEngine

BACKENDS = ("sorted", "bucket")
MODES = ("static", "live")
#: the store modes of tests/test_serving.py, sharded included
ALL_MODES = MODES + ("sharded",)

#: tests/test_serving.py's contracts that run a server on each backend
#: (their engines take the backend of the namespace)
SERVING = (
    "test_concurrent_submitters_parity",
    "test_mutation_barrier_epoch_consistency",
    "test_sharded_mutation_barrier_parity",
    "test_rate_limit_sheds_with_retry_after",
    "test_queue_full_sheds_and_bounds_depth",
    "test_response_telemetry_and_stats",
    "test_explain_renders_server_section",
    "test_async_facade_parity",
    "test_replay_without_real_pacing",
    "test_replay_overload_sheds_but_serves_admitted",
)
#: tests/test_serving.py's contracts that run no engine
SERVING_PURE = ("test_trace_generation_deterministic",
                "test_zipf_mix_is_cache_friendly")
#: tests/test_recovery.py's server, client and load-generator contracts
RECOVERY = ("test_server_deadline_exceeded_typed_response",
            "test_loadgen_replay_retries_overload")
RECOVERY_PURE = ("test_retrying_client_honors_retry_after_floor",
                 "test_retrying_client_gives_up_and_never_retries_deadlines")
#: tests/test_obs.py's serving contracts
OBS = ("test_flight_recorder_and_metrics_end_to_end",
       "test_observability_changes_no_ids_or_scores",
       "test_server_uses_private_registry_when_disabled")


def _port_names(backend: str) -> dict:
    """The reference modules' names, bound to the port's objects; an
    engine runs on the CPU with ``backend`` unless it names its own (the
    ``interpret`` flag of the JAX package's Pallas backend is dropped)."""
    default = backend

    class Engine(DiscoveryEngine):
        def __init__(self, lake, backend=default, interpret=False, **kw):
            super().__init__(lake, backend=backend, device="cpu", **kw)

    return {
        "blend": blend, "DiscoveryEngine": Engine,
        "DataLake": port_lake.DataLake, "Table": port_lake.Table,
        "synthetic_lake": port_lake.synthetic_lake,
        "BATCH": batching.BATCH, "INTERACTIVE": batching.INTERACTIVE,
        "Batch": batching.Batch, "BatchFormer": batching.BatchFormer,
        "LaneConfig": batching.LaneConfig,
        "DiscoveryServer": server.DiscoveryServer,
        "AsyncDiscoveryServer": server.AsyncDiscoveryServer,
        "Overloaded": errors.Overloaded,
        "DeadlineExceeded": errors.DeadlineExceeded,
        "BlendFault": errors.BlendFault,
        "CorruptSnapshot": errors.CorruptSnapshot,
        "WalReplayError": errors.WalReplayError,
        "InjectedFault": faults.InjectedFault,
        "InjectedCrash": faults.InjectedCrash,
        "RetryingClient": client.RetryingClient,
        "Trace": loadgen.Trace, "TraceEvent": loadgen.TraceEvent,
        "make_trace": loadgen.make_trace, "mutation_table":
        loadgen.mutation_table, "query_pool": loadgen.query_pool,
        "replay": loadgen.replay, "zipf_qids": loadgen.zipf_qids,
        "obs": obs, "NULL_REGISTRY": port_metrics.NULL_REGISTRY,
        "MetricsRegistry": port_metrics.MetricsRegistry,
    }


def _rebind(fn, ns):
    return types.FunctionType(fn.__code__, ns, fn.__name__, fn.__defaults__,
                              fn.__closure__)


def _port_module(module, backend: str = "sorted") -> dict:
    """``module``'s namespace with every function it defines rebound to the
    port's names (so its helpers build port lakes, engines and servers)."""
    ns = {**vars(module), **_port_names(backend)}
    for name, fn in vars(module).items():
        if isinstance(fn, types.FunctionType) and \
                fn.__module__ == module.__name__:
            ns[name] = _rebind(fn, ns)
    return ns


@pytest.fixture(autouse=True)
def _obs_off():
    """Both registries disabled before and after every test."""
    obs.disable()
    ref_obs.disable()
    yield
    obs.disable()
    ref_obs.disable()


# --------------------------------------------------- tests/test_serving.py

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ALL_MODES)
def test_server_batched_matches_sequential_on_port(mode, backend):
    _port_module(ref_serving)["test_server_batched_matches_sequential"](
        mode, backend, False)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", SERVING)
def test_reference_serving_contract_holds_for_port(name, backend):
    _port_module(ref_serving, backend)[name]()


@pytest.mark.parametrize("name", SERVING_PURE)
def test_reference_trace_contract_holds_for_port(name):
    _port_module(ref_serving)[name]()


@pytest.mark.parametrize("backend", BACKENDS)
@settings(max_examples=4, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(st.lists(st.tuples(st.sampled_from(["query", "add", "compact"]),
                          st.integers(0, 10 ** 6)),
                min_size=2, max_size=7))
def test_property_server_matches_oracle_under_interleaving(backend, ops):
    """tests/test_serving.py's interleaving property (its strategy
    restated, its body rebound to the port): any interleaving of queries
    and mutations through the server gives oracle-exact ids."""
    inner = ref_serving.test_property_server_matches_oracle_under_interleaving
    _rebind(inner.hypothesis.inner_test,
            _port_module(ref_serving, backend))(ops)


# ---------------------------------- tests/test_recovery.py, tests/test_obs.py

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", RECOVERY)
def test_reference_recovery_contract_holds_for_port(name, backend,
                                                    tmp_path):
    fn = _port_module(ref_recovery, backend)[name]
    if fn.__code__.co_argcount:
        fn(tmp_path)
    else:
        fn()


@pytest.mark.parametrize("name", RECOVERY_PURE)
def test_reference_client_contract_holds_for_port(name):
    _port_module(ref_recovery)[name]()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", OBS)
def test_reference_obs_serving_contract_holds_for_port(name, backend,
                                                       tmp_path):
    fn = _port_module(ref_obs_tests, backend)[name]
    if fn.__code__.co_argcount:
        fn(tmp_path)
    else:
        fn()
    assert not ref_obs.enabled()


def test_error_types_consolidated_and_backcompat():
    """tests/test_recovery.py's case on the port (it imports the server
    module inside the test)."""
    from repro_torch.serve.server import Overloaded as ServerOverloaded
    for exc in (errors.Overloaded, errors.DeadlineExceeded,
                faults.InjectedFault):
        assert issubclass(exc, errors.BlendFault)
    assert ServerOverloaded is errors.Overloaded
    assert server.DeadlineExceeded is errors.DeadlineExceeded
    assert client.Overloaded is errors.Overloaded
    for exc in (errors.CorruptSnapshot, errors.WalReplayError):
        assert issubclass(exc, errors.BlendFault) and \
            issubclass(exc, ValueError)
    o = errors.Overloaded("rate_limit", "interactive", "t",
                          retry_after_s=0.5)
    d = errors.DeadlineExceeded("interactive", "t", deadline_s=0.1,
                                waited_s=0.2)
    assert o.ok is False and d.ok is False
    assert not issubclass(faults.InjectedCrash, Exception)


def test_loadgen_report_queue_percentiles():
    """tests/test_obs.py's case on the port (it imports the load generator
    inside the test)."""
    rep = loadgen.ReplayReport(
        offered=4, completed=4, shed=0, mutations=0, makespan_s=1.0,
        latencies_s=[0.01, 0.02, 0.03, 0.04],
        queue_s=[0.001, 0.002, 0.003, 0.1], batch_sizes=[2, 2, 2, 2],
        shed_reasons={}, server_stats={"batches": {"size_hist": {}}})
    d = rep.as_dict()
    assert d["queue_ms_p50"] > 0
    assert d["queue_ms_p99"] >= d["queue_ms_p50"]


# ------------------------------------------------- against the JAX package

def _assert_same(got, want, ctx=""):
    assert got.table_ids == want.table_ids, ctx
    np.testing.assert_array_equal(np.asarray(got.scores),
                                  np.asarray(want.scores), err_msg=str(ctx))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ALL_MODES)
def test_port_server_equals_reference_server(mode, backend):
    """The same lake and traffic through the port's server and the JAX
    package's (``sorted``): every answer equal, ids and scores (and on a
    sharded lake ``degraded`` / ``failed_shards``), before and (live,
    sharded) after an ``add_table`` barrier."""
    lake = ref_serving.serving_lake(seed=19)
    ns = _port_module(ref_serving, backend)
    opts = {"static": {}, "live": {"live": True},
            "sharded": {"live": True, "shards": 2}}[mode]
    live = bool(opts)
    port = server.DiscoveryServer(ns["DiscoveryEngine"](lake, **opts),
                                  max_batch=8, interactive_window_s=0.02)
    ref = RefServer(RefEngine(lake, **opts), max_batch=8,
                    interactive_window_s=0.02)
    pool, ref_pool = ns["pool4"](lake), ref_serving.pool4(lake)
    try:
        got = [port.submit(q) for q in pool]
        want = [ref.submit(q) for q in ref_pool]
        if live:
            extra = ref_serving.extra_table(4)
            assert port.add_table(extra).result(timeout=120) == \
                ref.add_table(extra).result(timeout=120)
            got += [port.submit(q, lane=batching.BATCH) for q in pool]
            want += [ref.submit(q) for q in ref_pool]
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g.result(timeout=120), w.result(timeout=120)
            _assert_same(g, w, (mode, backend, i))
            assert (g.degraded, g.failed_shards) == \
                (w.degraded, w.failed_shards) == (False, [])
    finally:
        port.stop()
        ref.stop()
    assert port.stats()["served"] == ref.stats()["served"] == len(got)


def test_make_trace_equals_reference_event_for_event():
    lake = ref_serving.serving_lake(seed=47)
    for kw in (dict(seed=5, duration_s=1.0, rate_rps=100.0, p_mutation=0.1),
               dict(seed=0, duration_s=0.5, rate_rps=300.0, n_distinct=6,
                    k=12)):
        got, want = loadgen.make_trace(lake, **kw), ref_make_trace(lake, **kw)
        assert (got.seed, got.duration_s, got.config, got.offered_rps) == \
            (want.seed, want.duration_s, want.config, want.offered_rps)
        assert len(got.events) == len(want.events) > 10
        for a, b in zip(got.events, want.events):
            assert (a.t, a.kind, a.tenant, a.lane, a.qid) == \
                (b.t, b.kind, b.tenant, b.lane, b.qid)
            if a.kind == "query":
                assert a.payload.to_sql() == b.payload.to_sql()
            elif a.kind == "add":
                assert isinstance(a.payload, port_lake.Table)
                assert not isinstance(a.payload, RefTable)
                assert (a.payload.name, a.payload.columns) == \
                    (b.payload.name, b.payload.columns)
            else:
                assert a.payload == b.payload


def _section(text, header="== server =="):
    lines = text.splitlines()
    start = lines.index(header)
    end = next((i for i in range(start + 1, len(lines))
                if lines[i].startswith("== ")), len(lines))
    return lines[start:end]


def test_explain_server_section_equals_reference():
    """Port and JAX package render the same ``== server ==`` text for the
    same stats, taken from a port server after traffic and sheds."""
    lake = ref_serving.serving_lake(seed=41)
    ns = _port_module(ref_serving)
    srv = server.DiscoveryServer(ns["DiscoveryEngine"](lake), rate=100.0,
                                 burst=2.0, max_batch=4)
    q = ns["pool4"](lake)[0]
    try:
        futs = [srv.submit(q, tenant="a") for _ in range(4)]
        outs = [f.result(timeout=120) for f in futs]
        stats = srv.stats()
        ex = srv.explain(q)
    finally:
        srv.stop()
    assert any(isinstance(o, errors.Overloaded) for o in outs)
    assert ex.server == stats
    ref_session = ref_blend.connect(lake)
    ref_q = ref_serving.pool4(lake)[0]
    got = _section(str(blend.connect(lake, device="cpu").explain(
        q, server=stats)))
    want = _section(str(ref_session.explain(ref_q, server=stats)))
    assert got == want and len(got) == 5
    assert _section(str(ex)) == _section(str(ref_session.explain(
        ref_q, server=ex.server)))


# ------------------------------------------------------------- threads

@pytest.mark.parametrize("backend", BACKENDS)
def test_many_submitters_with_short_switch_interval(backend):
    """More submitter threads than cores, switching every few microseconds:
    every response equals its sequential ``serve``, and the server counts
    every request once."""
    lake = ref_serving.serving_lake(seed=61)
    ns = _port_module(ref_serving, backend)
    engine = ns["DiscoveryEngine"](lake, live=True)
    pool = ns["pool4"](lake)
    want = [engine.serve(q, fused=True) for q in pool]
    srv = server.DiscoveryServer(engine, max_batch=16)
    n_threads, rounds = 12, 3
    results, errors_seen = {}, []

    def submitter(tid):
        try:
            futs = [(i, srv.submit(pool[i], tenant=f"t{tid}",
                                   lane=batching.BATCH if (tid + i) % 2
                                   else batching.INTERACTIVE))
                    for _ in range(rounds) for i in range(len(pool))]
            results[tid] = [(i, f.result(timeout=120)) for i, f in futs]
        except BaseException as e:                  # noqa: BLE001
            errors_seen.append(e)
            raise

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        srv.stop()
    assert not errors_seen and len(results) == n_threads
    for tid, rs in results.items():
        for i, resp in rs:
            _assert_same(resp, want[i], (tid, i))
    stats = srv.stats()
    total = n_threads * rounds * len(pool)
    assert stats["served"] == stats["batches"]["requests"] == total
    assert not stats["running"]
