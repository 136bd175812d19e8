"""repro_torch's observability (``repro_torch.obs``), errors and faults on
the CPU: tests/test_obs.py's registry, histogram, span, chrome-trace and
sync-timing contracts run against the port's copy; the port's registry is
its own; the executor counts plans, launches and seeker runs as the JAX
package's does for the same plan; and observability changes no ids or
scores.
"""
import types

import numpy as np
import pytest

import blend as ref_blend
import repro_torch as blend
import test_obs
from repro import obs as ref_obs
from repro.core.executor import Executor as RefExecutor
from repro.core.index import build_index as ref_build_index
from repro_torch import errors, faults, obs
from repro_torch.core import seekers as seek
from repro_torch.core.executor import Executor
from repro_torch.core.index import UnifiedIndex
from repro_torch.obs import metrics as port_metrics
from repro_torch.obs import trace as port_trace

from test_fused import deep_plan, flat_plan, lake  # noqa: F401

BACKENDS = ("sorted", "bucket")

#: tests/test_obs.py's unit contracts; each runs with the module's names
#: bound to the port's objects
CONTRACTS = (
    "test_histogram_bucket_index_and_edges",
    "test_histogram_percentiles_bucket_resolution",
    "test_histogram_single_value_percentile_exact",
    "test_histogram_empty_snapshot",
    "test_registry_timer_fake_clock",
    "test_registry_counters_gauges_and_snapshot",
    "test_null_registry_is_shared_noop",
    "test_enable_disable_and_sync_timing",
    "test_span_nesting_and_ordering_fake_clock",
    "test_recorder_record_premeasured_interval",
    "test_recording_contextvar",
    "test_chrome_trace_schema_and_shared_subtree_once",
)
PORT_NAMES = {
    "obs": obs, "Histogram": port_metrics.Histogram,
    "MetricsRegistry": port_metrics.MetricsRegistry,
    "NULL_REGISTRY": port_metrics.NULL_REGISTRY,
    "NullRegistry": port_metrics.NullRegistry,
    "NULL_RECORDER": port_trace.NULL_RECORDER,
    "Recorder": port_trace.Recorder, "Span": port_trace.Span,
    "chrome_trace": port_trace.chrome_trace, "current": port_trace.current,
    "recording": port_trace.recording,
}


@pytest.fixture(autouse=True)
def _obs_off():
    """Every test starts and ends with both registries disabled."""
    obs.disable()
    ref_obs.disable()
    yield
    obs.disable()
    ref_obs.disable()


@pytest.mark.parametrize("name", CONTRACTS)
def test_reference_obs_contract_holds_for_port(name):
    ref_fn = getattr(test_obs, name)
    fn = types.FunctionType(ref_fn.__code__,
                            {**vars(test_obs), **PORT_NAMES}, name)
    fn()
    assert not ref_obs.enabled()


def test_port_registry_is_separate_from_reference():
    reg = obs.enable(sync_timing=True)
    assert obs.enabled() and not ref_obs.enabled()
    assert not ref_obs.sync_timing()
    assert ref_obs.registry() is not reg
    obs.disable()
    ref_obs.enable(sync_timing=True)
    assert not obs.enabled() and not obs.sync_timing()
    assert obs.registry() is port_metrics.NULL_REGISTRY


def test_retrace_counter_bridges_trace_counts():
    reg = obs.enable()
    seek._mark_trace("TEST_KIND")
    assert reg.counter("exec.retraces").value == 1
    assert reg.counter("exec.retraces.TEST_KIND").value == 1
    assert seek.TRACE_COUNTS["TEST_KIND"] == 1
    seek.TRACE_COUNTS.pop("TEST_KIND", None)


def test_faults_use_the_port_errors():
    inj = faults.FaultInjector(fail={"p": 1}, crash={"q": 2})
    with faults.inject(inj):
        with pytest.raises(errors.BlendFault):
            faults.checkpoint("p")
        faults.checkpoint("p")                     # hit 2 succeeds
        faults.checkpoint("q")
        with pytest.raises(faults.InjectedCrash):
            faults.checkpoint("q")
    assert faults.active() is None
    assert inj.points == ["p", "q"]
    faults.checkpoint("p")                         # no injector: no-op
    assert issubclass(errors.CorruptSnapshot, ValueError)


# ------------------------------------------------------------ the executor

@pytest.fixture(scope="module")
def ref_ex(lake):
    return RefExecutor(ref_build_index(lake))


def _port_ex(ref_ex, backend):
    return Executor(UnifiedIndex.from_numpy(vars(ref_ex.index)),
                    backend=backend, device="cpu")


def _counts(reg):
    snap = reg.snapshot()
    return ({k: snap["counters"].get(k) for k in
             ("exec.plans", "exec.launches", "exec.seeker_runs")},
            snap["histograms"].get("exec.plan_seconds", {}).get("count"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("optimize", [True, False])
def test_unfused_executor_counts_match_reference(lake, ref_ex, backend,
                                                 optimize):
    ex = _port_ex(ref_ex, backend)
    plans = [flat_plan(lake, "difference"), deep_plan(lake)]
    reg = obs.enable()
    for p in plans:
        ex.run(p, optimize=optimize)
    ref_reg = ref_obs.enable()
    for p in plans:
        ref_ex.run(p, optimize=optimize)
    got, want = _counts(reg), _counts(ref_reg)
    assert got == want
    assert got[0]["exec.plans"] == 2 and got[1] == 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_counts_and_spans_match_reference(lake, ref_ex, backend):
    ex = _port_ex(ref_ex, backend)
    plans = [flat_plan(lake, "union"), deep_plan(lake, tab=5)]
    ex.run_many(plans)                       # build the programs first
    ref_ex.run_many(plans)
    reg = obs.enable()
    rec = port_trace.Recorder()
    with port_trace.recording(rec), rec.span("batch"):
        ex.run_many(plans)
    ref_reg = ref_obs.enable()
    ref_rec = ref_obs.Recorder()
    with ref_obs.recording(ref_rec), ref_rec.span("batch"):
        ref_ex.run_many(plans)
    snap, ref_snap = reg.snapshot(), ref_reg.snapshot()
    for k in ("exec.plans", "exec.launches", "exec.seeker_runs"):
        assert snap["counters"][k] == ref_snap["counters"][k]
    assert snap["counters"]["exec.launches"] == 4 + 2   # 4 groups + 2 DAGs
    for h in ("shard.probe_seconds.0", "exec.probe_seconds",
              "exec.dag_seconds"):
        assert snap["histograms"][h]["count"] == \
            ref_snap["histograms"][h]["count"] > 0
    assert "exec.compile_seconds" not in snap["histograms"]
    names = [s.name for s in rec.roots[0].walk()]
    assert names == [s.name for s in ref_rec.roots[0].walk()]
    assert {"probe:SC", "probe:MC/2", "shard:0", "merge"} <= set(names)


@pytest.mark.parametrize("sync", [False, True])
def test_sync_timing_waits_in_every_node_timer(lake, ref_ex, monkeypatch,
                                               sync):
    """Under ``sync_timing`` each seeker and combiner node waits for the
    device before its clock read (with ``sync=True`` each seeker already
    has); off, only ``sync=True`` seekers wait."""
    ex = _port_ex(ref_ex, "sorted")
    plan = flat_plan(lake, "difference", tab=3)    # 4 seekers, 3 combiners
    waits = []
    monkeypatch.setattr(ex, "synchronize", lambda: waits.append(1))
    ex.run(plan, sync=sync)
    off = len(waits)
    obs.enable(sync_timing=True)
    waits.clear()
    ex.run(plan, sync=sync)
    assert off == (4 if sync else 0)
    assert len(waits) == 4 + 3
    waits.clear()
    ex.run(plan, fused=True, sync=False)
    assert len(waits) == 4 + 1                     # 4 groups + the DAG


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fused", [False, True])
def test_observability_changes_no_ids_or_scores(lake, backend, fused):
    session = blend.connect(lake, backend=backend, device="cpu")
    t = lake.tables[3]
    sc = blend.sc(list(t.columns[0][:8]), k=20)
    kw = blend.kw([t.columns[1][0], t.columns[1][2]], k=20)
    mc = blend.mc([(t.columns[0][r], t.columns[1][r]) for r in range(4)],
                  k=20)
    queries = [(sc & mc).top(10), (sc | kw).top(10), (mc - kw).top(10)]
    base = [session.query(q, fused=fused) for q in queries]
    obs.enable(sync_timing=True)
    rec = port_trace.Recorder()
    with port_trace.recording(rec):
        seen = [session.query(q, fused=fused) for q in queries]
    for b, s in zip(base, seen):
        assert b.ids == s.ids
        np.testing.assert_array_equal(b.scores.numpy(), s.scores.numpy())
    assert any(r.name == "merge" for r in rec.roots) == fused


def test_explain_carries_metrics_snapshot(lake):
    session = blend.connect(lake, device="cpu")
    ref = ref_blend.connect(lake)
    t = lake.tables[2]
    q = blend.sc(list(t.columns[0][:6]), k=12) | blend.kw([t.columns[1][0]],
                                                          k=12)
    assert "== metrics ==" not in str(session.explain(q))
    obs.enable()
    ref_obs.enable()
    ex = session.explain(q)
    rq = ref_blend.sc(list(t.columns[0][:6]), k=12) | \
        ref_blend.kw([t.columns[1][0]], k=12)
    ref_ex = ref.explain(rq)
    assert "== metrics ==" in str(ex) and "exec.plans" in str(ex)
    names = ("exec.plans", "exec.launches", "exec.seeker_runs")
    assert [ex.metrics["counters"][n] for n in names] == \
        [ref_ex.metrics["counters"][n] for n in names] == [1, 3, 2]
