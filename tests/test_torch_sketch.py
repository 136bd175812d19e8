"""repro_torch's approximate tier on the CPU (``core/sketch.py``,
``Executor.sketch_views`` / ``sketch_probe``, ``Session.query(approx=)``,
``DiscoveryResponse.approx``), against the JAX package's (its ``sorted``
backend: its ``bucket`` backend does not trace on this JAX).

* tests/test_sketch.py's ten contracts run on the port: each reference
  function, and every helper of its module, is rebound to a namespace
  where ``blend``, ``sk``, ``Executor``, ``build_index``,
  ``synthetic_lake``, ``Plan``, ``Seekers`` and ``hash_array`` are the
  port's, every session on the CPU, per backend where a session runs.
* For seeds 0-2 and SC / KW / C at epsilon 0, 0.05 and (0.1, 0.99), on
  both port backends, cached and not, fused and not: every
  ``SketchProbeResult`` field, ``escalation_set``, ``ApproxInfo``, ids,
  scores and ``DiscoveryResponse.approx`` equal the JAX package's.
* Estimates that tie (integer counts) rank as ``lax.top_k`` ranks them.
* The live lake through add / drop / compact and the sharded lake (1 and
  3 shards) equal the JAX package's live and sharded sessions, and at
  epsilon 0 the port's own exact answers.
"""
import types

import numpy as np
import pytest
import torch

import blend as ref_blend
import repro_torch as blend
import test_livelake
import test_sketch as ref_tests
from repro.core.lake import synthetic_lake
from repro.serve.engine import DiscoveryEngine as RefEngine
from repro_torch.core import hashing as port_hashing
from repro_torch.core import lake as port_lake
from repro_torch.core import plan as port_plan
from repro_torch.core import sketch as sk
from repro_torch.core.executor import Executor
from repro_torch.core.index import build_index
from repro_torch.serve.engine import DiscoveryEngine

from test_livelake import extra_table, small_live_lake

BACKENDS = ("sorted", "bucket")
EPSILONS = ({"epsilon": 0.0}, {"epsilon": 0.05},
            {"epsilon": 0.1, "confidence": 0.99})
PROBE_FIELDS = ("est", "bound_lo", "bound_hi", "ci_lo", "ci_hi",
                "impossible")
INFO_FIELDS = ("kind", "estimator", "escalated", "candidates", "threshold",
               "escalated_ids", "fallback")


# ------------------------------------------------------------- comparisons

def assert_same_probe(got, want, msg=""):
    """Two ``SketchProbeResult``s agree field for field, bit for bit."""
    assert (got.kind, got.estimator, got.sound, got.launches) == \
        (want.kind, want.estimator, want.sound, want.launches), msg
    for f in PROBE_FIELDS:
        x, y = getattr(got, f), getattr(want, f)
        assert (x is None) == (y is None), f"{msg} {f}"
        if x is not None:
            assert x.dtype == y.dtype, f"{msg} {f}"
            np.testing.assert_array_equal(x, y, err_msg=f"{msg} {f}")


def assert_same_info(got, want, msg=""):
    """Two ``ApproxInfo``s agree (all but the probe's wall seconds)."""
    assert got.params.key() == want.params.key(), msg
    for f in INFO_FIELDS:
        assert getattr(got, f) == getattr(want, f), f"{msg} {f}"
    for f in ("est", "ci_lo", "ci_hi"):
        x, y = getattr(got, f), getattr(want, f)
        assert (x is None) == (y is None), f"{msg} {f}"
        if x is not None:
            assert x.dtype == y.dtype, f"{msg} {f}"
            np.testing.assert_array_equal(x, y, err_msg=f"{msg} {f}")


def assert_same_approx(got, want, msg=""):
    """A port ``QueryResult`` of ``query(approx=)`` equals the JAX
    package's: ids, scores, ``ExecInfo.launches`` and ``approx``."""
    assert got.ids == want.ids, msg
    np.testing.assert_array_equal(got.scores.numpy(),
                                  np.asarray(want.scores), err_msg=msg)
    assert got.info.launches == want.info.launches, msg
    assert_same_info(got.approx, want.approx, msg)


def response_approx(resp) -> dict:
    """``DiscoveryResponse.approx`` without the probe's wall seconds."""
    return {k: v for k, v in resp.approx.items() if k != "probe_seconds"}


# ------------------------------------------ tests/test_sketch.py, rebound

#: tests/test_sketch.py's contracts: name -> (argument tuples, whether it
#: opens a session and so runs per port backend)
CONTRACTS = {
    "test_containment_coverage": ([("SC", ref_tests.oracle_sc),
                                   ("KW", ref_tests.oracle_kw)], False),
    "test_correlation_coverage": ([()], False),
    "test_kmv_union_coverage": ([()], False),
    "test_minhash_jaccard_coverage": ([()], False),
    "test_epsilon_zero_identical_ids": (
        [(kind, seed) for kind in ("SC", "KW", "C") for seed in (0, 1, 2)],
        True),
    "test_default_epsilon_reports_estimates": ([()], True),
    "test_escalation_set_semantics": ([()], False),
    "test_approx_params_normalization": ([()], False),
    "test_mc_and_multinode_fall_back_exact": ([()], True),
    "test_sketches_deterministic_and_seeded": ([()], False),
}


def _port_module(backend: str) -> dict:
    """tests/test_sketch.py's namespace with its names bound to the port's
    objects (every session and executor on the CPU with ``backend``) and
    every function it defines rebound to that namespace."""

    def connect(lake, **kw):
        return blend.connect(lake, device="cpu", backend=backend, **kw)

    ns_blend = types.SimpleNamespace(**{n: getattr(blend, n)
                                        for n in blend.__all__})
    ns_blend.connect = connect
    ns = {**vars(ref_tests), "blend": ns_blend, "sk": sk,
          "Executor": lambda idx, **kw: Executor(idx, device="cpu",
                                                 backend=backend, **kw),
          "build_index": build_index,
          "synthetic_lake": port_lake.synthetic_lake,
          "Plan": port_plan.Plan, "Seekers": port_plan.Seekers,
          "hash_array": port_hashing.hash_array}
    # the port's SMALL config, in the namespace and in the defaults that
    # captured the reference's
    ns["SMALL"] = sk.SketchConfig(**vars(ref_tests.SMALL))
    for name, fn in vars(ref_tests).items():
        if isinstance(fn, types.FunctionType) and \
                fn.__module__ == ref_tests.__name__:
            defaults = fn.__defaults__ and tuple(
                ns["SMALL"] if d is ref_tests.SMALL else d
                for d in fn.__defaults__)
            ns[name] = types.FunctionType(fn.__code__, ns, name, defaults,
                                          fn.__closure__)
    return ns


@pytest.mark.parametrize("name,args,backend", [
    (name, args, backend)
    for name, (cases, per_backend) in CONTRACTS.items()
    for args in cases
    for backend in (BACKENDS if per_backend else ("sorted",))],
    ids=lambda v: v if isinstance(v, str) else
    "-".join(a if isinstance(a, str) else str(a) if isinstance(a, int)
             else a.__name__ for a in v) or "-")
def test_reference_sketch_contract_holds_for_port(name, args, backend):
    _port_module(backend)[name](*args)


def test_contract_table_covers_reference_module():
    """Every test function of tests/test_sketch.py runs above."""
    names = {n for n, fn in vars(ref_tests).items()
             if n.startswith("test_") and callable(fn)}
    assert names == set(CONTRACTS)


# ------------------------------------------------ against the JAX package

def _parity_lake(seed):
    """30 tables of 80-160 rows over a 2,000-token vocabulary: most text
    columns hold more distinct values than the sketches' K = 128 and every
    table more than K, and the row sample (64) is under the row count, so
    SC, KW and C all estimate."""
    return synthetic_lake(n_tables=30, rows=160, cols=4, vocab=2000,
                          seed=seed, numeric_cols=2)


#: the parity queries: each kind, SC also over one small table's column
#: (a lossless sketch, so no table escalates) and C over keys no table
#: holds (no table can join, so none escalates)
LABELS = ("SC", "SC narrow", "KW", "C", "C unjoinable")


def _queries(lake, seed, mod):
    """The ``LABELS`` queries of ``mod`` (``repro_torch`` or ``blend``) over
    ``lake``'s own cells: 120 text cells of random tables; the smallest
    table's first column; one table's first column joined to its first
    numeric column."""
    rng = np.random.default_rng(seed + 500)
    cells = []
    for _ in range(120):
        t = lake.tables[int(rng.integers(lake.n_tables))]
        cells.append(t.columns[int(rng.integers(2))]
                     [int(rng.integers(t.n_rows))])
    t = lake.tables[int(rng.integers(lake.n_tables))]
    keys = list(t.columns[0][:48])
    target = [float(v) for v in t.columns[2][:48]]
    small = min(lake.tables, key=lambda t: t.n_rows)
    return {"SC": mod.sc(cells, k=8), "KW": mod.kw(cells, k=8),
            "SC narrow": mod.sc(list(small.columns[0]), k=1),
            "C": mod.corr(keys, target, k=8, h=64),
            "C unjoinable": mod.corr([f"absent_{i}" for i in range(16)],
                                     target[:16], k=8, h=64)}


@pytest.fixture(scope="module", params=[0, 1, 2])
def parity(request):
    """(seed, lake, the JAX package's uncached and cached sessions)."""
    seed = request.param
    lake = _parity_lake(seed)
    return seed, lake, {False: ref_blend.connect(lake),
                        True: ref_blend.connect(lake, cache=True)}


@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_approx_matches_reference(parity, backend, label):
    """Probe, escalation set, ApproxInfo, ids, scores, launches, cache
    statuses and ``DiscoveryResponse.approx`` at each epsilon, cached and
    not, fused and not."""
    seed, lake, refs = parity
    q = _queries(lake, seed, blend)[label]
    ref_q = _queries(lake, seed, ref_blend)[label]
    ports = {cached: blend.connect(lake, cache=cached, backend=backend,
                                   device="cpu") for cached in (False, True)}
    spec = ports[False].compile(q).plan.nodes[
        ports[False].compile(q).plan.output].spec
    ref_compiled = refs[False].compile(ref_q)
    ref_spec = ref_compiled.plan.nodes[ref_compiled.plan.output].spec
    escalations = 0
    for approx in EPSILONS:
        params = sk.ApproxParams.of(approx)
        msg = f"seed {seed} {label} {approx}"
        probe = ports[False].executor.sketch_probe(spec, params.confidence)
        ref_probe = refs[False].executor.sketch_probe(ref_spec,
                                                      params.confidence)
        assert_same_probe(probe, ref_probe, msg)
        esc, cand, thresh = sk.escalation_set(probe, spec.k, params)
        ref_esc, ref_cand, ref_thresh = ref_tests.sk.escalation_set(
            ref_probe, ref_spec.k, ref_tests.sk.ApproxParams.of(approx))
        np.testing.assert_array_equal(esc, ref_esc, err_msg=msg)
        assert (cand, thresh) == (ref_cand, ref_thresh), msg
        escalations += bool(len(esc))
        for cached, port in ports.items():
            ref = refs[cached]
            for fused in (False, True):
                if cached:
                    port.cache.clear()
                    ref.cache.clear()
                for attempt in ("first", "again"):
                    got = port.query(q, approx=approx, fused=fused)
                    want = ref.query(ref_q, approx=approx, fused=fused)
                    m = f"{msg} cached={cached} fused={fused} {attempt}"
                    assert_same_approx(got, want, m)
                    if cached:
                        assert got.cache.status == want.cache.status, m
                        assert got.cache.status == (
                            "miss" if attempt == "first" else "hit"), m
                    else:
                        assert got.cache is None, m
            resp = DiscoveryEngine(None, session=port).serve(q, approx=approx)
            ref_resp = RefEngine(None, session=ref).serve(ref_q,
                                                          approx=approx)
            assert resp.table_ids == ref_resp.table_ids, msg
            assert response_approx(resp) == response_approx(ref_resp), msg
            assert all(type(v) is float for e in
                       resp.approx.get("estimates", {}).values()
                       for v in e.values())
    # a narrow or unjoinable query answers from the estimates alone, the
    # others escalate; C always does at epsilon 0 when a table can join
    assert escalations == (0 if label in ("SC narrow", "C unjoinable")
                           else len(EPSILONS))


def test_parity_lakes_saturate_the_sketches():
    """The parity lakes' sketches estimate: some column KMVs and every
    table-level KMV are saturated, and the row sample is a sample."""
    for seed in (0, 1, 2):
        idx = build_index(_parity_lake(seed))
        sketches = idx.sketches.values()
        k, samples = idx.sketch_config.k, idx.sketch_config.samples
        assert any((s.kmv_m == k).any() for s in sketches)
        assert all(s.tbl_m == k for s in sketches)
        assert all(len(s.samp_rows) == samples < s.n_rows for s in sketches)


@pytest.mark.parametrize("kind", ["SC", "KW"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_tied_estimates_rank_like_reference(backend, kind):
    """12 tokens over 40 tables: every sketch is lossless, so no table
    escalates and the answer is the top-k of integer estimates with many
    ties, cut as ``lax.top_k`` cuts them (the lowest id first), equal to
    the port's exact answer."""
    lake = synthetic_lake(n_tables=40, rows=16, cols=3, vocab=12, seed=4)
    tokens = [f"tok_{i}" for i in range(12)]
    port = blend.connect(lake, backend=backend, device="cpu")
    ref = ref_blend.connect(lake)
    mk = {"SC": "sc", "KW": "kw"}[kind]
    q, ref_q = getattr(blend, mk)(tokens, k=10), \
        getattr(ref_blend, mk)(tokens, k=10)
    got = port.query(q, approx={"epsilon": 0.05})
    assert got.approx.escalated == 0
    assert_same_approx(got, ref.query(ref_q, approx={"epsilon": 0.05}))
    top = got.scores.numpy()[got.ids]
    assert len(set(top.tolist())) < len(top)          # ties inside the cut
    est = got.approx.est
    assert (est == top[-1]).sum() > (top == top[-1]).sum()  # and across it
    exact = port.query(q)
    assert got.ids == exact.ids
    assert torch.equal(got.scores, exact.scores)


def _live_specs(lake, mod_plan):
    """tests/test_livelake.py's three approximate specs."""
    vals = list(lake.tables[3].columns[0][:8])
    return [mod_plan.Seekers.SC(vals, k=10), mod_plan.Seekers.KW(vals, k=10),
            mod_plan.Seekers.Correlation(vals, [float(i) for i in range(8)],
                                         k=10, h=64)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_live_approx_matches_reference_through_mutations(backend):
    """tests/test_livelake.py's cached live session through add, drop and
    compact: at every stage the port's sketch map equals the JAX
    package's field for field, each spec's approximate answer at every
    epsilon equals the JAX live session's, and at epsilon 0 the port's own
    exact answer."""
    from repro.core import plan as ref_plan
    lake = small_live_lake(seed=65)
    port = blend.connect(lake, live=True, cache=True, backend=backend,
                         device="cpu")
    ref = ref_blend.connect(lake, live=True, cache=True)
    specs = list(zip(_live_specs(lake, port_plan),
                     _live_specs(lake, ref_plan)))

    def check(stage):
        got_map = port.live.store.sketch_map()
        want_map = ref.live.store.sketch_map()
        assert set(got_map) == set(want_map), stage
        for t, s in want_map.items():
            assert got_map[t].tbl_m == s.tbl_m, stage
            for f in test_livelake.SKETCH_FIELDS:
                np.testing.assert_array_equal(getattr(got_map[t], f),
                                              getattr(s, f), err_msg=stage)
        for spec, ref_spec in specs:
            p, rp = port_plan.Plan(), ref_plan.Plan()
            p.add("out", spec)
            rp.add("out", ref_spec)
            for approx in EPSILONS:
                msg = f"{stage} {spec.kind} {approx}"
                assert_same_probe(
                    port.executor.sketch_probe(spec),
                    ref.executor.sketch_probe(ref_spec), msg)
                got = port.query(p, approx=approx)
                want = ref.query(rp, approx=approx)
                assert_same_approx(got, want, msg)
                assert got.cache.status == want.cache.status, msg
            exact = port.query(p)
            approx0 = port.query(p, approx={"epsilon": 0.0})
            assert approx0.ids == exact.ids, stage
            assert torch.equal(approx0.scores, exact.scores), stage

    check("initial")
    tables = {}
    for s in (port, ref):
        tables[s] = s.add_table(extra_table(6))
    assert tables[port] == tables[ref]
    check("after add")
    for s in (port, ref):
        s.drop_table(tables[s])
        s.drop_table(5)
    check("after drop")
    for s in (port, ref):
        s.compact()
    check("after compact")


@pytest.mark.parametrize("backend", BACKENDS)
def test_reference_live_approx_contract_holds_for_port(backend):
    """tests/test_livelake.py's ``test_approx_query_parity_through_
    mutations``, rebound to the port (cached live session on the CPU)."""
    fn = test_livelake.test_approx_query_parity_through_mutations

    def connect(lake, **kw):
        return blend.connect(lake, device="cpu", backend=backend, **kw)

    ns = {**vars(test_livelake), "Plan": port_plan.Plan,
          "Seekers": port_plan.Seekers,
          "blend": types.SimpleNamespace(connect=connect)}
    types.FunctionType(fn.__code__, ns, fn.__name__)()


def test_live_views_rebuild_once_per_epoch_move():
    """The executor's sketch views are memoized on the store's epoch: two
    probes at one epoch share the views, every mutation rebuilds them once,
    and a dropped table answers 0 at once."""
    lake = small_live_lake(seed=65)
    ses = blend.connect(lake, live=True, device="cpu")
    ex = ses.executor
    spec = _live_specs(lake, port_plan)[1]
    ex.sketch_probe(spec)
    views = ex.sketch_views()
    ex.sketch_probe(spec)
    assert ex.sketch_views() is views
    tid = ses.add_table(extra_table(6))
    assert ex.sketch_views() is not views
    ses.drop_table(3)
    probe = ex.sketch_probe(spec)
    assert probe.bound_hi[3] == 0 and probe.est[3] == 0
    assert ex.sketch_views()[0].n_tables == ses.index.n_tables > tid


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_approx_matches_reference(backend):
    """1- and 3-shard port sessions against the JAX package's 3-shard
    session: each kind's probe bit for bit, and the approximate answers
    at every epsilon; at epsilon 0 the exact answer."""
    lake = synthetic_lake(n_tables=24, rows=40, cols=4, vocab=300, seed=11,
                          numeric_cols=2)
    ref = ref_blend.connect(lake, shards=3)
    ports = {n: blend.connect(lake, shards=n, backend=backend, device="cpu")
             for n in (1, 3)}
    qs, ref_qs = _queries(lake, 3, blend), _queries(lake, 3, ref_blend)
    for kind, q in qs.items():
        compiled = ref.compile(ref_qs[kind])
        ref_spec = compiled.plan.nodes[compiled.plan.output].spec
        spec = ports[1].compile(q).plan.nodes[
            ports[1].compile(q).plan.output].spec
        for n, port in ports.items():
            assert len(port.executor.sketch_views()) == n
            assert_same_probe(port.executor.sketch_probe(spec),
                              ref.executor.sketch_probe(ref_spec),
                              f"{kind} shards={n}")
            for approx in EPSILONS:
                assert_same_approx(port.query(q, approx=approx),
                                   ref.query(ref_qs[kind], approx=approx),
                                   f"{kind} shards={n} {approx}")
            exact = port.query(q)
            assert port.query(q, approx={"epsilon": 0.0}).ids == exact.ids
