"""repro_torch's sharded lakes on the CPU (``dist/shard.py``, the fused
path's per-shard fan-out and merge, shard routing, sharded snapshots),
against the JAX package's sharded session, the port's 1-shard session and
tests/oracle.py.

* The host-layout contracts of tests/test_sharding.py (whole-table
  partitioning, global geometry, ``host_counts`` sums, routing and id
  reuse, ``shape()``) are restated on the port (they import the JAX
  package inside the test), each also held to the JAX package's store.
* tests/test_shardlake.py runs against the port, its two
  approximate-tier cases included: each reference function, and every
  helper of its module, is rebound to a namespace where the lake, plan,
  store, executor and session names are the port's, on the CPU, per
  backend; its hypothesis property is re-wrapped with ``database=None``.
* The port's n-shard answers equal the JAX package's n-shard ``sorted``
  session (ids, scores, masks, overflow, epoch tuple, ``failed_shards``)
  on both port backends, static and after mutations; the JAX package's
  ``bucket`` backend does not trace on this JAX (ROADMAP section C).
* tests/test_distributed.py's contract runs in process, 8 shards on the
  CPU; tests/test_livelake.py's sharded case; ``shard_devices``'s
  placement with four cards faked.
"""
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

import blend as ref_blend
import repro_torch as blend
import test_shardlake as ref_tests
from repro.core.hashing import hash_array as ref_hash_array
from repro.core.lake import Table as RefTable
from repro.core.lake import synthetic_lake as ref_synthetic_lake
from repro.core.plan import Plan as RefPlan
from repro.dist.shard import ShardedExecutor as RefShardedExecutor
from repro.dist.shard import ShardedStore as RefShardedStore
from repro.store import LiveLake as RefLiveLake
from repro_torch import faults, obs
from repro_torch.core import lake as port_lake
from repro_torch.core import plan as port_plan
from repro_torch.core.executor import Executor
from repro_torch.core.hashing import hash_array
from repro_torch.core.lake import Table, synthetic_lake
from repro_torch.dist.shard import ShardedExecutor, ShardedStore, \
    shard_devices
from repro_torch.faults import FaultInjector
from repro_torch.obs import trace as otrace
from repro_torch.store import LiveLake
from repro_torch.store.segments import SegmentStore

from oracle import oracle_ids, oracle_run

BACKENDS = ("sorted", "bucket")
COMBINERS = ("intersect", "union", "counter", "difference")


def _epoch(store):
    ep = store.epoch
    return tuple(int(e) for e in ep) if isinstance(ep, tuple) else int(ep)


# -------------------------------------- tests/test_sharding.py, host layout

@pytest.fixture(scope="module")
def shard_lakes():
    kw = dict(n_tables=20, rows=12, cols=3, vocab=200, seed=3)
    return synthetic_lake(**kw), ref_synthetic_lake(**kw)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_store_partitions_whole_tables(shard_lakes, n_shards):
    lake, ref_lake = shard_lakes
    store = ShardedStore(lake, n_shards=n_shards)
    ref = RefShardedStore(ref_lake, n_shards=n_shards)
    owners = {}
    for i, s in enumerate(store.shards):
        for tid in s.live_ids():
            assert tid not in owners, "table on two shards"
            owners[tid] = i
    assert sorted(owners) == list(range(20))
    assert all(owners[g] == g % n_shards for g in owners)
    assert store.live_ids() == list(range(20))
    assert len({(s.n_tables, s.row_stride, s.max_cols)
                for s in store.shards}) == 1
    assert [s.live_ids() for s in store.shards] == \
        [s.live_ids() for s in ref.shards]
    assert [s.n_postings for s in store.shards] == \
        [s.n_postings for s in ref.shards]


def test_sharded_store_geometry_matches_single_store(shard_lakes):
    lake, ref_lake = shard_lakes
    single = SegmentStore(lake)
    store = ShardedStore(lake, n_shards=4)
    ref = RefShardedStore(ref_lake, n_shards=4)
    for s in (single, ref):
        assert store.n_tables == s.n_tables
        assert store.row_stride == s.row_stride
        assert store.max_cols == s.max_cols
        assert store.n_postings == s.n_postings
        assert (store.alive == s.alive).all()
        assert store.table_names[:20] == s.table_names[:20]


def test_sharded_host_counts_sum_to_single_store(shard_lakes):
    lake, ref_lake = shard_lakes
    vals = list(lake.tables[0].columns[0][:8])
    h = np.unique(hash_array(vals))
    assert (h == np.unique(ref_hash_array(vals))).all()
    single = SegmentStore(lake)
    store = ShardedStore(lake, n_shards=4)
    per = store.host_counts(h, per_shard=True)
    assert per.shape == (4, len(h))
    assert (per.sum(axis=0) == single.host_counts(h)).all()
    assert (store.host_counts(h) == single.host_counts(h)).all()
    ref = RefShardedStore(ref_lake, n_shards=4)
    assert (per == ref.host_counts(h, per_shard=True)).all()


def test_sharded_store_routes_and_reuses_global_ids(shard_lakes):
    lake, ref_lake = shard_lakes
    store = ShardedStore(lake, n_shards=3)
    ref = RefShardedStore(ref_lake, n_shards=3)
    cols = [["a", "b", "c"], [1.0, 2.0, 3.0]]
    target = store.least_loaded()
    assert target == ref.least_loaded()
    tid = store.add_table(Table("routed", cols))
    assert tid == ref.add_table(RefTable("routed", cols)) == 20
    assert store.owner_of("routed") == target == ref.owner_of("routed")
    assert store.epoch == ref.epoch
    assert sum(e != 0 for e in store.epoch) == 1
    store.drop_table(tid)
    ref.drop_table(tid)
    again = [["x", "y"], [0.5, 1.5]]
    tid2 = store.add_table(Table("again", again))
    assert tid2 == ref.add_table(RefTable("again", again)) == tid
    with pytest.raises(KeyError):
        store.owner_of("routed")
    assert store.epoch == ref.epoch
    assert store.owner_of("again") == ref.owner_of("again")


def test_sharded_store_shape_reports_mesh_layout(shard_lakes):
    lake, ref_lake = shard_lakes
    store = ShardedStore(lake, n_shards=2)
    s = store.shape()
    assert s["mode"] == "sharded" and s["shards"] == 2
    assert s["mesh_axes"] == ("shard",) and s["mesh_shape"] == (2,)
    assert len(s["per_shard"]) == 2
    assert sum(p["postings"] for p in s["per_shard"]) == s["postings"]
    assert sum(p["live_tables"] for p in s["per_shard"]) == 20
    want = RefShardedStore(ref_lake, n_shards=2).shape()
    ShardedExecutor(store, device="cpu")            # places the shards
    got = store.shape()
    assert [p.pop("device") for p in got["per_shard"]] == ["cpu", "cpu"]
    for p in want["per_shard"]:
        p.pop("device")
    assert got == want


def test_shard_devices_wrap_onto_the_cards(monkeypatch):
    """Shard i of N on ``cuda:(i % device_count)``; every shard on the CPU
    with ``device="cpu"``; no card and no device raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert shard_devices(6, "cuda") == [torch.device("cuda", i % 4)
                                        for i in range(6)]
    assert shard_devices(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shard_devices(2, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        blend.connect(synthetic_lake(n_tables=3, rows=4, seed=0), shards=2)


# ------------------------------------------- tests/test_shardlake.py, rebound

#: tests/test_shardlake.py's contracts, by the backends they run on: the
#: reference pins the backend of its parity cases (and its sketch probe
#: case its executors' backend, which the probe does not read)
SHARDLAKE = {
    "test_shard_parity_bucket_backend": (None,),
    "test_shard_single_seeker_launches": (None,),
    "test_sharded_matches_oracle": BACKENDS,
    "test_shard_mutation_query_interleaving": BACKENDS,
    "test_shard_cache_hits_after_mutation_settles": BACKENDS,
    "test_shard_sketch_probe_bit_identical": BACKENDS,
    "test_shard_approx_query_parity": BACKENDS,
}


def _port_names(backend: str) -> dict:
    """tests/test_shardlake.py's names, bound to the port's objects; every
    session and executor on the CPU, with ``backend`` unless the caller
    names its own (the JAX package's ``interpret`` flag is dropped)."""

    def connect(lake, **kw):
        return blend.connect(lake, device="cpu", backend=backend, **kw)

    def executor(store, backend=backend, interpret=False, **kw):
        return ShardedExecutor(store, backend=backend, device="cpu", **kw)

    ns = types.SimpleNamespace(**{n: getattr(blend, n)
                                  for n in blend.__all__})
    ns.connect = connect
    return {"blend": ns, "Table": port_lake.Table,
            "synthetic_lake": port_lake.synthetic_lake,
            "Plan": port_plan.Plan, "Seekers": port_plan.Seekers,
            "Combiners": port_plan.Combiners, "LiveLake": LiveLake,
            "ShardedStore": ShardedStore, "ShardedExecutor": executor,
            "oracle_ids": oracle_ids, "oracle_run": oracle_run}


def _port_module(backend: str) -> dict:
    ns = {**vars(ref_tests), **_port_names(backend)}
    for name, fn in vars(ref_tests).items():
        if isinstance(fn, types.FunctionType) and \
                fn.__module__ == ref_tests.__name__:
            ns[name] = types.FunctionType(fn.__code__, ns, name,
                                          fn.__defaults__, fn.__closure__)
    return ns


@pytest.fixture(scope="module")
def lake():
    return synthetic_lake(n_tables=ref_tests.N_TABLES, rows=16, cols=4,
                          vocab=300, seed=11)


@pytest.fixture(scope="module")
def ref_lake():
    return ref_synthetic_lake(n_tables=ref_tests.N_TABLES, rows=16, cols=4,
                              vocab=300, seed=11)


@pytest.mark.parametrize("live", [False, True], ids=["static", "live"])
@pytest.mark.parametrize("comb", COMBINERS)
def test_reference_shard_parity_sorted_holds_for_port(lake, comb, live):
    _port_module("sorted")["test_shard_parity_sorted"](lake, comb, live)


@pytest.mark.parametrize("name,backend", [(n, b) for n, bs in
                                          SHARDLAKE.items() for b in bs])
def test_reference_shardlake_contract_holds_for_port(lake, name, backend):
    fn = _port_module(backend or "sorted")[name]
    if name == "test_shard_parity_bucket_backend":
        for live in (False, True):
            fn(lake, live)
    else:
        fn(lake)


@pytest.mark.parametrize("backend", BACKENDS)
@settings(max_examples=4, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(ref_tests.ops_strategy)
def test_shard_mutation_query_property(backend, ops):
    """tests/test_shardlake.py's property (its strategy, its body rebound
    to the port): any add / drop / query interleaving on a cached 3-shard
    live session equals cold 3-shard and 1-shard sessions."""
    inner = ref_tests.test_shard_mutation_query_property.hypothesis.inner_test
    types.FunctionType(inner.__code__, _port_module(backend),
                       inner.__name__)(ops)


# --------------------------------------------------- against the JAX package

def _ref_executor(ref_lake, n, live):
    store = RefShardedStore(ref_lake, n_shards=n)
    if live:
        ref_tests.mutate(RefLiveLake(ref_lake, store=store,
                                     auto_compact=False), ref_lake)
    return RefShardedExecutor(store, backend="sorted")


def _port_executor(lake, n, live, backend):
    store = ShardedStore(lake, n_shards=n)
    if live:
        _port_module(backend)["mutate"](
            LiveLake(lake, store=store, auto_compact=False), lake)
    return ShardedExecutor(store, backend=backend, device="cpu")


def _same_run(got, want, ctx):
    (rs, info), (ref_rs, ref_info) = got, want
    np.testing.assert_array_equal(rs.scores.numpy(), np.asarray(
        ref_rs.scores), err_msg=str(ctx))
    np.testing.assert_array_equal(rs.mask.numpy(), np.asarray(ref_rs.mask),
                                  err_msg=str(ctx))
    assert [int(t) for t in rs.ids()] == [int(t) for t in ref_rs.ids()], ctx
    assert (info.overflow, info.launches, info.failed_shards) == \
        (ref_info.overflow, ref_info.launches, ref_info.failed_shards), ctx


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("live", [False, True], ids=["static", "live"])
def test_port_shards_equal_reference_shards(lake, ref_lake, backend, live):
    """Port n-shard == JAX n-shard (``sorted``) == port 1-shard, for every
    combiner, optimized and not; epoch tuples equal."""
    port = {n: _port_executor(lake, n, live, backend) for n in (1, 3)}
    ref = _ref_executor(ref_lake, 3, live)
    assert _epoch(port[3].index) == _epoch(ref.index)
    for comb in COMBINERS:
        plan = _port_module(backend)["flat_plan"](lake, comb)
        ref_plan = ref_tests.flat_plan(ref_lake, comb)
        assert isinstance(ref_plan, RefPlan)
        for optimize in (True, False):
            want = ref.run(ref_plan, optimize=optimize)
            for n, ex in port.items():
                _same_run(ex.run(plan, optimize=optimize), want,
                          (backend, live, comb, optimize, n))


@pytest.mark.parametrize("backend", BACKENDS)
def test_port_sharded_session_equals_reference(lake, ref_lake, backend):
    """Session level, live and cached: the same mutations on the port's and
    the JAX package's 3-shard sessions give the same ids, scores, epoch
    tuple, cache statuses and ``explain`` ``== index ==`` block (the
    device names aside)."""
    port = blend.connect(lake, shards=3, live=True, cache=True,
                         backend=backend, device="cpu")
    ref = ref_blend.connect(ref_lake, shards=3, live=True, cache=True)
    t, rt = lake.tables[2], ref_lake.tables[2]

    def queries(api, tab):
        return [(api.sc(list(tab.columns[0][:6]), k=12)
                 & api.kw([tab.columns[1][0]], k=12)).top(8),
                api.mc([(tab.columns[0][r], tab.columns[1][r])
                        for r in range(4)], k=12).top(8),
                api.corr(list(tab.columns[0][:6]),
                         [float(i) for i in range(6)], k=12, h=64)]

    def check(step):
        assert _epoch(port.live.store) == _epoch(ref.live.store), step
        for q, rq in zip(queries(blend, t), queries(ref_blend, rt)):
            got, want = port.query(q), ref.query(rq)
            assert got.ids == want.ids, step
            np.testing.assert_array_equal(got.scores.numpy(),
                                          np.asarray(want.scores))
            assert got.cache.status == want.cache.status, step
            assert (got.info.overflow, got.info.failed_shards) == \
                (want.info.overflow, want.info.failed_shards), step

    check("connect")
    check("again")
    extra = [[f"x{i}" for i in range(8)], [t.columns[0][0]] * 8,
             [float(i) for i in range(8)]]
    assert port.add_table(Table("extra", extra)) == \
        ref.add_table(RefTable("extra", extra))
    check("add_table")
    assert port.drop_table(3) == ref.drop_table(3)
    check("drop_table")
    port.compact()
    ref.compact()
    check("compact")
    q, rq = queries(blend, t)[0], queries(ref_blend, rt)[0]
    got = str(port.explain(q)).splitlines()
    want = str(ref.explain(rq)).splitlines()
    start = got.index("== index ==")
    assert start == want.index("== index ==")
    for a, b in zip(got[start:start + 6], want[start:start + 6]):
        assert a.split("[")[0] == b.split("[")[0]
    assert got[start + 2].endswith("[cpu]")
    with pytest.raises(ValueError, match="reclaim_ids"):
        port.compact(reclaim_ids=True)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_snapshot_restore_and_recover(lake, ref_lake, backend,
                                              tmp_path):
    """A sharded snapshot round-trips in the JAX package's manifest format:
    ``recover`` builds a ``ShardedExecutor`` over it, ``restore`` a plain
    ``Executor`` (as the JAX package does), and both equal the session
    they replace and the JAX package's restored session; the free-id list
    is parked on shard 0."""
    wal = tmp_path / "lake.wal"
    port = blend.connect(lake, shards=3, live=True, backend=backend,
                         device="cpu", wal=str(wal))
    ref = ref_blend.connect(ref_lake, shards=3, live=True)
    for s in (port, ref):
        s.drop_table(5)
        s.drop_table(6)
    port.snapshot(str(tmp_path / "port.snap"))
    ref.snapshot(str(tmp_path / "ref.snap"))
    extra = [[f"y{i}" for i in range(8)], [float(i) for i in range(8)]]
    assert port.add_table(Table("after_snap", extra)) == \
        ref.add_table(RefTable("after_snap", extra))
    back = blend.recover(str(tmp_path / "port.snap"), wal=str(wal),
                         backend=backend, device="cpu")
    assert isinstance(back.executor, ShardedExecutor)
    assert _epoch(back.live.store) == _epoch(port.live.store) == \
        _epoch(ref.live.store)
    restored = blend.restore(str(tmp_path / "port.snap"), backend=backend,
                             device="cpu")
    ref_restored = ref_blend.restore(str(tmp_path / "ref.snap"))
    assert type(restored.executor) is Executor
    assert restored.live.store.shards[0].free_ids == \
        ref_restored.live.store.shards[0].free_ids
    assert all(not s.free_ids for s in restored.live.store.shards[1:])
    t, rt = lake.tables[2], ref_lake.tables[2]
    q = (blend.sc(list(t.columns[0][:6]), k=12)
         | blend.kw([t.columns[1][0]], k=12)).top(8)
    rq = (ref_blend.sc(list(rt.columns[0][:6]), k=12)
          | ref_blend.kw([rt.columns[1][0]], k=12)).top(8)
    for got, want in ((back.query(q), port.query(q)),
                      (restored.query(q), ref_restored.query(rq))):
        assert got.ids == want.ids
        np.testing.assert_array_equal(got.scores.numpy(),
                                      np.asarray(want.scores))


# ----------------------------------- tests/test_distributed.py, in process

def test_distributed_contract_with_8_shards_in_process():
    """tests/test_distributed.py's contract, 8 shards all on the CPU:
    bit-identity with 1 shard, ``launches <= n_kinds + 1``, balanced
    postings, per-shard counts summing to the single store's, one shard's
    epoch moving per ``add_table``, the cache invalidated by the epoch
    tuple."""
    lake = synthetic_lake(n_tables=48, rows=16, cols=4, vocab=500, seed=7)
    t = lake.tables[5]
    s1 = blend.connect(lake, shards=1, device="cpu")
    s8 = blend.connect(lake, shards=8, device="cpu")
    assert len(s8.executor.engines) == 8
    assert s8.executor.devices == [torch.device("cpu")] * 8
    queries = {
        "sc": blend.sc(list(t.columns[0][:6]), k=16).top(8),
        "kw": blend.kw([t.columns[1][0], t.columns[1][1]], k=16).top(8),
        "mc": blend.mc([(t.columns[0][r], t.columns[1][r])
                        for r in range(4)], k=16).top(8),
        "corr": blend.corr(list(t.columns[0][:6]),
                           [float(i) for i in range(6)], k=16,
                           h=64).top(8),
        "and": (blend.sc(list(t.columns[0][:6]), k=16)
                & blend.kw([t.columns[1][0]], k=16)).top(8),
        "or": (blend.sc(list(t.columns[0][:6]), k=16)
               | blend.kw([t.columns[1][0]], k=16)).top(8),
    }
    for name, q in queries.items():
        r1, r8 = s1.query(q), s8.query(q)
        assert torch.equal(r1.scores, r8.scores), name
        assert r1.ids == r8.ids, name
        assert r8.info.overflow == 0, name
        n_kinds = len({n.spec.kind for n in r8.compiled.plan.nodes.values()
                       if n.is_seeker})
        assert r8.info.launches <= n_kinds + 1, (name, r8.info.launches)
        assert r8.info.launches == r1.info.launches, name
    store = s8.executor.index
    per = [s.n_postings for s in store.shards]
    assert sum(per) == store.n_postings
    assert max(per) * 8 <= store.n_postings * 2
    single_bytes = s1.executor.index.storage_bytes()
    assert max(s.storage_bytes() for s in store.shards) * 8 \
        <= single_bytes * 2.5
    h = np.unique(hash_array(list(t.columns[0][:6])))
    pershard = store.host_counts(h, per_shard=True)
    assert pershard.shape[0] == 8
    assert (pershard.sum(axis=0) == s1.executor.index.host_counts(h)).all()

    live8 = blend.connect(lake, shards=8, live=True, cache=True,
                          device="cpu")
    live1 = blend.connect(lake, shards=1, live=True, device="cpu")
    q = queries["and"]
    assert live8.query(q).cache.status == "miss"
    assert live8.query(q).cache.status == "hit"
    extra = Table("delta", [[f"d{i}" for i in range(8)],
                            [t.columns[0][0]] * 8,
                            [float(i) for i in range(8)]])
    before = live8.executor.index.epoch
    assert live8.add_table(extra) == live1.add_table(extra)
    after = live8.executor.index.epoch
    assert sum(a != b for a, b in zip(before, after)) == 1
    live8.drop_table(5)
    live1.drop_table(5)
    r8, r1 = live8.query(q), live1.query(q)
    assert r8.cache.status == "miss"
    assert torch.equal(r8.scores, r1.scores) and r8.ids == r1.ids
    assert live8.query(q).cache.status == "hit"


# ----------------------------------------------------- the live store, obs

def test_sharded_store_accepts_live_mutations():
    """tests/test_livelake.py's sharded case, on the port (held to the JAX
    package's coordinator under the same mutations)."""
    from test_livelake import extra_table, small_live_lake
    ref_lake_ = small_live_lake()
    lake_ = synthetic_lake(n_tables=16, rows=14, cols=4, vocab=200, seed=5)
    assert [t.columns for t in lake_.tables] == \
        [t.columns for t in ref_lake_.tables]
    ll = LiveLake(lake_)
    ref_extra = extra_table(0)
    extra = Table(ref_extra.name, ref_extra.columns, ref_extra.col_names)
    ll.add_table(extra)
    ll.drop_table(2)
    merged = ll.store.merged_index()
    assert (np.diff(merged.cell_hash.astype(np.int64)) >= 0).all()
    assert 2 not in set(merged.table_id.tolist())
    store = ShardedStore(lake_, n_shards=2)
    sl = LiveLake(lake_, store=store)
    sl.add_table(extra)
    sl.drop_table(2)
    assert sorted(sl.live_ids()) == sorted(ll.live_ids())
    assert store.n_postings == sum(s.n_postings for s in store.shards)
    assert 2 in store.pending_dead
    ref_store = RefShardedStore(ref_lake_, n_shards=2)
    ref_sl = RefLiveLake(ref_lake_, store=ref_store)
    ref_sl.add_table(ref_extra)
    ref_sl.drop_table(2)
    assert sl.live_ids() == ref_sl.live_ids()
    assert store.epoch == ref_store.epoch
    assert [s.n_postings for s in store.shards] == \
        [s.n_postings for s in ref_store.shards]


def test_sharded_probe_spans_windows_and_metrics(lake):
    """Each shard probes under its own ``shard:{s}`` span at its own
    window (a rung no wider than the global one, and narrower for some
    shard here), with its ``shard.probe_seconds.{s}`` histogram and the
    ``shard.imbalance`` gauge; the fan-out stays one logical launch."""
    session = blend.connect(lake, shards=4, device="cpu")
    t = lake.tables[2]
    q = blend.sc(list(t.columns[0][:6]) + [t.columns[0][0]] * 2, k=12)
    ref = blend.connect(lake, shards=1, device="cpu")
    rec = otrace.Recorder()
    reg = obs.enable()
    try:
        with otrace.recording(rec):
            res = session.query(q)
        snap = reg.snapshot()
    finally:
        obs.disable()
    assert res.ids == ref.query(q).ids and res.info.launches == 2
    spans = {}

    def walk(span):
        spans.setdefault(span.name, []).append(span)
        for c in span.children:
            walk(c)

    for root in rec.roots:
        walk(root)
    caps = [spans[f"shard:{s}"][0].attrs["m_cap"] for s in range(4)]
    ex = session.executor
    h = ex._hashed(q.values)
    assert max(caps) <= ex._quantize_cap(int(session.index.host_counts(
        h).max()))
    per = session.index.host_counts(h, per_shard=True)
    assert caps == [ex._quantize_cap(int(p.max(initial=1))) for p in per]
    hists = snap["histograms"]
    assert all(f"shard.probe_seconds.{s}" in hists for s in range(4))
    assert snap["gauges"]["shard.imbalance"] >= 1.0


def test_reset_shard_rebuilds_only_that_shard(lake):
    """``reset_shard`` gives shard s a new engine, arena and program cache
    (its captured programs must not outlive the arena they read) and
    leaves the other shards' as they were."""
    session = blend.connect(lake, shards=3, live=True, device="cpu")
    t = lake.tables[2]
    q = blend.kw([t.columns[1][0]], k=12)
    want = session.query(q)
    ex = session.executor
    before = [(sh.engine, sh.arena, sh.programs) for sh in ex.shards]
    assert all(len(p) for _, _, p in before)
    ex.reset_shard(1)
    after = [(sh.engine, sh.arena, sh.programs) for sh in ex.shards]
    assert after[0] == before[0] and after[2] == before[2]
    assert all(a is not b for a, b in zip(after[1], before[1]))
    assert len(after[1][2]) == 0
    got = session.query(q)
    assert got.ids == want.ids and torch.equal(got.scores, want.scores)
    assert len(ex.shards[1].programs)
    with pytest.raises(NotImplementedError, match="single-seeker"):
        ex.run_seeker(None)
    with pytest.raises(TypeError, match="ShardedStore"):
        ShardedExecutor(SegmentStore(lake), device="cpu")
    with pytest.raises(TypeError, match="raw lake"):
        blend.connect(session.live, shards=2, device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("comb", COMBINERS)
def test_degraded_answer_equals_lake_without_the_dead_shard(lake, backend,
                                                           comb):
    """Shard 1 failing on every probe, after a guard table's add / drop /
    re-add: each degraded answer equals, ids and scores, an unsharded live
    session after the same steps with every table shard 1 owns dropped,
    for every combiner, optimized or not.  A dropped shard reads as its
    tables gone, union and counter scores included."""
    plan = _port_module(backend)["flat_plan"](lake, comb)
    session = blend.connect(lake, shards=4, live=True, backend=backend,
                            device="cpu")
    witness = blend.connect(lake, live=True, backend=backend, device="cpu")
    guard = synthetic_lake(n_tables=1, rows=16, cols=4, vocab=300,
                           seed=5).tables[0]
    for s in (session, witness):
        tid = s.add_table(guard, name="guard")
        s.drop_table(tid)
        s.add_table(guard, name="guard_again")
    store = session.live.store
    for tid in witness.live.live_ids():
        if store.owner_of(tid) == 1:
            witness.drop_table(tid)
    witness.executor.refresh()
    for optimize in (True, False):
        with faults.inject(FaultInjector(fail={"shard.probe.1": 10 ** 6})):
            rs, info = session.executor.run(plan, optimize=optimize)
        want, _ = witness.executor.run(plan, optimize=optimize, fused=True)
        assert info.failed_shards == [1]
        assert [int(t) for t in rs.ids()] == [int(t) for t in want.ids()]
        np.testing.assert_array_equal(rs.scores.numpy(), want.scores.numpy())
        np.testing.assert_array_equal(rs.mask.numpy(), want.mask.numpy())
