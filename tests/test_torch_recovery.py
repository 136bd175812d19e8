"""repro_torch's durability layer on the CPU, against the JAX package's
recovery contracts (tests/test_recovery.py).

The centerpiece is the crash-at-every-fault-point property on both port
backends: the port runs tests/test_recovery.py's mutation script under its
own ``FaultInjector``, crashing at every fault point the clean run crosses
(the same names, the same hit counts as the JAX package's matrix), and
``repro_torch.recover`` must rebuild the exact acknowledged prefix — ids,
scores and epoch equal to the JAX package's uninterrupted run at that
prefix.  Torn WAL tails are truncated, never partially replayed.  The
same matrix runs on a 4-shard lake (the JAX package's ``shards4``
configurations): sharded snapshots, WAL records that carry their shard,
and the epoch tuple.

tests/test_recovery.py's shard-failure cases run on the port with their
module's names bound to the port's (every session and engine on the CPU,
per backend): a shard probe that fails once is retried transparently; one
that fails twice is dropped, with zero wrong results and the response
flagged ``degraded``.

The WAL-format and snapshot-hardening tests of tests/test_recovery.py run
unchanged with their module names bound to the port's modules (as
tests/test_torch_obs.py does for the observability contracts).
"""
import types

import numpy as np
import pytest

import blend as ref_blend
import repro_torch as blend
import test_recovery
from repro import faults as ref_faults
from repro_torch import errors, faults, obs
from repro_torch.core import lake as port_lake
from repro_torch.faults import FaultInjector, InjectedCrash
from repro_torch.serve.engine import DiscoveryEngine
from repro_torch.store import LiveLake
from repro_torch.store import snapshot as snap
from repro_torch.store import wal as walmod

from test_recovery import MUTATIONS, STEPS, apply_step, extra_table, mk_lake

BACKENDS = ("sorted", "bucket")


def probe_query(api, lake, k=20):
    """tests/test_recovery.py's probe query, built with ``api``."""
    t = lake.tables[1]
    sc = api.sc(list(t.columns[0][:8]), k=k)
    kw = api.kw([t.columns[1][0], t.columns[1][2]], k=k)
    return (sc & kw).top(10)


def capture(session, api):
    """(ids, scores, epoch) through the fused path; a sharded lake's epoch
    is its tuple of shard epochs."""
    res = session.query(probe_query(api, mk_lake()), fused=True)
    ep = session.live.store.epoch
    ep = tuple(int(e) for e in ep) if isinstance(ep, tuple) else int(ep)
    return (tuple(res.ids), np.asarray(res.scores).copy(), ep)


def assert_state_equal(got, want, msg):
    assert got[0] == want[0], f"{msg}: ids {got[0]} != {want[0]}"
    np.testing.assert_array_equal(got[1], want[1], err_msg=msg)
    assert got[2] == want[2], f"{msg}: epoch {got[2]} != {want[2]}"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's uninterrupted run, once per module: the state
    after each acknowledged-mutation prefix, and its crash matrix (every
    fault point its clean scripted run crosses, with first and last hit)."""
    session = ref_blend.connect(mk_lake(), live=True)
    states = [capture(session, ref_blend)]
    for mut in MUTATIONS:
        apply_step(session, mut)
        states.append(capture(session, ref_blend))
    matrix = test_recovery.crash_occurrences(
        tmp_path_factory.mktemp("reference"), "sorted", None)
    return states, matrix


@pytest.fixture(scope="module")
def sharded_reference(tmp_path_factory):
    """As ``reference``, on the JAX package's 4-shard live lake."""
    session = ref_blend.connect(mk_lake(), live=True, shards=SHARDS)
    states = [capture(session, ref_blend)]
    for mut in MUTATIONS:
        apply_step(session, mut)
        states.append(capture(session, ref_blend))
    matrix = test_recovery.crash_occurrences(
        tmp_path_factory.mktemp("sharded_reference"), "sorted", SHARDS)
    return states, matrix


#: the JAX package's ``shards4`` configurations
SHARDS = 4


def run_script(tmp_path, backend, injector, shards=None):
    """Connect a port session with a WAL, take a baseline snapshot, then
    run STEPS under ``injector``.  Returns (acked, point, hit)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    session = blend.connect(mk_lake(), live=True, backend=backend,
                            device="cpu", wal=str(tmp_path / "lake.wal"),
                            shards=shards)
    sp = str(tmp_path / "lake.snap")
    session.snapshot(sp)          # baseline: initial lake is durable
    acked = 0
    try:
        with faults.inject(injector):
            for st in STEPS:
                if st == "snap":
                    session.snapshot(sp)
                else:
                    apply_step(session, st)
                    acked += 1
        return acked, None, 0
    except InjectedCrash as e:
        return acked, e.point, e.hit


def recovered_state(tmp_path, backend):
    sess = blend.recover(str(tmp_path / "lake.snap"),
                         wal=str(tmp_path / "lake.wal"), backend=backend,
                         device="cpu")
    return capture(sess, blend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_crash_at_every_fault_point_recovers_reference_prefix(
        tmp_path, reference, backend):
    refs, ref_matrix = reference
    rec = FaultInjector(record=True)
    acked, point, _ = run_script(tmp_path / "record", backend, rec)
    assert point is None and acked == len(MUTATIONS)
    matrix = [(p, n) for p in rec.points for n in sorted({1, rec.hits[p]})]
    assert matrix == ref_matrix           # the same points, the same hits
    assert {p for p, _ in matrix} >= {
        "store.add.pre", "store.add.post", "store.drop.pre",
        "store.drop.post", "store.compact.pre", "store.compact.post",
        "wal.append.pre", "wal.append.post", "snapshot.write.pre",
        "snapshot.rename.pre", "snapshot.post"}
    for i, (point, hit) in enumerate(matrix):
        d = tmp_path / f"run{i}"
        acked, cpoint, chit = run_script(
            d, backend, FaultInjector(crash={point: hit}))
        assert (cpoint, chit) == (point, hit)
        want = refs[test_recovery.expected_prefix(point, hit, acked)]
        assert_state_equal(recovered_state(d, backend), want,
                           f"crash at {point} hit {hit} (acked={acked})")


@pytest.mark.parametrize("backend", BACKENDS)
def test_torn_wal_tail_truncated_never_partially_replayed(
        tmp_path, reference, backend):
    refs, _ = reference
    for n in range(1, len(MUTATIONS) + 1):
        d = tmp_path / f"torn{n}"
        inj = FaultInjector(seed=n, torn={"wal.append.torn": n})
        acked, point, _ = run_script(d, backend, inj)
        assert point == "wal.append.torn" and acked == n - 1
        assert_state_equal(recovered_state(d, backend), refs[acked],
                           f"torn append {n}")
        _, _, torn = walmod.scan(d / "lake.wal")
        assert not torn


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_crash_at_every_fault_point_recovers_reference_prefix(
        tmp_path, sharded_reference, backend):
    """The crash matrix on 4 shards: the same points and hits as the JAX
    package's ``sorted-shards4`` matrix, each crash recovering the JAX
    package's prefix state, epoch tuple included (``recover`` builds the
    sharded store from the snapshot's manifest)."""
    refs, ref_matrix = sharded_reference
    rec = FaultInjector(record=True)
    acked, point, _ = run_script(tmp_path / "record", backend, rec, SHARDS)
    assert point is None and acked == len(MUTATIONS)
    matrix = [(p, n) for p in rec.points for n in sorted({1, rec.hits[p]})]
    assert matrix == ref_matrix
    for i, (point, hit) in enumerate(matrix):
        d = tmp_path / f"run{i}"
        acked, cpoint, chit = run_script(
            d, backend, FaultInjector(crash={point: hit}), SHARDS)
        assert (cpoint, chit) == (point, hit)
        want = refs[test_recovery.expected_prefix(point, hit, acked)]
        got = recovered_state(d, backend)
        assert isinstance(got[2], tuple) and len(got[2]) == SHARDS
        assert_state_equal(got, want,
                           f"crash at {point} hit {hit} (acked={acked})")


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_torn_wal_tail_truncated_never_partially_replayed(
        tmp_path, sharded_reference, backend):
    refs, _ = sharded_reference
    for n in range(1, len(MUTATIONS) + 1):
        d = tmp_path / f"torn{n}"
        inj = FaultInjector(seed=n, torn={"wal.append.torn": n})
        acked, point, _ = run_script(d, backend, inj, SHARDS)
        assert point == "wal.append.torn" and acked == n - 1
        assert_state_equal(recovered_state(d, backend), refs[acked],
                           f"torn append {n}")
        _, _, torn = walmod.scan(d / "lake.wal")
        assert not torn


def test_sharded_wal_records_carry_their_shard(tmp_path):
    """Each ``add_table`` record names the shard it was routed to, and a
    cold WAL-only ``recover(shards=)`` replays it there: placement and
    epoch tuple equal the uninterrupted run's."""
    wp = str(tmp_path / "s.wal")
    session = blend.connect(mk_lake(), live=True, shards=SHARDS,
                            device="cpu", wal=wp)
    for i in range(3):
        session.add_table(extra_table(i))
    session.drop_table(2)
    records, _ = walmod.recover_records(wp)
    store = session.live.store
    adds = [r for r in records if r["op"] == "add_table"]
    assert [r["shard"] for r in adds] == [store.owner_of(r["tid"])
                                          for r in adds]
    assert all(isinstance(r["epoch"], list) for r in records)
    empty = blend.connect(port_lake.DataLake([]), live=True, shards=SHARDS,
                          device="cpu", wal=str(tmp_path / "e.wal"))
    for i in range(3):
        empty.add_table(extra_table(i))
    empty.drop_table(1)
    back = blend.recover(wal=str(tmp_path / "e.wal"), shards=SHARDS,
                         device="cpu")
    assert hasattr(back.live.store, "shards")
    assert back.live.store.epoch == empty.live.store.epoch
    assert [s.live_ids() for s in back.live.store.shards] == \
        [s.live_ids() for s in empty.live.store.shards]


def test_recovered_lake_keeps_logging(tmp_path):
    """A recovered lake appends to the same WAL with its seq continued, so
    a second recovery replays both lives."""
    wp = str(tmp_path / "k.wal")
    ll = LiveLake(None, wal=wp)
    ll.add_table(extra_table(0))
    rec = LiveLake.recover(wal=wp)
    rec.add_table(extra_table(1))
    again = LiveLake.recover(wal=wp)
    assert again.live_ids() == rec.live_ids() == [0, 1]
    assert again.store.epoch == rec.store.epoch


def test_wal_group_commit_bulk_add(tmp_path):
    reg = obs.enable()          # the port's metrics count the barriers
    try:
        w = walmod.WriteAheadLog(tmp_path / "g.wal", fsync=True)
        ll = LiveLake(None, wal=w)
        tids = ll.add_tables([extra_table(i) for i in range(4)])
        assert len(tids) == 4
        assert reg.counter("wal.fsyncs").value == 1     # one barrier ...
        assert reg.counter("wal.appends").value == 4
        assert w.fsync is True                  # per-record barrier restored
        w.close()
    finally:
        obs.disable()
    records, last = walmod.recover_records(tmp_path / "g.wal")
    assert [r["op"] for r in records] == ["add_table"] * 4 and last == 4
    rec = LiveLake.recover(wal=tmp_path / "g.wal")   # ... same records
    assert rec.live_ids() == ll.live_ids()
    assert rec.store.epoch == ll.store.epoch


# --------------------------------------------------------------------------
# tests/test_recovery.py's unit contracts, bound to the port's modules
# --------------------------------------------------------------------------

PORT_NAMES = {
    "walmod": walmod, "snap": snap, "LiveLake": LiveLake, "faults": faults,
    "FaultInjector": FaultInjector, "InjectedCrash": InjectedCrash,
    "CorruptSnapshot": errors.CorruptSnapshot,
    "WalReplayError": errors.WalReplayError, "BlendFault": errors.BlendFault,
}
#: reference helpers the contracts call, rebuilt over the same names
HELPERS = ("_write_wal", "_saved_store")
CONTRACTS = {
    "test_wal_only_cold_start_recovery": (),
    "test_wal_roundtrip_and_seq_floor": (),
    "test_wal_torn_tail_truncation": ("one_byte", "header", "mid_payload"),
    "test_wal_preallocated_zero_tail_recovers": (),
    "test_wal_midlog_corruption_raises": (),
    "test_snapshot_version1_still_loads": (),
    "test_snapshot_unsupported_version_raises": (),
    "test_snapshot_checksum_detects_corruption": ("bitflip", "truncate"),
    "test_snapshot_generation_fallback": (),
}


def _bound(name):
    names = {**vars(test_recovery), **PORT_NAMES}
    for helper in HELPERS:
        ref_fn = getattr(test_recovery, helper)
        names[helper] = types.FunctionType(ref_fn.__code__, names, helper,
                                           ref_fn.__defaults__)
    return types.FunctionType(getattr(test_recovery, name).__code__, names,
                              name)


@pytest.mark.parametrize("name,arg", [(n, a) for n, args in CONTRACTS.items()
                                      for a in (args or (None,))])
def test_reference_recovery_contract_holds_for_port(tmp_path, name, arg):
    fn = _bound(name)
    if arg is None:
        fn(tmp_path)
    else:
        fn(tmp_path, arg)
    assert ref_faults.active() is None


# --------------------------------- tests/test_recovery.py, shard failures

#: tests/test_recovery.py's shard-failure cases
SHARD_FAILURES = ("test_shard_failure_transparent_after_retry",
                  "test_shard_failure_degrades_with_zero_wrong_results",
                  "test_degraded_response_flagged_by_server")


def _failure_names(backend: str) -> dict:
    """tests/test_recovery.py's namespace with its lake, expression,
    session, engine and fault names bound to the port's (on the CPU, on
    ``backend``) and its helpers rebound to it."""

    def connect(lake, **kw):
        return blend.connect(lake, device="cpu", backend=backend, **kw)

    class Engine(DiscoveryEngine):
        def __init__(self, lake, **kw):
            super().__init__(lake, device="cpu", backend=backend, **kw)

    api = types.SimpleNamespace(**{n: getattr(blend, n)
                                   for n in blend.__all__})
    api.connect = connect
    ns = {**vars(test_recovery), "blend": api, "DiscoveryEngine": Engine,
          "faults": faults, "FaultInjector": FaultInjector,
          "Table": port_lake.Table, "synthetic_lake": port_lake.synthetic_lake}
    for name, fn in vars(test_recovery).items():
        if isinstance(fn, types.FunctionType) and \
                fn.__module__ == test_recovery.__name__:
            ns[name] = types.FunctionType(fn.__code__, ns, name,
                                          fn.__defaults__, fn.__closure__)
    return ns


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", SHARD_FAILURES)
def test_reference_shard_failure_contract_holds_for_port(name, backend):
    reg = obs.enable()
    try:
        _failure_names(backend)[name]()
        counters = reg.snapshot()["counters"]
    finally:
        obs.disable()
    # one failure retried; two failures (the failing shard's probe and
    # its retry) dropped once per query the contract runs degraded
    assert counters["shard.failures"] >= 1
    if name == "test_shard_failure_transparent_after_retry":
        assert counters["shard.retries"] == 1
        assert "shard.dropped" not in counters
    else:
        assert counters["shard.dropped"] == 1
        assert "shard.retries" not in counters
    assert ref_faults.active() is None and faults.active() is None


@pytest.mark.parametrize("backend", BACKENDS)
def test_shard_failure_equals_reference_degraded_response(backend):
    """The JAX package's and the port's 4-shard sessions, the same shard
    failing twice: the same degraded ids and scores, ``failed_shards``
    equal, and a clean query afterwards equal to the clean run (the
    failed shard was rebuilt)."""
    lake, ref_lake = port_lake.synthetic_lake(
        n_tables=10, rows=12, cols=3, vocab=160, seed=2), mk_lake()
    port = blend.connect(lake, live=True, shards=SHARDS, backend=backend,
                         device="cpu")
    ref = ref_blend.connect(ref_lake, live=True, shards=SHARDS)
    q, rq = probe_query(blend, lake), probe_query(ref_blend, ref_lake)
    clean = port.query(q, fused=True)
    for point, hits in (("shard.probe.1", 2), ("shard.probe.3", 1)):
        with faults.inject(FaultInjector(fail={point: hits})):
            got = port.query(q, fused=True)
        with ref_faults.inject(ref_faults.FaultInjector(fail={point: hits})):
            want = ref.query(rq, fused=True)
        assert got.info.failed_shards == want.info.failed_shards
        assert got.ids == want.ids
        np.testing.assert_array_equal(got.scores.numpy(),
                                      np.asarray(want.scores))
    again = port.query(q, fused=True)
    assert again.ids == clean.ids and again.info.failed_shards == []
    np.testing.assert_array_equal(again.scores.numpy(), clean.scores.numpy())
