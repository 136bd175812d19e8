"""repro_torch's durability layer on the CPU, against the JAX package's
recovery contracts (tests/test_recovery.py).

The centerpiece is the crash-at-every-fault-point property on both port
backends: the port runs tests/test_recovery.py's mutation script under its
own ``FaultInjector``, crashing at every fault point the clean run crosses
(the same names, the same hit counts as the JAX package's matrix), and
``repro_torch.recover`` must rebuild the exact acknowledged prefix — ids,
scores and epoch equal to the JAX package's uninterrupted run at that
prefix.  Torn WAL tails are truncated, never partially replayed.

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
from repro_torch.faults import FaultInjector, InjectedCrash
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
    """(ids, scores, epoch) through the fused path."""
    res = session.query(probe_query(api, mk_lake()), fused=True)
    return (tuple(res.ids), np.asarray(res.scores).copy(),
            int(session.live.store.epoch))


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


def run_script(tmp_path, backend, injector):
    """Connect a port session with a WAL, take a baseline snapshot, then
    run STEPS under ``injector``.  Returns (acked, point, hit)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    session = blend.connect(mk_lake(), live=True, backend=backend,
                            device="cpu", wal=str(tmp_path / "lake.wal"))
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
