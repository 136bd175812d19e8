"""repro_torch's live lake on the CPU, against the JAX package's live session
(its ``sorted`` backend: its ``bucket`` backend does not trace on this
JAX), a from-scratch rebuild of the live tables and tests/oracle.py.

Lakes, added tables and probe specs come from tests/test_livelake.py.  Both
port backends run (``bucket`` through its kernels' plain versions), and
every comparison is exact, on every table slot, after every mutation.
"""
import json

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

import blend as ref_blend
import repro_torch as blend
from repro.core.lake import DataLake, Table
from repro.core.plan import Plan, Seekers
from repro.store import LiveLake as RefLiveLake
from repro_torch.core import executor as executor_mod
from repro_torch.core import seekers as seek
from repro_torch.core.executor import RECENT_CONFIGS
from repro_torch.core.index import validate_row_stride
from repro_torch.store import CompactionPolicy, LiveLake
from repro_torch.store import snapshot as snap
from repro_torch.store.segments import SegmentStore

from oracle import oracle_run, oracle_seeker, oracle_topk
from test_livelake import (SKETCH_FIELDS, all_specs, combiner_plan,
                           extra_table, small_live_lake)

BACKENDS = ("sorted", "bucket")


def _open(lake, backend, **kw):
    return blend.connect(lake, live=True, backend=backend, device="cpu",
                         **kw)


def _vec(t) -> np.ndarray:
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def assert_seekers_equal(ports, ref, probe, msg=""):
    """Each port session's seekers (``all_specs``) equal the JAX live
    session's on every slot."""
    for spec in all_specs(probe, ref.executor.n_tables):
        want = np.asarray(ref.executor.run_seeker(spec).scores)
        for port in ports:
            assert port.index_shape() == ref.index_shape()
            np.testing.assert_array_equal(
                port.executor.run_seeker(spec).scores.numpy(), want,
                err_msg=f"{msg} {spec.kind}")


def assert_live_parity(port, ref, probe, tables_by_tid=None):
    """Every seeker of ``all_specs`` and the four-combiner plan (optimized;
    unfused and fused): the port's scores and masks equal the JAX live
    session's on every slot.  With ``tables_by_tid`` the live slots also
    equal a port rebuild of the live tables and tests/oracle.py (the plan
    unoptimized, as the oracle runs it)."""
    pex, rex = port.executor, ref.executor
    k = rex.n_tables
    assert pex.n_tables == k
    live = port.live.live_ids()
    assert live == ref.live.live_ids()
    rebuilt = rebuilt_ex = None
    if tables_by_tid is not None:
        rebuilt = DataLake([tables_by_tid[t] for t in live])
        rebuilt_ex = blend.connect(rebuilt, backend=pex.backend,
                                   device="cpu").executor
    for spec in all_specs(probe, k):
        a = pex.run_seeker(spec)
        b = rex.run_seeker(spec)
        np.testing.assert_array_equal(_vec(a.scores), _vec(b.scores),
                                      err_msg=spec.kind)
        np.testing.assert_array_equal(_vec(a.mask), _vec(b.mask),
                                      err_msg=spec.kind)
        assert int(pex._last_overflow) == int(rex._last_overflow)
        if rebuilt is not None:
            want = _vec(rebuilt_ex.run_seeker(spec).scores)
            np.testing.assert_array_equal(_vec(a.scores)[live], want,
                                          err_msg=spec.kind)
            osc, _ = oracle_topk(oracle_seeker(rebuilt, spec), spec.k)
            np.testing.assert_array_equal(want, osc, err_msg=spec.kind)
    plan = combiner_plan(probe, k)
    want, _ = rex.run(plan)
    for fused in (False, True):
        got, _ = pex.run(plan, fused=fused)
        np.testing.assert_array_equal(_vec(got.scores), _vec(want.scores))
        np.testing.assert_array_equal(_vec(got.mask), _vec(want.mask))
    if rebuilt is not None:
        got, _ = pex.run(plan, optimize=False)
        osc, omask = oracle_run(rebuilt, plan)
        np.testing.assert_array_equal(_vec(got.scores)[live], osc)
        np.testing.assert_array_equal(_vec(got.mask)[live], omask)


# --------------------------------------------------------------------------
# mutation parity
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_live_parity_add_drop_compact(backend):
    lake = small_live_lake()
    port, ref = _open(lake, backend), ref_blend.connect(lake, live=True)
    tbl = dict(enumerate(lake.tables))
    probe = lake.tables[3]
    assert_live_parity(port, ref, probe, tbl)

    tids = []
    for i in range(3):
        t = extra_table(i)
        tids.append(port.add_table(t))
        assert ref.add_table(t) == tids[-1]
        tbl[tids[-1]] = t
        assert_seekers_equal([port], ref, probe, f"add {i}")
    assert_live_parity(port, ref, probe, tbl)

    for tid in (5, tids[1]):         # a base tombstone, a whole-run delete
        assert port.drop_table(tid) == ref.drop_table(tid)
        del tbl[tid]
        assert_live_parity(port, ref, probe, tbl)

    port.compact()
    ref.compact()
    assert port.index_shape() == ref.index_shape()
    assert port.index_shape()["segments"] == 1
    assert_live_parity(port, ref, probe, tbl)

    t = extra_table(9, rows=12)
    tid = port.add_table(t)
    assert ref.add_table(t) == tid
    tbl[tid] = t
    assert_live_parity(port, ref, probe, tbl)


@settings(max_examples=4, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(st.lists(st.tuples(st.sampled_from(["add", "drop", "compact"]),
                          st.integers(0, 10 ** 6)),
                min_size=1, max_size=5))
def test_live_parity_hypothesis_random_sequences(ops):
    """Any add/drop/compact sequence: both port backends' seekers equal
    the JAX live session's after every step; at the end so do the plan,
    the rebuild and the oracle."""
    lake = small_live_lake(seed=11, n_tables=10)
    ref = ref_blend.connect(lake, live=True)
    ports = [_open(lake, b) for b in BACKENDS]
    tbl = dict(enumerate(lake.tables))
    for i, (op, arg) in enumerate(ops):
        sessions = ports + [ref]
        if op == "add":
            t = extra_table(arg % 50, rows=6 + arg % 9)
            tids = {s.add_table(t, name=f"h{i}_{arg}") for s in sessions}
            assert len(tids) == 1
            tbl[tids.pop()] = t
        elif op == "drop" and len(tbl) > 4:
            tid = sorted(tbl)[arg % len(tbl)]
            for s in sessions:
                s.drop_table(tid)
            del tbl[tid]
        elif op == "compact":
            for s in sessions:
                s.compact(full=arg % 2 == 0)
        assert_seekers_equal(ports, ref, lake.tables[2], op)
    for port in ports:
        assert_live_parity(port, ref, lake.tables[2], tbl)


@pytest.mark.parametrize("backend", BACKENDS)
def test_reclaim_ids_remaps_like_reference(backend):
    lake = small_live_lake(seed=13)
    port, ref = _open(lake, backend), ref_blend.connect(lake, live=True)
    tbl = dict(enumerate(lake.tables))
    for tid in (1, 7, 9):
        port.drop_table(tid)
        ref.drop_table(tid)
        del tbl[tid]
    vals = list(lake.tables[3].columns[0][:8])
    names = port.live.store.table_names
    before = {names[t] for t in port.query(blend.sc(vals, k=30)).ids}
    remap = port.compact(reclaim_ids=True)
    assert remap == ref.compact(reclaim_ids=True)
    assert sorted(remap.values()) == list(range(len(tbl)))
    names = port.live.store.table_names
    assert before == {names[t] for t in port.query(blend.sc(vals, k=30)).ids}
    assert_live_parity(port, ref, lake.tables[3],
                       {remap[t]: tab for t, tab in tbl.items()})


# --------------------------------------------------------------------------
# LSM mechanics, against the JAX package's store
# --------------------------------------------------------------------------

def _layout(store):
    return [(s.n_real, s.n_padded, s.n_num, s.tables) for s in store.segments]


def test_add_is_delta_drop_is_tombstone_or_run_delete():
    lake = small_live_lake()
    ll, rl = LiveLake(lake, auto_compact=False), \
        RefLiveLake(lake, auto_compact=False)
    base = ll.store.segments[0]
    tid = ll.add_table(extra_table(0))
    rl.add_table(extra_table(0))
    assert ll.store.segments[0] is base          # base untouched
    assert len(ll.store.segments) == 2
    ll.drop_table(tid)                           # sole table of its run
    rl.drop_table(tid)
    assert len(ll.store.segments) == 1
    assert not ll.store.pending_dead
    assert tid in ll.store.free_ids              # slot immediately reusable
    ll.drop_table(2)                             # lives inside the base
    rl.drop_table(2)
    assert len(ll.store.segments) == 1
    assert 2 in ll.store.pending_dead
    assert ll.shape() == rl.shape()
    assert ll.shape()["tombstoned"] == [lake.tables[2].name]
    assert _layout(ll.store) == _layout(rl.store)


def test_auto_compact_bounds_segment_count():
    lake = small_live_lake(n_tables=8)
    policy = CompactionPolicy(max_segments=4, tier_fanout=2)
    ll = LiveLake(lake, policy=policy)
    from repro.store import CompactionPolicy as RefPolicy
    rl = RefLiveLake(lake, policy=RefPolicy(max_segments=4, tier_fanout=2))
    for i in range(12):
        ll.add_table(extra_table(i))
        rl.add_table(extra_table(i))
        assert _layout(ll.store) == _layout(rl.store)
    assert len(ll.store.segments) <= policy.max_segments
    owners = [s for i in range(ll.store.n_slots) if ll.store.alive[i]
              for s in ll.store.segments if i in s.tables]
    assert len(owners) == int(ll.store.alive.sum())


@pytest.mark.parametrize("backend", BACKENDS)
def test_id_reuse_never_resurrects_postings(backend):
    lake = small_live_lake(seed=21)
    session = _open(lake, backend)
    ghost = Table("ghost", [["spectral_token"] * 6,
                            [float(i) for i in range(6)]])
    tid = session.add_table(ghost)
    for fused in (False, True):
        assert session.query(blend.kw(["spectral_token"], k=5),
                             fused=fused).ids == [tid]
    session.drop_table(tid)
    reborn = Table("reborn", [["solid_token"] * 6,
                              [float(i) for i in range(6)]])
    tid2 = session.add_table(reborn)
    assert tid2 == tid                            # slot reused
    for fused in (False, True):
        assert session.query(blend.kw(["spectral_token"], k=5),
                             fused=fused).ids == []
        assert session.query(blend.kw(["solid_token"], k=5),
                             fused=fused).ids == [tid2]


def test_plan_pins_epoch_against_midplan_mutation():
    """A mutation landing while a plan executes is not observed until the
    next plan: every seeker of one request sees one epoch."""
    lake = small_live_lake()
    session = _open(lake, "sorted")
    ex = session.executor
    session.query(blend.kw(["tok_1"], k=5))
    engine = ex.engine
    ex._in_plan = True            # emulate: plan in flight, epoch pinned
    try:
        session.add_table(extra_table(0))
        rs = ex.run_seeker(Seekers.KW(["tok_1"], k=5))
        assert ex.engine is engine                     # old epoch served
        assert len(rs.scores) == ex.n_tables
    finally:
        ex._in_plan = False
    session.query(blend.kw(["tok_1"], k=5))
    assert ex.engine is not engine                     # next plan refreshes


def test_epoch_bumps_and_lazy_refresh():
    lake = small_live_lake()
    session = _open(lake, "bucket")
    ex = session.executor
    e0 = session.live.epoch
    engine0 = ex.engine
    tid = session.add_table(extra_table(0))
    assert session.live.epoch > e0
    assert ex.engine is engine0       # refresh is lazy ...
    session.query(blend.kw(["tok_1"], k=5))
    assert ex.engine is not engine0   # ... and happens at query entry
    assert ex._engine_epoch == session.live.epoch
    session.drop_table(tid)


# --------------------------------------------------------------------------
# programs and the arena
# --------------------------------------------------------------------------

def _fused_query(t3):
    return (blend.sc(list(t3.columns[0][:8]), k=20)
            & blend.mc([(t3.columns[0][r], t3.columns[1][r])
                        for r in range(5)], k=20)).top(10)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mutation_within_seen_geometry_builds_no_program(backend):
    """The reference's zero-retrace contract on the fused path: once a
    geometry (EngineConfig) has its programs, a mutation back into it
    builds none, and the answers follow the mutation."""
    lake = small_live_lake(seed=31)
    session = _open(lake, backend)
    ref = ref_blend.connect(lake, live=True)
    q = _fused_query(lake.tables[3])
    ref_q = (ref_blend.sc(list(lake.tables[3].columns[0][:8]), k=20)
             & ref_blend.mc([(lake.tables[3].columns[0][r],
                              lake.tables[3].columns[1][r])
                             for r in range(5)], k=20)).top(10)

    def same():
        got = session.query(q, fused=True)
        want = ref.query(ref_q, fused=True)
        assert got.ids == want.ids
        np.testing.assert_array_equal(got.scores.numpy(),
                                      np.asarray(want.scores))

    same()
    for s in (session, ref):                 # warm the mutated topology
        s.add_table(extra_table(0))
    same()
    for s in (session, ref):
        s.drop_table(lake.n_tables)
    same()
    before = dict(seek.TRACE_COUNTS)
    for i in (1, 2):         # same counts, same padded rung: seen geometry
        for s in (session, ref):
            s.add_table(extra_table(i))
        same()
        for s in (session, ref):
            s.drop_table(3 + i)              # tombstones: same geometry
        same()
        for s in (session, ref):
            s.drop_table(lake.n_tables)
        same()
    assert dict(seek.TRACE_COUNTS) == before


def _engine_configs(ex) -> set:
    """The (arena generation, EngineConfig) pairs the executor's cached
    programs that read the engine were built for."""
    return {key[1:3] for key, *_ in ex.programs._programs
            if key[0] == "engine"}


@pytest.mark.parametrize("bound", [5, RECENT_CONFIGS])
@pytest.mark.parametrize("backend", BACKENDS)
def test_new_geometries_keep_a_bounded_program_cache(backend, bound,
                                                     monkeypatch):
    """Each add of a table of a new size is a geometry not seen before and
    builds its programs, but only the last ``bound`` configs of the arena
    generation keep theirs, so a long mutation stream holds a bounded
    cache.  A geometry still among them builds nothing when it returns; an
    evicted one builds again.  The fused answers equal the unfused walk
    after every step."""
    monkeypatch.setattr(executor_mod, "RECENT_CONFIGS", bound)
    lake = small_live_lake(seed=37)
    session = _open(lake, backend)
    ex = session.executor
    q = _fused_query(lake.tables[3])

    def same():
        got, want = session.query(q, fused=True), session.query(q)
        assert got.ids == want.ids
        assert torch.equal(got.scores, want.scores)

    same()
    seen = []
    for i in range(bound + 2):
        tid = session.add_table(extra_table(i, rows=10 + i))
        same()
        seen.append((ex.arena.generation, ex.engine.config))
        assert seen[-1] in _engine_configs(ex)
        assert len(_engine_configs(ex)) <= bound
        session.drop_table(tid)            # a whole-run delete: the base
        same()
        assert len(_engine_configs(ex)) <= bound
    assert seen[0] not in _engine_configs(ex)
    last = bound + 1
    before = sum(seek.TRACE_COUNTS.values())
    tid = session.add_table(extra_table(last, rows=10 + last))
    same()
    assert (ex.arena.generation, ex.engine.config) == seen[-1]
    assert sum(seek.TRACE_COUNTS.values()) == before   # still cached
    session.drop_table(tid)
    session.add_table(extra_table(0, rows=10))
    same()
    assert sum(seek.TRACE_COUNTS.values()) > before    # evicted: rebuilt


@pytest.mark.parametrize("backend", BACKENDS)
def test_first_of_five_new_geometries_returns_without_a_build(backend):
    """A live session visits five new geometries in turn, each followed by
    the base, then returns to the first: that return builds no program
    (the reference's jit cache never recompiles a config it has seen), and
    every fused answer equals the unfused walk."""
    assert RECENT_CONFIGS >= 5 + 1           # five new configs + the base
    lake = small_live_lake(seed=39)
    session = _open(lake, backend)
    ex = session.executor
    q = _fused_query(lake.tables[3])

    def same():
        got, want = session.query(q, fused=True), session.query(q)
        assert got.ids == want.ids
        assert torch.equal(got.scores, want.scores)

    same()
    seen = []
    for i in range(5):
        tid = session.add_table(extra_table(i, rows=10 + i))
        same()
        seen.append((ex.arena.generation, ex.engine.config))
        session.drop_table(tid)
        same()
    assert len(set(seen)) == 5
    before = sum(seek.TRACE_COUNTS.values())
    session.add_table(extra_table(0, rows=10))
    same()
    assert (ex.arena.generation, ex.engine.config) == seen[0]
    assert sum(seek.TRACE_COUNTS.values()) == before


def test_arena_refill_copies_only_what_changed():
    lake = small_live_lake(seed=33)
    session = _open(lake, "bucket")
    ex = session.executor
    arena = ex.arena
    q = blend.kw(["tok_1"], k=5)
    assert arena.copied_bytes > 0 and arena.generation == 1
    tid = session.add_table(extra_table(0))      # grows the arena
    session.query(q)
    gen = arena.generation
    session.drop_table(4)                        # tombstone: alive only
    session.query(q)
    assert arena.copied_bytes == 0
    session.drop_table(tid)                      # whole-run delete
    session.query(q)
    assert arena.copied_bytes == 0               # the base stays in place
    session.add_table(extra_table(1))            # a delta where one was
    session.query(q)
    seg = session.live.store.segments[-1]
    delta = sum(t.numel() * t.element_size()
                for t in seg.device_arrays(ex.device).values())
    tables = sum(t.numel() * t.element_size() for t in seg.device_buckets(
        ex.engine.config.bucket_widths[-1],
        ex.engine.config.seg_bounds[-1][0], ex.device))
    assert arena.copied_bytes == delta + tables
    assert arena.generation == gen
    for k, view in ex.engine.dev.items():
        assert view.data_ptr() == arena._buf[k].data_ptr()


def test_arena_growth_drops_the_old_generation_programs():
    lake = small_live_lake(seed=35)
    session = _open(lake, "sorted")
    ref = ref_blend.connect(lake, live=True)
    ex = session.executor
    q = blend.kw(["tok_1", "tok_2"], k=8)
    session.query(q, fused=True)
    gen = ex.arena.generation
    keys = [k for k in ex.programs._programs if k[0][0] == "engine"]
    assert keys and all(k[0][1] == gen for k in keys)
    big = extra_table(1, rows=2000)              # past the arena's rung
    session.add_table(big)
    ref.add_table(big)
    got = session.query(q, fused=True)
    assert ex.arena.generation == gen + 1
    assert all(k[0][1] == gen + 1 for k in ex.programs._programs
               if k[0][0] == "engine")
    want = ref.query(ref_blend.kw(["tok_1", "tok_2"], k=8), fused=True)
    assert got.ids == want.ids
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))


# --------------------------------------------------------------------------
# rowkey stride guards
# --------------------------------------------------------------------------

def test_row_stride_validation_guards():
    with pytest.raises(ValueError, match="alias"):
        validate_row_stride(10, 1 << 4, max_rows=100)
    with pytest.raises(ValueError, match="shard the lake"):
        validate_row_stride(2 ** 10, 1 << 22)
    validate_row_stride(100, 1 << 7, max_rows=100)


@pytest.mark.parametrize("backend", BACKENDS)
def test_live_add_long_table_widens_stride_with_parity(backend):
    lake = small_live_lake(seed=41)
    port, ref = _open(lake, backend), ref_blend.connect(lake, live=True)
    stride0 = port.live.store.row_stride
    long = extra_table(3, rows=4 * stride0)
    tbl = dict(enumerate(lake.tables))
    tid = port.add_table(long)
    ref.add_table(long)
    tbl[tid] = long
    assert port.live.store.row_stride == ref.live.store.row_stride \
        >= 4 * stride0
    assert_live_parity(port, ref, lake.tables[2], tbl)
    assert port.executor.engine.config.row_stride == \
        port.live.store.row_stride


def test_live_stride_overflow_raises():
    lake = small_live_lake()
    ll = LiveLake(lake)

    class HugeTable:            # geometry-only stand-in: rejected pre-build
        name = "huge"
        n_rows = (1 << 26) + 1
        n_cols = 2
        columns = []

    with pytest.raises(ValueError, match="shard the lake"):
        ll.add_table(HugeTable())
    assert ll.store.n_slots == lake.n_tables      # nothing was allocated


def test_alloc_growth_validation_leaves_store_intact():
    lake = small_live_lake(n_tables=8)           # slot capacity 16
    ll = LiveLake(lake, auto_compact=False)
    ll.store.row_stride = 1 << 26                # growth to 32 would overflow
    for i in range(8):
        ll.add_table(extra_table(i))
    with pytest.raises(ValueError, match="shard the lake"):
        ll.add_table(extra_table(99))
    assert ll.store.n_slots == len(ll.store.alive) == 16
    assert ll.store.live_ids() == list(range(16))


# --------------------------------------------------------------------------
# snapshots
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_snapshot_roundtrip_parity(tmp_path, backend):
    lake = small_live_lake(seed=51)
    port, ref = _open(lake, backend), ref_blend.connect(lake, live=True)
    t = extra_table(2)
    for s in (port, ref):
        s.add_table(t)
        s.drop_table(4)
    man = port.snapshot(tmp_path / "lake")
    assert man.exists() and (tmp_path / "lake.npz").exists()
    ref.snapshot(tmp_path / "ref")
    restored = blend.restore(tmp_path / "lake", backend=backend,
                             device="cpu")
    # the snapshot formats are one: each system loads the other's
    ref_restored = ref_blend.restore(tmp_path / "lake")
    port_of_ref = blend.restore(tmp_path / "ref", backend=backend,
                                device="cpu")
    assert json.loads((tmp_path / "lake.json").read_text())["epoch"] == \
        port.live.epoch
    for other in (restored, port_of_ref):
        assert other.live.live_ids() == ref_restored.live.live_ids()
        assert_live_parity(other, ref_restored, lake.tables[3])
    t2 = extra_table(7)                          # restored lakes stay mutable
    tid = restored.add_table(t2)
    assert tid == ref_restored.add_table(t2)
    assert_live_parity(restored, ref_restored, lake.tables[3])


def test_snapshot_preserves_with_quadrants(tmp_path):
    lake = small_live_lake()
    ll = LiveLake(store=SegmentStore(lake, with_quadrants=False))
    ll.snapshot(tmp_path / "nq")
    restored = snap.load(tmp_path / "nq")
    assert restored.with_quadrants is False
    assert (restored.segments[0].quadrant == -1).all()


def test_snapshot_version_check(tmp_path):
    lake = small_live_lake()
    ll = LiveLake(lake)
    ll.snapshot(tmp_path / "s")
    manifest = tmp_path / "s.json"
    bad = json.loads(manifest.read_text())
    bad["version"] = 99
    manifest.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="version"):
        snap.load(tmp_path / "s")


# --------------------------------------------------------------------------
# observability, statistics and sketches
# --------------------------------------------------------------------------

def test_explain_reports_index_shape():
    lake = small_live_lake()
    port, ref = _open(lake, "bucket"), ref_blend.connect(lake, live=True)
    for s in (port, ref):
        s.add_table(extra_table(0))
        s.drop_table(1)
    ex = port.explain(blend.kw(["tok_1"], k=5))
    ref_ex = ref.explain(ref_blend.kw(["tok_1"], k=5))
    assert ex.index_shape == ref_ex.index_shape
    s = ex.index_shape
    assert s["mode"] == "live" and s["segments"] == 2
    assert s["epoch"] == port.live.epoch
    assert s["tombstoned"] == [lake.tables[1].name]
    text, ref_text = str(ex), str(ref_ex)
    section = text[text.index("== index =="):text.index("== physical")]
    assert section == ref_text[ref_text.index("== index =="):
                               ref_text.index("== physical")]
    assert "segments: 2" in section and "tombstoned" in section
    static = blend.connect(lake, device="cpu").explain(
        blend.kw(["tok_1"], k=5), execute=False).index_shape
    assert static["mode"] == "static" and static["segments"] == 1


def test_host_counts_live_only_excludes_tombstones():
    from repro_torch.core.hashing import hash_array
    lake = small_live_lake()
    ll, rl = LiveLake(lake), RefLiveLake(lake)
    vals = list(lake.tables[2].columns[0][:6])
    h = np.unique(hash_array(vals))
    full = ll.store.host_counts(h)
    for x in (ll, rl):
        x.add_table(extra_table(0))
        x.drop_table(2)
    for live_only in (False, True):
        np.testing.assert_array_equal(
            ll.store.host_counts(h, live_only=live_only),
            rl.store.host_counts(h, live_only=live_only))
    assert (ll.store.host_counts(h) >= full).all()       # slots still held
    assert ll.store.host_counts(h, live_only=True).sum() < full.sum()


def _assert_sketches_equal(got, want, msg=""):
    assert set(got) == set(want), msg
    for t in got:
        assert got[t].tbl_m == want[t].tbl_m, (msg, t)
        assert (got[t].n_rows, got[t].n_cols) == \
            (want[t].n_rows, want[t].n_cols), (msg, t)
        for f in SKETCH_FIELDS:
            np.testing.assert_array_equal(
                getattr(got[t], f), getattr(want[t], f),
                err_msg=f"{msg} table {t} field {f}")


def test_segment_sketches_bit_identical_through_mutations_and_snapshot(
        tmp_path):
    lake = small_live_lake(seed=61)
    ll, rl = LiveLake(lake), RefLiveLake(lake)
    _assert_sketches_equal(ll.store.sketch_map(), rl.store.sketch_map(),
                           "build")
    for i in range(3):
        ll.add_table(extra_table(i))
        rl.add_table(extra_table(i))
    ll.drop_table(5)
    rl.drop_table(5)
    _assert_sketches_equal(ll.store.sketch_map(), rl.store.sketch_map(),
                           "mutations")
    before = dict(ll.store.sketch_map())
    ll.compact()
    _assert_sketches_equal(ll.store.sketch_map(), before, "compact")
    ll.snapshot(tmp_path / "sk")
    restored = snap.load(tmp_path / "sk")
    assert restored.sketch_config == ll.store.sketch_config
    _assert_sketches_equal(restored.sketch_map(), before, "restore")
