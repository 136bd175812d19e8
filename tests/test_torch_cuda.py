"""repro_torch's CUDA kernels on the card, against their plain versions.

Every kernel test takes the ``cuda`` fixture, which skips without a card;
the default-device test runs everywhere.  The fused path's tests check
that a CUDA-graph replay equals an eager call, leaves earlier results as
they were, captures nothing when warm, and ticks the launch counters.  The
live lake's tests check that a program captured before a mutation within
the same geometry answers the mutated lake (the arena is refilled in
place), that live ``bucket`` equals live ``sorted`` and the CPU port
through add, drop, compact and ``reclaim_ids``, that an arena growth drops
the old generation's programs and still answers, that a stream of new
geometries holds the device memory flat once the program cache is full,
and that ``recover`` on the card equals the session it replaces.
This file imports no JAX, so it runs on the H100 machine as it is:
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import repro_torch as blend
from repro_torch.core import seekers as seek
from repro_torch.core.executor import RECENT_CONFIGS, Executor
from repro_torch.core.hashing import MISSING
from repro_torch.core.index import build_index, hash_keys
from repro_torch.core.lake import Table, synthetic_lake
from repro_torch.core.match import MatchEngine
from repro_torch.core.plan import Combiners, Plan, Seekers
from repro_torch.core.programs import Programs
from repro_torch.kernels import _build
from repro_torch.kernels.bucket_probe import ops as bucket_ops
from repro_torch.kernels.bucket_probe.ref import bucket_probe_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.qcr_score import ops as qcr_ops
from repro_torch.kernels.qcr_score.ref import qcr_score_ref, qcr_segments_ref
from repro_torch.kernels.superkey_filter import ops as sk_ops
from repro_torch.kernels.superkey_filter.ref import (superkey_filter_ref,
                                                     superkey_filter_rows_ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def test_bucket_probe_kernel_on_card(cuda):
    idx = build_index(synthetic_lake(n_tables=20, rows=16, vocab=120, seed=1),
                      bucket_bits=9)
    for width in (idx.max_bucket_count(), 64):   # unaligned and int4 rows
        bh, bp, _ = idx.padded_buckets(width)
        args = (_t(hash_keys(bh), cuda), _t(bp, cuda))
        rng = np.random.default_rng(width)
        q = np.concatenate([rng.choice(idx.cell_hash, 40),
                            rng.integers(0, 2 ** 32, 20, dtype=np.uint32),
                            np.full(5, MISSING, np.uint32)])
        for m in (1, 31, len(q)):                    # ragged query counts
            kq = _t(hash_keys(q[-m:]), cuda)
            before = bucket_ops.probe.launches
            got = bucket_ops.probe(*args, kq, 9)
            torch.cuda.synchronize()
            assert bucket_ops.probe.launches == before + 1
            assert torch.equal(got, bucket_probe_ref(*args, kq, 9))


def _digests(rng, shape, cut, device):
    """Random int32 digests of ``shape`` on the card, as a contiguous view
    ``cut`` elements into its storage (not 16-byte aligned for cut 1..3)."""
    flat = rng.integers(0, 2 ** 32, int(np.prod(shape)) + cut,
                        dtype=np.uint32)
    return _t(flat.view(np.int32), device)[cut:].view(shape)


def _queries(rng, lo, hi, t, device):
    """[T] query digests (lo, hi), each the bits of one row digest with some
    cleared, so that every query holds for at least that row; for [T, M]
    rows query t takes its row from row t."""
    lo_np, hi_np = (a.cpu().numpy().reshape(-1).view(np.uint32)
                    for a in (lo, hi))
    if lo.dim() == 2:
        pick = np.arange(t) * lo.shape[1] + rng.integers(0, lo.shape[1], t)
    else:
        pick = rng.integers(0, lo.numel(), t)
    return tuple(_t((a[pick] & rng.integers(0, 2 ** 32, t, dtype=np.uint32))
                    .view(np.int32), device) for a in (lo_np, hi_np))


# (T, M, cut): M = 1..15 (mod 16), rows that cross the 16-element groups,
# tiny and wide windows (m_cap_max = 1024), digests off 16-byte alignment
CARD_ROWS_CASES = [(5, 33, 0), (24, 128, 0), (256, 1024, 0), (256, 128, 0),
                   (1, 1, 0), (3, 7, 0), (9, 15, 0), (2, 16, 0), (4, 17, 0),
                   (256, 1024, 1), (31, 77, 3), (256, 1009, 1)] + \
    [(3 + r, 64 + r, 0) for r in range(1, 16)]


def test_superkey_kernel_on_card(cuda):
    rng = np.random.default_rng(0)
    for t, m, cut in CARD_ROWS_CASES:
        sk_lo, sk_hi = (_digests(rng, (t, m), cut, cuda) for _ in range(2))
        q_lo, q_hi = _queries(rng, sk_lo, sk_hi, t, cuda)
        assert sk_lo.is_contiguous() and sk_lo.data_ptr() % 16 == 4 * cut
        before = sk_ops.filter_candidates.launches
        got = sk_ops.filter_candidates(sk_lo, sk_hi, q_lo, q_hi)
        torch.cuda.synchronize()
        assert sk_ops.filter_candidates.launches == before + 1
        assert got.is_contiguous() and got.stride() == (m, 1)
        assert torch.equal(got, superkey_filter_rows_ref(sk_lo, sk_hi, q_lo,
                                                         q_hi)), (t, m, cut)
        assert got.any(dim=1).all()


def test_qcr_kernel_on_card(cuda):
    rng = np.random.default_rng(1)
    for d in (1, 1000, 1 << 20):
        n_all = rng.integers(0, 12, d).astype(np.float32)
        n_agree = np.minimum(rng.integers(0, 12, d), n_all).astype(np.float32)
        a, n = _t(n_agree, cuda), _t(n_all, cuda)
        got = qcr_ops.score_segments(a, n)
        torch.cuda.synchronize()
        assert torch.equal(got, qcr_segments_ref(a, n))


def test_bucket_session_on_card_matches_cpu(cuda):
    lake = synthetic_lake(n_tables=40, rows=20, cols=4, vocab=300, seed=8)
    t0 = lake.tables[2]
    expr = ((blend.mc([(t0.columns[0][r], t0.columns[1][r])
                       for r in range(5)], k=40)
             & blend.sc(list(t0.columns[0][:8]), k=40))
            | blend.corr(t0.columns[0], list(range(t0.n_rows)), k=40))
    card = blend.connect(lake, backend="bucket")
    cpu = Executor(card.index, backend="bucket", device="cpu")
    counts = [f.launches for f in (bucket_ops.probe, sk_ops.filter_candidates,
                                   qcr_ops.score_segments)]
    got = card.query(expr)
    want, _ = cpu.run(card.compile(expr).plan)
    assert got.ids == [int(i) for i in want.ids()]
    assert torch.equal(got.scores.cpu(), want.scores)
    after = [f.launches for f in (bucket_ops.probe, sk_ops.filter_candidates,
                                  qcr_ops.score_segments)]
    assert all(b > a for a, b in zip(counts, after))


# (T, N, cut): N = 1..15 (mod 16) across several 480-row warp tiles, N
# below one tile and below one 16-byte chunk, T = 1 and T not a multiple
# of anything the kernel tiles by, digests cut at [1:] and [3:]
CARD_FILTER_CASES = [(5, 1000, 0), (1, 1, 0), (33, 4099, 0), (3, 2048, 0),
                     (40, 5000, 1), (40, 5000, 3), (7, 1001, 1), (7, 1001, 3),
                     (5, 100, 0), (9, 495, 0), (2, 496, 0), (4, 497, 0),
                     (17, 1, 0), (33, 5, 0), (40, 15, 0), (5, 16, 0),
                     (6, 17, 0), (1, 958, 0), (1, 5000, 3), (257, 777, 0),
                     (256, 20_001, 0)] + \
    [(7 + r, 1024 + r, 0) for r in range(1, 16)]


def test_filter_rows_kernel_on_card(cuda):
    rng = np.random.default_rng(2)
    for t, n, cut in CARD_FILTER_CASES:
        lo, hi = (_digests(rng, (n,), cut, cuda) for _ in range(2))
        ql, qh = _queries(rng, lo, hi, t, cuda)
        assert lo.is_contiguous() and lo.data_ptr() % 16 == 4 * cut
        before = sk_ops.filter_rows.launches
        got = sk_ops.filter_rows(lo, hi, ql, qh)
        torch.cuda.synchronize()
        assert sk_ops.filter_rows.launches == before + 1
        assert got.dtype == torch.bool and got.shape == (t, n)
        assert got.is_contiguous() and got.stride() == (n, 1)
        assert torch.equal(got, superkey_filter_ref(lo, hi, ql, qh)), \
            (t, n, cut)
        assert got.any(dim=1).all()


def test_filter_rows_kernel_at_unaligned_output(cuda):
    """The kernel itself at an output 1..15 bytes off a 16-byte boundary
    (the wrapper always hands it a fresh aligned tensor): the array's head
    and tail and every row seam are assembled byte by byte."""
    rng = np.random.default_rng(4)
    for t, n in ((33, 4099), (5, 7), (3, 1000), (1, 20)):
        lo, hi = (_digests(rng, (n,), 0, cuda) for _ in range(2))
        ql, qh = _queries(rng, lo, hi, t, cuda)
        want = superkey_filter_ref(lo, hi, ql, qh)
        for off in (1, 7, 15):
            buf = torch.zeros(t * n + 32, dtype=torch.uint8, device=cuda)
            _build.launch("superkey_filter", buf.device, lo.data_ptr(),
                          hi.data_ptr(), ql.data_ptr(), qh.data_ptr(),
                          buf.data_ptr() + off, t, n)
            torch.cuda.synchronize()
            got = buf[off:off + t * n].view(t, n).bool()
            assert torch.equal(got, want), (t, n, off)
            assert not buf[:off].any() and not buf[off + t * n:].any()


def test_qcr_score_kernel_on_card(cuda):
    rng = np.random.default_rng(3)
    for g, h in ((1000, 256), (7, 33), (1, 1), (300, 48), (5, 1024)):
        quad = _t(rng.integers(0, 2, (g, h)).astype(np.int8), cuda)
        qbit = _t(rng.integers(-1, 2, (g, h)).astype(np.int8), cuda)
        valid = _t(rng.random((g, h)) < 0.6, cuda)
        before = qcr_ops.score.launches
        got = qcr_ops.score(quad, qbit, valid)
        torch.cuda.synchronize()
        assert qcr_ops.score.launches == before + 1
        assert torch.equal(got, qcr_score_ref(quad, qbit, valid))
    ones = torch.ones((4, 64), dtype=torch.int8, device=cuda)
    assert torch.equal(qcr_ops.score(ones, ones, ones.bool()),
                       torch.ones(4, device=cuda))


# (dtype, causal, B, Sq, Skv, H, K, D): G in {1, 2, 3, 8}, ragged tiles,
# Sq < Skv, Sq > Skv (fully masked rows), Sq = 1; the bf16 cases cross the
# bf16 kernel's 128-query and 128-key tile edges at both head dims, the f32
# cases the f32 kernel's 128-query and 64-key tile edges
CARD_ATTENTION_CASES = [
    (torch.float32, True, 2, 100, 100, 4, 2, 64),
    (torch.float32, False, 1, 70, 130, 3, 1, 128),
    (torch.float32, True, 1, 1, 777, 4, 4, 128),
    (torch.bfloat16, True, 1, 200, 77, 6, 2, 64),
    (torch.bfloat16, True, 1, 65, 300, 6, 3, 128),
    (torch.bfloat16, False, 2, 33, 64, 2, 2, 64),
    (torch.bfloat16, True, 1, 300, 300, 32, 4, 128),
    (torch.bfloat16, True, 1, 1000, 1000, 15, 5, 64),
    (torch.bfloat16, True, 1, 300, 200, 8, 1, 128),
    (torch.bfloat16, True, 1, 1, 777, 4, 4, 64),
    (torch.bfloat16, False, 2, 70, 130, 6, 3, 128),
    (torch.float32, True, 1, 300, 300, 32, 4, 128),
    (torch.float32, True, 1, 1000, 1000, 15, 5, 64),
    (torch.float32, True, 1, 300, 200, 8, 1, 128),
    (torch.float32, True, 1, 200, 77, 6, 2, 64),
    (torch.float32, True, 1, 65, 300, 6, 3, 128),
    (torch.float32, True, 2, 129, 129, 4, 1, 64),
    (torch.float32, True, 1, 1, 777, 4, 4, 64),
    (torch.float32, False, 2, 70, 130, 6, 3, 128),
    (torch.float32, False, 1, 33, 64, 8, 1, 64),
]


@pytest.mark.parametrize("dtype,causal,b,sq,skv,h,k,d", CARD_ATTENTION_CASES)
def test_attention_kernel_on_card(cuda, dtype, causal, b, sq, skv, h, k, d):
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    gen = torch.Generator(device=cuda).manual_seed(sq * skv + d)
    q, kk, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
                for shape in ((b, sq, h, d), (b, skv, k, d), (b, skv, k, d)))
    before = fa_ops.attention.launches
    got = fa_ops.attention(q, kk, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_ref(q, kk, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


def _rejects_unaligned(dtype, device):
    # a contiguous view one element into its storage: TMA cannot read it
    b, s, h, d = 1, 8, 2, 64
    buf = torch.zeros(b * s * h * d + 1, dtype=dtype, device=device)
    q = buf[1:].view(b, s, h, d)
    kv = torch.zeros((b, s, h, d), dtype=dtype, device=device)
    assert q.is_contiguous() and q.data_ptr() % 16 == buf.element_size()
    before = fa_ops.attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.attention(q, kv, kv)
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.attention(kv, q, kv)
    assert fa_ops.attention.launches == before


def test_attention_rejects_unaligned_bf16(cuda):
    _rejects_unaligned(torch.bfloat16, cuda)


def test_attention_rejects_unaligned_f32(cuda):
    _rejects_unaligned(torch.float32, cuda)


def test_match_engine_defaults_to_the_card():
    idx = build_index(synthetic_lake(n_tables=6, rows=8, vocab=40, seed=2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MatchEngine.from_index(idx)
        return
    eng = MatchEngine.from_index(idx, backend="bucket")
    assert eng.bucket_hashes[0].is_cuda
    assert all(t.is_cuda for t in eng.dev.values() if torch.is_tensor(t))


# --------------------------------------------------------- the fused path

def _fused_plan(lake, tab):
    """All four seeker kinds, MC at two widths, under every combiner kind;
    the same shapes for every ``tab``."""
    t = lake.tables[tab]
    p = Plan()
    p.add("sc", Seekers.SC(list(t.columns[0][:6]), k=12))
    p.add("kw", Seekers.KW([t.columns[1][0], t.columns[1][1]], k=12))
    p.add("mc", Seekers.MC([(t.columns[0][r], t.columns[1][r])
                            for r in range(4)], k=12))
    p.add("mc3", Seekers.MC([(t.columns[0][r], t.columns[1][r],
                              t.columns[2][r]) for r in range(3)], k=12))
    p.add("c", Seekers.Correlation(list(t.columns[0][:6]),
                                   [float(i) for i in range(6)], k=12, h=64))
    p.add("and", Combiners.Intersect(k=16), ["sc", "kw", "mc"])
    p.add("or", Combiners.Union(k=16), ["sc", "c", "mc3"])
    p.add("cnt", Combiners.Counter(k=16), ["and", "or"])
    p.add("root", Combiners.Difference(k=8), ["cnt", "kw"])
    return p


@pytest.fixture
def fused_lake(cuda):
    lake = synthetic_lake(n_tables=30, rows=16, cols=4, vocab=300, seed=11)
    return lake, build_index(lake)


QUERY_WRAPPERS = (bucket_ops.probe, sk_ops.filter_candidates,
                  qcr_ops.score_segments)


def test_fused_programs_replay_equal_eager_on_card(fused_lake, monkeypatch):
    """Each seeker group's program and the DAG program, captured and then
    replayed, equal an eager call of the same function on the same
    operands on the card; the fused results equal the unfused walk on the
    card (both backends) and the fused path on the CPU."""
    lake, idx = fused_lake
    checked = []
    run = Programs.run

    def run_and_check(self, key, kind, fn, host=(), dev=()):
        eager = fn(*[torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in host], *[t.clone() for t in dev])
        out = run(self, key, kind, fn, host, dev)
        torch.cuda.synchronize()
        assert len(out) == len(eager)
        assert all(torch.equal(o, e) for o, e in zip(out, eager)), kind
        checked.append(kind)
        return out

    monkeypatch.setattr(Programs, "run", run_and_check)
    cards = {b: Executor(idx, backend=b) for b in ("bucket", "sorted")}
    cpu = Executor(idx, backend="bucket", device="cpu")
    for tab in (2, 5):               # capture, then replay the same keys
        plan = _fused_plan(lake, tab)
        want, want_info = cpu.run(plan, fused=True)
        for ex in cards.values():
            got, info = ex.run(plan, fused=True)
            walk, walk_info = ex.run(plan)
            for rs in (got, walk):
                assert torch.equal(rs.scores.cpu(), want.scores)
                assert torch.equal(rs.mask.cpu(), want.mask)
            assert info.overflow == walk_info.overflow == want_info.overflow
            assert info.launches == 5 + 1       # SC KW MC/2 MC/3 C + DAG
    assert {"SC_seg", "KW_seg", "MC_seg", "C_seg", "DAG"} == set(checked)
    assert len(checked) == 2 * 3 * 6         # the CPU executor runs too


def test_fused_replay_leaves_earlier_results_unchanged(fused_lake):
    """A second replay of the same programs with other values rewrites the
    programs' buffers, not an earlier result (scores, mask, overflow)."""
    lake, idx = fused_lake
    ex = Executor(idx, backend="bucket")
    first, first_info = ex.run(_fused_plan(lake, 2), fused=True)
    kept = (first.scores.clone(), first.mask.clone())
    n_programs = len(ex.programs)
    second, _ = ex.run(_fused_plan(lake, 5), fused=True)
    torch.cuda.synchronize()
    assert len(ex.programs) == n_programs           # same keys, replayed
    assert not torch.equal(second.scores, kept[0])
    assert torch.equal(first.scores, kept[0])
    assert torch.equal(first.mask, kept[1])
    assert first_info.overflow == ex.run(_fused_plan(lake, 2))[1].overflow


def test_fused_warm_rerun_captures_nothing(fused_lake):
    lake, idx = fused_lake
    ex = Executor(idx, backend="bucket")
    ex.run(_fused_plan(lake, 2), fused=True)
    before, n_programs = dict(seek.TRACE_COUNTS), len(ex.programs)
    for tab in (5, 9, 14):
        ex.run(_fused_plan(lake, tab), fused=True)
    assert dict(seek.TRACE_COUNTS) == before
    assert len(ex.programs) == n_programs


def test_fused_replays_tick_the_launch_counters(fused_lake):
    """The wrappers count in Python, which a replay does not run: each
    replay adds what its capture counted, the same on every run."""
    lake, idx = fused_lake
    ex = Executor(idx, backend="bucket")
    ex.run(_fused_plan(lake, 2), fused=True)
    ticks = []
    for tab in (5, 9):
        before = [f.launches for f in QUERY_WRAPPERS]
        ex.run(_fused_plan(lake, tab), fused=True)
        ticks.append([f.launches - b for f, b in zip(QUERY_WRAPPERS, before)])
    assert ticks[0] == ticks[1] and all(n > 0 for n in ticks[0])


# ----------------------------------------------------------- the live lake

def _guard_table(name, token):
    """A table whose first column holds ``token``-derived cells only: a
    ``kw`` over them ranks exactly this table.  Every guard table has the
    same posting and numeric counts, so its delta segment has one geometry."""
    return Table(name, [[f"{token}_{i}" for i in range(16)],
                        [float(i) for i in range(16)]])


def _live_pair(lake, backend="bucket", **kw):
    """A live session on the card and one on the CPU, mutated alike."""
    return (blend.connect(lake, live=True, backend=backend, **kw),
            blend.connect(lake, live=True, backend="sorted", device="cpu"))


def _same_on_both(pair, q, fused=True):
    card, cpu = pair
    got, want = card.query(q, fused=fused), cpu.query(q, fused=fused)
    assert got.ids == want.ids
    assert torch.equal(got.scores.cpu(), want.scores)
    return got


def test_live_stale_read_guard_on_card(fused_lake):
    """A fused program captured before a mutation within the same geometry
    answers the mutated lake when replayed after it (the arena is refilled
    in place), and a result taken before the mutation is unchanged."""
    lake, _ = fused_lake
    pair = _live_pair(lake)
    card = pair[0]
    q = blend.kw(["guardx_0", "guardy_0"], k=5)
    for s in pair:
        s.add_table(_guard_table("gx", "guardx"))
    first = _same_on_both(pair, q)               # captures the programs
    tid = first.ids[0]
    kept = (first.scores.clone(), list(first.ids))
    for s in pair:
        s.drop_table(tid)
    assert _same_on_both(pair, q).ids == []
    for s in pair:
        assert s.add_table(_guard_table("gy", "guardy")) == tid
    before = dict(seek.TRACE_COUNTS)
    second = _same_on_both(pair, q)              # replays X's programs
    assert dict(seek.TRACE_COUNTS) == before
    assert second.ids == [tid]
    assert card.live.store.table_names[tid] == "gy"
    torch.cuda.synchronize()
    assert torch.equal(first.scores, kept[0]) and first.ids == kept[1]
    # a tombstone inside the base: alive changes, the geometry does not
    base = blend.sc(list(lake.tables[3].columns[0][:8]), k=10)
    assert 3 in _same_on_both(pair, base).ids
    for s in pair:
        s.drop_table(3)
    before = dict(seek.TRACE_COUNTS)
    assert 3 not in _same_on_both(pair, base).ids
    assert dict(seek.TRACE_COUNTS) == before


def test_live_bucket_equals_sorted_equals_cpu_on_card(fused_lake):
    lake, _ = fused_lake
    sessions = {b: blend.connect(lake, live=True, backend=b)
                for b in ("bucket", "sorted")}
    cpu = blend.connect(lake, live=True, backend="bucket", device="cpu")
    everyone = list(sessions.values()) + [cpu]

    def check():
        plan = _fused_plan(lake, 2)
        for fused in (False, True):
            want = cpu.query(plan, fused=fused)
            for s in sessions.values():
                got = s.query(plan, fused=fused)
                assert got.ids == want.ids
                assert torch.equal(got.scores.cpu(), want.scores)

    check()
    for i in range(3):
        t = synthetic_lake(n_tables=1, rows=16, cols=4, vocab=300,
                           seed=40 + i).tables[0]
        assert len({s.add_table(t, name=f"new{i}") for s in everyone}) == 1
        check()
    for tid in (4, 31):                  # a base tombstone, a delta run
        for s in everyone:
            s.drop_table(tid)
        check()
    for s in everyone:
        s.compact()
    check()
    remaps = [s.compact(reclaim_ids=True) for s in everyone]
    assert remaps[0] == remaps[1] == remaps[2]
    check()


def test_live_arena_growth_on_card(fused_lake):
    lake, _ = fused_lake
    pair = _live_pair(lake)
    card = pair[0]
    plan = _fused_plan(lake, 2)
    _same_on_both(pair, plan)
    gen = card.executor.arena.generation
    big = synthetic_lake(n_tables=1, rows=3000, cols=4, vocab=300,
                         seed=50).tables[0]
    for s in pair:
        s.add_table(big, name="big")
    _same_on_both(pair, plan)
    _same_on_both(pair, plan, fused=False)
    assert card.executor.arena.generation == gen + 1
    keys = [k[0] for k in card.executor.programs._programs
            if k[0][0] == "engine"]
    assert keys and all(k[1] == gen + 1 for k in keys)


def test_live_program_memory_stays_flat_on_card(fused_lake):
    """Adds and drops where every add is a geometry not seen before: once
    the executor holds ``RECENT_CONFIGS`` configs' programs, each new one
    evicts the oldest with its graphs' memory, so the device memory stops
    growing; while it fills, each config's programs take memory."""
    lake, _ = fused_lake
    card = blend.connect(lake, live=True, backend="bucket")
    ex = card.executor
    plan = _fused_plan(lake, 2)
    card.query(plan, fused=True)
    mem = []
    for i in range(RECENT_CONFIGS + 8):
        t = synthetic_lake(n_tables=1, rows=8 + i, cols=4, vocab=300,
                           seed=60 + i).tables[0]
        tid = card.add_table(t, name=f"geometry{i}")
        card.query(plan, fused=True)
        card.drop_table(tid)                 # back to the base geometry
        card.query(plan, fused=True)
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
        configs = {key[1:3] for key, *_ in ex.programs._programs
                   if key[0] == "engine"}
        assert len(configs) <= RECENT_CONFIGS
    full = RECENT_CONFIGS - 2            # the base plus RECENT - 1 adds
    per_config = (mem[full] - mem[0]) / full
    assert per_config > 0
    assert max(mem[full:]) - mem[full] < per_config


def test_live_recover_on_card(fused_lake, tmp_path):
    lake, _ = fused_lake
    wal, snap_path = str(tmp_path / "lake.wal"), str(tmp_path / "lake.snap")
    card = blend.connect(lake, live=True, backend="bucket", wal=wal)
    card.snapshot(snap_path)
    card.add_table(_guard_table("g0", "guardx"))
    card.drop_table(5)
    card.snapshot(snap_path)
    card.add_table(_guard_table("g1", "guardy"))
    card.drop_table(2)
    plan = _fused_plan(lake, 3)
    q = blend.kw(["guardx_1", "guardy_1"], k=5)
    want = [card.query(x, fused=True) for x in (plan, q)]
    epoch = card.live.epoch
    del card
    back = blend.recover(snap_path, wal=wal, backend="bucket")
    assert back.live.epoch == epoch
    for x, w in zip((plan, q), want):
        got = back.query(x, fused=True)
        assert got.ids == w.ids
        assert torch.equal(got.scores, w.scores)
