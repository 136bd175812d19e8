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
and that ``recover`` on the card equals the session it replaces.  The
batching server's tests check that its dispatcher thread captures
programs that record work and replays programs the main thread captured,
with answers equal to sequential ``serve``; that it captures while
another thread serves a second session on the card; and that mutation
barriers give the answers of a sequential replay.  The sharded lake's
tests check that a 4-shard session (every shard on one card, or one per
card with several) equals a 1-shard session and the CPU port, that a
shard retried after a failure answers from a rebuilt engine and new
programs, that a shard dropped after two failures gives a degraded
response through the server's dispatcher, and that the per-shard group
programs replayed before one DAG program are summed group by group.
This file imports no JAX, so it runs on the H100 machine as it is:
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""
import gc

import numpy as np
import pytest
import torch

import repro_torch as blend
from repro_torch import faults
from repro_torch.core import executor as executor_mod
from repro_torch.core import fused
from repro_torch.core import seekers as seek
from repro_torch.core.executor import RECENT_CONFIGS, Executor
from repro_torch.core.hashing import MISSING
from repro_torch.core.index import build_index, hash_keys
from repro_torch.core.lake import Table, synthetic_lake
from repro_torch.core.match import MatchEngine
from repro_torch.core.plan import Combiners, Plan, Seekers
from repro_torch.faults import FaultInjector
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
from repro_torch.serve.engine import DiscoveryEngine


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


@pytest.mark.parametrize("bound", [5, RECENT_CONFIGS])
def test_live_program_memory_stays_flat_on_card(fused_lake, bound,
                                                monkeypatch):
    """Adds and drops where every add is a geometry not seen before: once
    the executor holds ``bound`` configs' programs, each new one evicts
    the oldest with its programs' static inputs and outputs, so the device
    memory stops growing; while it fills, each config's programs take
    memory."""
    monkeypatch.setattr(executor_mod, "RECENT_CONFIGS", bound)
    lake, _ = fused_lake
    card = blend.connect(lake, live=True, backend="bucket")
    ex = card.executor
    plan = _fused_plan(lake, 2)
    card.query(plan, fused=True)
    # earlier tests' garbage (device tensors in reference cycles) goes
    # before the series; within it only reference counting frees memory,
    # so an evicted config held alive by a cycle shows as growth
    gc.collect()
    gc.disable()
    mem, held = [], []
    try:
        for i in range(bound + 8):
            t = synthetic_lake(n_tables=1, rows=8 + i, cols=4, vocab=300,
                               seed=60 + i).tables[0]
            tid = card.add_table(t, name=f"geometry{i}")
            card.query(plan, fused=True)
            card.drop_table(tid)             # back to the base geometry
            card.query(plan, fused=True)
            torch.cuda.synchronize()
            mem.append(torch.cuda.memory_allocated())
            held.append(len({key[1:3] for key, *_ in ex.programs._programs
                             if key[0] == "engine"}))
            assert held[-1] <= bound
    finally:
        gc.enable()
    # two sizes may pad to one geometry: the cache is full at the first
    # step that holds ``bound`` configs (the base and bound - 1 adds)
    full = held.index(bound)
    assert full <= 10
    per_config = (mem[full] - mem[0]) / (held[full] - held[0])
    assert per_config > 0
    assert max(mem[full:]) - mem[full] < per_config


def _group_program(ex, spec):
    """A call of the fused path's seeker-group program for ``spec`` alone:
    returns the program's own output buffers (scores, overflow copy)."""
    plan = Plan()
    plan.add("s", spec)
    task = fused._compile_plan(plan, False, None, None, 0).tasks[0]
    fused._hash_tasks(ex, [task])
    return fused._launch_group(ex, fused._group_key(spec), [task])


def test_shared_pool_programs_replay_in_reverse_order_on_card(fused_lake):
    """Two group programs captured in turn into the executor's shared
    graph memory pool, then replayed in the reverse order with other
    values: the one replayed first still holds its answer after the other
    ran, and both equal the plain path on the CPU.  Their outputs lie
    outside the pool (in the ordinary allocator's segments)."""
    lake, idx = fused_lake
    ex = Executor(idx, backend="bucket")
    cpu = Executor(idx, backend="bucket", device="cpu")

    def specs(tab):
        t = lake.tables[tab]
        return (Seekers.SC(list(t.columns[0][:6]), k=12),
                Seekers.KW([t.columns[1][0], t.columns[1][1]], k=12))

    for spec in specs(2):                    # capture: SC, then KW
        _group_program(ex, spec)
    pool, before = ex.programs._pool, dict(seek.TRACE_COUNTS)
    assert pool is not None and len(ex.programs) == 2
    sc, kw = specs(5)
    kw_scores, _ = _group_program(ex, kw)    # replay: KW, then SC
    sc_scores, _ = _group_program(ex, sc)
    torch.cuda.synchronize()
    assert dict(seek.TRACE_COUNTS) == before and ex.programs._pool is pool
    for spec, got in ((kw, kw_scores), (sc, sc_scores)):
        want, _ = _group_program(cpu, spec)
        assert torch.equal(got.cpu(), want), spec.kind
    pools = {}
    for seg in torch.cuda.memory_snapshot():
        pools[(seg["address"], seg["total_size"])] = \
            tuple(seg["segment_pool_id"])
    assert any(p != (0, 0) for p in pools.values())     # the shared pool
    for got in (kw_scores, sc_scores):
        (pool,) = [p for (a, n), p in pools.items()
                   if a <= got.data_ptr() < a + n]
        assert pool == (0, 0)


# ------------------------------------------------ the query cache and serve

def _device_events(fn):
    """Names of the device activities (kernels, copies) of one call of
    ``fn``, read from a profiler session after a warm-up call and a marker
    kernel (the profiler may drop a session's earliest records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    names = [e.name() for e in sorted(prof.profiler.kineto_results.events(),
                                      key=lambda e: e.start_ns())
             if e.device_type() != DeviceType.CPU]
    marks = [i for i, n in enumerate(names) if "spin_kernel" in n]
    assert len(marks) == 1, "the trace lost the marker kernel"
    return names[marks[0] + 1:]


def _cache_queries(lake):
    t, u = lake.tables[3], lake.tables[9]
    return {"sc_a": blend.sc(list(t.columns[0][:8]), k=12),
            "sc_b": blend.sc(list(u.columns[0][:8]), k=12),
            "corr": blend.corr(list(t.columns[0][:8]),
                               [float(i) for i in range(8)], k=12, h=64),
            "kw": blend.kw([t.columns[1][0], t.columns[1][1]], k=12)}


def test_cached_seeker_survives_a_replay_of_its_program_on_card(fused_lake):
    """``sc`` over A is cached from the fused path; ``sc`` over B replays
    the same group and DAG programs with other values; the cached entry
    still holds A's answer, and a partial ``sc | corr`` served from it
    equals a cold run."""
    lake, _ = fused_lake
    s = blend.connect(lake, cache=True, backend="bucket")
    cold = blend.connect(lake, backend="bucket", device="cpu")
    q = _cache_queries(lake)
    s.query(q["sc_a"], fused=True)
    before = dict(seek.TRACE_COUNTS)
    b = s.query(q["sc_b"], fused=True)
    assert dict(seek.TRACE_COUNTS) == before      # the same programs
    assert b.cache.status == "miss"
    torch.cuda.synchronize()
    spec = s.compile(q["sc_a"]).plan.nodes["sc0"].spec
    entry = s.cache.get_seeker(s.cache.seeker_key(spec))
    want = cold.query(q["sc_a"])
    assert not torch.equal(b.scores.cpu(), want.scores)
    assert torch.equal(entry.result.scores.cpu(), want.scores)
    r = s.query(q["sc_a"] | q["corr"], fused=True)
    assert r.cache.status == "partial" and r.info.cached_nodes == ["sc0"]
    want = cold.query(q["sc_a"] | q["corr"])
    assert r.ids == want.ids and torch.equal(r.scores.cpu(), want.scores)


def test_serve_many_makes_one_device_to_host_copy_on_card(fused_lake):
    """A warm ``serve_many`` batch, fused and unfused, with and without
    the cache: the trace shows exactly one device-to-host copy, and the
    answers equal sequential ``serve`` bit for bit."""
    lake, _ = fused_lake
    q = list(_cache_queries(lake).values())
    batch = q + [q[0] | q[2], blend.counter(q[0], q[1], q[3])]
    for cache in (False, True):
        eng = DiscoveryEngine(lake, backend="bucket", cache=cache)
        serial = [eng.serve(x) for x in batch]
        for fused in (False, True):
            eng.serve_many(batch, fused=fused)
            names = _device_events(lambda: eng.serve_many(batch,
                                                          fused=fused))
            copies = [n for n in names if n.startswith("Memcpy DtoH")]
            assert len(copies) == 1, (cache, fused, copies)
            for a, b in zip(serial, eng.serve_many(batch, fused=fused)):
                assert a.table_ids == b.table_ids
                assert np.array_equal(a.scores, b.scores)
                assert a.overflow == b.overflow


def test_cache_hit_launches_nothing_on_card(fused_lake):
    """An exact-result hit reads its entry only: no kernel, no copy, no
    wrapper launch, no program built; its answer equals the miss."""
    lake, _ = fused_lake
    s = blend.connect(lake, cache=True, backend="bucket")
    q = _cache_queries(lake)
    query = (q["sc_a"] & q["kw"]) | q["corr"]
    for fused in (False, True):
        first = s.query(query, fused=fused)
        first.ids
        before = ([f.launches for f in QUERY_WRAPPERS],
                  dict(seek.TRACE_COUNTS))
        got = []
        names = _device_events(lambda: got.append(s.query(query,
                                                          fused=fused)))
        assert names == []
        assert ([f.launches for f in QUERY_WRAPPERS],
                dict(seek.TRACE_COUNTS)) == before
        assert all(r.cache.status == "hit" for r in got)
        assert got[-1].ids == first.ids
        assert torch.equal(got[-1].scores, first.scores)
        s.cache.clear()


def test_cached_fused_runs_capture_no_empty_graph_on_card(fused_lake):
    """Cached fused runs, including plans whose every seeker comes from
    the cache, capture no empty CUDA graph (the warning is an error
    here), and a program that would capture no work is refused."""
    import warnings
    lake, idx = fused_lake
    s = blend.connect(lake, cache=True, backend="bucket")
    cold = blend.connect(lake, backend="bucket", device="cpu")
    q = _cache_queries(lake)
    plans = [q["sc_a"] | q["kw"], q["sc_a"], q["kw"], q["sc_a"] & q["kw"],
             blend.counter(q["sc_a"], q["kw"], q["corr"])]
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*CUDA Graph is empty.*")
        for x in plans:
            r = s.query(x, fused=True)
            want = cold.query(x)
            assert r.ids == want.ids and torch.equal(r.scores.cpu(),
                                                     want.scores)
        s.cache.clear()
        s.query_many(plans[:1])
        for r, x in zip(s.query_many(plans), plans):
            assert r.ids == cold.query(x).ids
    ex = Executor(idx, backend="bucket")
    with pytest.raises(RuntimeError, match="captured no work"):
        ex.programs.run(("empty",), "DAG",
                        lambda: (torch.empty(0, device="cuda"),))


def test_capture_beside_dead_programs_on_card(fused_lake):
    """A dead executor's programs, held only by a reference cycle, and a
    new capture during which the collector would run at every allocation:
    the collector stays off inside the capture (freeing a graph there
    breaks it), so the capture holds and replays right."""
    import gc
    lake, idx = fused_lake
    dead = Programs(torch.device("cuda"))
    x = torch.arange(4.0, device="cuda")
    dead.run(("dead",), "DAG", lambda t: (t * 2,), (), (x,))
    keep = [dead]
    del dead

    def fn(x):
        if torch.cuda.is_current_stream_capturing():
            gc.set_threshold(1, 1, 1)        # collect at every allocation
        elif keep:                           # the warm-up: leave garbage
            cycle = [keep.pop()]
            cycle.append(cycle)
        return (x + 1,)

    thresholds = gc.get_threshold()
    gc.set_threshold(1 << 30, 1 << 10, 1 << 10)   # none before the capture
    ex = Executor(idx, backend="bucket")
    try:
        (out,) = ex.programs.run(("gc",), "DAG", fn, (), (x,))
    finally:
        gc.set_threshold(*thresholds)
    torch.cuda.synchronize()
    assert not keep and torch.equal(out, x + 1)
    (out,) = ex.programs.run(("gc",), "DAG", fn, (), (x * 2,))
    torch.cuda.synchronize()
    assert torch.equal(out, x * 2 + 1)


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


# ------------------------------------------------- the batching server

def _server_batch(lake, tab):
    """Five requests over table ``tab``: the fused plan, and expressions
    of every seeker kind; the same shapes for every ``tab``."""
    t = lake.tables[tab]
    sc = blend.sc(list(t.columns[0][:6]), k=12)
    kw = blend.kw([t.columns[1][0], t.columns[1][1]], k=12)
    mc = blend.mc([(t.columns[0][r], t.columns[1][r]) for r in range(4)],
                  k=12)
    corr = blend.corr(list(t.columns[0][:6]), [float(i) for i in range(6)],
                      k=12, h=64)
    return [_fused_plan(lake, tab), (sc & kw).top(8), (mc | corr).top(8),
            blend.counter(sc, kw, mc, k=8), corr]


def _same_response(got, want, ctx=""):
    assert not isinstance(got, BaseException), (ctx, got)
    assert got.table_ids == want.table_ids, ctx
    assert np.array_equal(got.scores, want.scores), ctx


def _traced_kernels(fn) -> list:
    """Launches of each query-path kernel (``QUERY_WRAPPERS`` order) in
    the profiler's trace of one call of ``fn`` (after a warm-up call and
    a marker kernel)."""
    names = _device_events(fn)
    return [sum(f"{k}_kernel" in n for n in names)
            for k in ("bucket_probe", "superkey_filter_rows", "qcr_segments")]


def test_dispatcher_first_capture_records_work_on_card(fused_lake):
    """A server over a fresh engine: the dispatcher thread captures every
    program (no empty graph: the warning is an error here), its replays
    launch the query-path kernels (ticked and traced alike), and with new
    values of the same shapes its answers equal sequential ``serve`` on
    the main thread, bit for bit."""
    import warnings
    from repro_torch.serve.server import DiscoveryServer
    lake, _ = fused_lake
    batches = [_server_batch(lake, 3), _server_batch(lake, 9)]
    seq = DiscoveryEngine(lake, backend="bucket")
    want = [[seq.serve(q, fused=True) for q in b] for b in batches]
    eng = DiscoveryEngine(lake, backend="bucket")
    built = sum(seek.TRACE_COUNTS.values())
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*CUDA Graph is empty.*")
        # a batch closes when full: every batch is the five requests
        srv = DiscoveryServer(eng, max_batch=len(batches[0]),
                              interactive_window_s=1.0)
        try:
            futs = [srv.submit(q) for q in batches[0]]
            for f, w in zip(futs, want[0]):
                _same_response(f.result(timeout=120), w)
            assert sum(seek.TRACE_COUNTS.values()) > built
            captured = sum(seek.TRACE_COUNTS.values())
            ticks = [f.launches for f in QUERY_WRAPPERS]

            def second():
                got = [srv.submit(q) for q in batches[1]]
                for f, w in zip(got, want[1]):
                    _same_response(f.result(timeout=120), w)

            traced = _traced_kernels(second)     # calls it twice
            ticked = [f.launches - n for f, n in zip(QUERY_WRAPPERS, ticks)]
            assert sum(seek.TRACE_COUNTS.values()) == captured
            assert all(n > 0 for n in ticked)
            assert [2 * n for n in traced] == ticked
        finally:
            srv.stop()


def test_main_thread_programs_replay_from_dispatcher_on_card(fused_lake):
    """Programs captured by ``serve_many`` on the main thread replay from
    the dispatcher thread with other values: no capture, the kernels
    launched, and every answer equal to the CPU port's."""
    from repro_torch.serve.server import DiscoveryServer
    lake, _ = fused_lake
    eng = DiscoveryEngine(lake, backend="bucket")
    cpu = DiscoveryEngine(lake, backend="bucket", device="cpu")
    eng.serve_many(_server_batch(lake, 3), fused=True)
    torch.cuda.synchronize()
    built = dict(seek.TRACE_COUNTS)
    ticks = [f.launches for f in QUERY_WRAPPERS]
    batch = _server_batch(lake, 9)
    srv = DiscoveryServer(eng, max_batch=16, start=False)
    try:
        futs = [srv.submit(q) for q in batch]   # one batch, as captured
        srv.start()
        got = [f.result(timeout=120) for f in futs]
    finally:
        srv.stop()
    assert dict(seek.TRACE_COUNTS) == built
    assert all(f.launches > n for f, n in zip(QUERY_WRAPPERS, ticks))
    assert max(r.batch_size for r in got) == len(batch)
    for g, q in zip(got, batch):
        _same_response(g, cpu.serve(q))


def test_dispatcher_captures_while_another_thread_serves_on_card(
        fused_lake):
    """The dispatcher captures a new program for every request (a new
    ``k`` each) while another thread serves a second session on the card,
    fused (capturing programs of its own) and unfused (eager kernels,
    allocations, synchronizations): no capture fails, and every answer of
    both equals the CPU port's."""
    import threading
    from repro_torch.serve.server import DiscoveryServer
    lake, _ = fused_lake
    t, u = lake.tables[3], lake.tables[9]
    cpu = DiscoveryEngine(lake, backend="bucket", device="cpu")
    ks = range(2, 26)
    mine = [(blend.sc(list(t.columns[0][:8]), k=k) |
             blend.kw([t.columns[1][0]], k=k)).top(k) for k in ks]
    theirs = [(blend.mc([(u.columns[0][r], u.columns[1][r])
                         for r in range(3)], k=k) &
               blend.corr(list(u.columns[0][:6]),
                          [float(i) for i in range(6)], k=k, h=64)).top(k)
              for k in ks]
    other = DiscoveryEngine(lake, backend="bucket")
    srv = DiscoveryServer(DiscoveryEngine(lake, backend="bucket"))
    stop, seen, failures = threading.Event(), [], []

    def serve_other():
        try:
            while not stop.is_set():
                for q in theirs:
                    for fused in (True, False):
                        seen.append((q, other.serve(q, fused=fused)))
        except BaseException as e:                    # noqa: BLE001
            failures.append(e)

    worker = threading.Thread(target=serve_other)
    built = sum(seek.TRACE_COUNTS.values())
    worker.start()
    try:
        got = [srv.submit(q).result(timeout=120) for q in mine]
    finally:
        stop.set()
        worker.join(timeout=300)
        srv.stop()
    assert not worker.is_alive() and not failures, failures
    assert sum(seek.TRACE_COUNTS.values()) - built >= len(mine)
    for g, q in zip(got, mine):
        _same_response(g, cpu.serve(q))
    want = {id(q): cpu.serve(q) for q in theirs}
    assert len(seen) >= len(theirs)
    for q, r in seen:
        _same_response(r, want[id(q)])


def _mapped_equal(got, want, tid_got, tid_want, ctx=""):
    """``got`` equals ``want`` with table ``tid_got`` read as
    ``tid_want`` (a re-added table may take a new id)."""
    assert [tid_want if t == tid_got else t for t in got.table_ids] == \
        want.table_ids, ctx
    n = max(len(got.scores), len(want.scores))
    a, b = np.zeros(n, np.float32), np.zeros(n, np.float32)
    a[:len(got.scores)], b[:len(want.scores)] = got.scores, want.scores
    a[tid_want], a[tid_got] = a[tid_got], (0.0 if tid_got != tid_want
                                           else a[tid_got])
    assert np.array_equal(a, b), ctx


def test_server_live_barriers_on_card(fused_lake):
    """From one thread, without waiting: queries, ``add_table(guard)``,
    queries, ``drop_table`` by name, queries.  The guard ranks first only
    in the middle batch, and every answer equals a sequential replay of the
    same operations on the main thread after ``stop()``."""
    from repro_torch.serve.server import DiscoveryServer
    lake, _ = fused_lake
    eng = DiscoveryEngine(lake, live=True, backend="bucket")
    guard = _guard_table("g0", "guardx")
    qs = _server_batch(lake, 3) + [
        blend.kw(["guardx_1", "guardx_2"], k=5),
        blend.sc([f"guardx_{i}" for i in range(8)], k=5)]
    srv = DiscoveryServer(eng, max_batch=16, interactive_window_s=0.05)
    try:
        pre = [srv.submit(q) for q in qs]
        add = srv.add_table(guard, name="g0")
        mid = [srv.submit(q) for q in qs]
        drop = srv.drop_table("g0")
        post = [srv.submit(q) for q in qs]
        steps = [[f.result(timeout=120) for f in fs]
                 for fs in (pre, mid, post)]
        tid = add.result(timeout=120)
        assert drop.result(timeout=120) == tid
    finally:
        srv.stop()
    for i, step in enumerate(steps):
        for r in step:
            assert not isinstance(r, BaseException), r
        guard_first = [r.table_ids[:1] == [tid] for r in step[-2:]]
        assert guard_first == [i == 1] * 2, i
        assert all(i == 1 or tid not in r.table_ids for r in step)
    replay = [[eng.serve(q, fused=True) for q in qs]]
    tid2 = eng.add_table(guard, name="g0")
    replay.append([eng.serve(q, fused=True) for q in qs])
    eng.drop_table("g0")
    replay.append([eng.serve(q, fused=True) for q in qs])
    for i, (step, want) in enumerate(zip(steps, replay)):
        for j, (g, w) in enumerate(zip(step, want)):
            _mapped_equal(g, w, tid, tid2, (i, j))


def test_device_sync_during_a_server_capture_on_card(fused_lake,
                                                     monkeypatch):
    """ROADMAP section C 1: a user thread calls ``torch.cuda.synchronize()``
    while the server's dispatcher captures a geometry it has not seen.  The
    overlap is forced, not timed: the captured callable signals on entry
    and waits (5 s at most) for the user's sync to have returned or raised
    before it goes on.  The test records which call failed and how (the
    user's sync, the capture, or neither; the exception type and the CUDA
    error), prints it as a ``c1_outcome`` JSON line, and asserts that the
    server keeps running, that the request and the same request again (a
    replay, no capture) are answered as sequential ``serve`` answers them,
    and that any error a client sees is one of the port's typed errors."""
    import json
    import threading
    import time
    from repro_torch import errors, obs
    from repro_torch.core import programs
    from repro_torch.serve.server import DiscoveryServer
    lake, _ = fused_lake
    t = lake.tables[5]
    query = (blend.sc(list(t.columns[0][:7]), k=13) |
             blend.kw([t.columns[1][0]], k=13)).top(13)
    want = DiscoveryEngine(lake, backend="bucket").serve(query, fused=True)
    torch.cuda.synchronize()
    entered, synced = threading.Event(), threading.Event()
    outcome = {"user": None, "capture": [], "user_waited_s": None}
    armed = [True]

    def describe(e):
        return {"type": type(e).__name__, "error": str(e).splitlines()[0]}

    class HeldGraph(programs._Graph):
        def __init__(self, fn, *args):
            def held(*a):
                if armed[0] and torch.cuda.is_current_stream_capturing():
                    armed[0] = False
                    entered.set()
                    synced.wait(timeout=5)
                try:
                    return fn(*a)
                except RuntimeError as e:
                    outcome["capture"].append(describe(e))
                    raise
            super().__init__(held, *args)

    end_capture = torch.cuda.CUDAGraph.capture_end

    def capture_end(graph):
        try:
            return end_capture(graph)
        except RuntimeError as e:
            outcome["capture"].append(describe(e))
            raise

    monkeypatch.setattr(programs, "_Graph", HeldGraph)
    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_end", capture_end)

    def user():
        assert entered.wait(timeout=120)
        t0 = time.perf_counter()
        try:
            torch.cuda.synchronize()
        except RuntimeError as e:
            outcome["user"] = describe(e)
        finally:
            outcome["user_waited_s"] = time.perf_counter() - t0
            synced.set()

    def answer(q):
        # a raw RuntimeError raises here and fails the test
        try:
            return srv.submit(q).result(timeout=120)
        except errors.BlendFault as e:
            return e

    reg = obs.enable()
    worker = threading.Thread(target=user)
    srv = DiscoveryServer(DiscoveryEngine(lake, backend="bucket"))
    try:
        worker.start()
        first = answer(query)
        outcome["first_request"] = type(first).__name__
        worker.join(timeout=120)
        assert not worker.is_alive()
        built = sum(seek.TRACE_COUNTS.values())
        second = answer(query)
        running = srv.stats()["running"]
    finally:
        srv.stop()
        obs.disable()
        recaptures = outcome["recaptures"] = \
            reg.counter("programs.recaptures").value
        print("c1_outcome " + json.dumps(outcome))
    assert not armed[0], "the capture never ran the held callable"
    assert running
    _same_response(second, want)
    if not isinstance(first, errors.BlendFault):
        _same_response(first, want)
        # the program was kept: the second request replayed it
        assert sum(seek.TRACE_COUNTS.values()) == built
    assert recaptures == (1 if outcome["capture"] else 0)


def test_lm_engine_on_card_equals_cpu(cuda):
    """``LMEngine`` on the card gives the CPU port's greedy tokens for the
    four dense archs at reduced f32 (TF32 off), with every parameter and
    cache tensor on the card."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import lm, registry
    from repro_torch.serve.engine import LMEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = ShapeConfig("s", 64, 2, "prefill")
    for arch in ("smollm-360m", "yi-6b", "olmo-1b", "minitron-8b"):
        cfg = reduced(get_config(arch))
        cpu = registry.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
        card = _to(cpu, cuda)
        tokens = registry.make_batch(cfg, shape,
                                     torch.Generator().manual_seed(1),
                                     device="cpu")["tokens"]
        want = LMEngine(cfg, cpu, 72, device="cpu").generate(
            {"tokens": tokens}, 8)
        got = LMEngine(cfg, card, 72, device=cuda).generate(
            {"tokens": tokens}, 8)
        np.testing.assert_array_equal(got, want, err_msg=arch)
        cache, _ = lm.prefill(card, cfg, tokens.to(cuda), 72)
        assert all(v.is_cuda for v in cache.values())
        assert all(v.is_cuda for v in registry.leaves(card).values())


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def test_train_step_on_card_equals_cpu(cuda, monkeypatch):
    """A reduced f32 train step (TF32 off) of each dense arch on the card
    against the CPU port: the loss within 1e-5, every gradient leaf within
    1e-5 of its largest magnitude (the bounds of
    tests/test_torch_train.py), ``grad_accum`` 2 included; the step
    updates the state on the card in place."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import registry
    from repro_torch.train.step import (grads_of, make_train_state,
                                        make_train_step)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for arch in ("smollm-360m", "yi-6b", "olmo-1b", "minitron-8b"):
        for accum in (1, 2):
            cfg = reduced(get_config(arch)).replace(grad_accum=accum)
            cpu = make_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
            card = _to(cpu, cuda)
            tokens = torch.randint(0, cfg.vocab, (4, 64), dtype=torch.int32,
                                   generator=torch.Generator().manual_seed(1))
            loss = registry.loss_fn(cfg)
            (l_cpu, _), g_cpu = grads_of(loss, cpu["params"],
                                         {"tokens": tokens})
            (l_card, _), g_card = grads_of(loss, card["params"],
                                           {"tokens": tokens.to(cuda)})
            assert abs(float(l_card) - float(l_cpu)) <= 1e-5, arch
            g_card = registry.leaves(g_card)
            for k, w in registry.leaves(g_cpu).items():
                assert g_card[k].is_cuda
                np.testing.assert_allclose(
                    g_card[k].cpu().numpy(), w.numpy(), rtol=0,
                    atol=1e-5 * float(w.abs().max()), err_msg=f"{arch} {k}")
            _, m_cpu = make_train_step(cfg)(cpu, {"tokens": tokens})
            params = card["params"]["tok_embed"]
            out, m_card = make_train_step(cfg)(card, {"tokens": tokens})
            assert out["params"]["tok_embed"] is params and params.is_cuda
            assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) <= 1e-5
            assert int(out["opt"]["step"]) == 1


@pytest.mark.parametrize("task", ["negative_examples", "imputation",
                                  "multi_objective", "union_via_counter",
                                  "correlation_vs_qcr",
                                  "discovery_fed_pipeline"])
def test_system_task_on_card_equals_cpu(cuda, task):
    """tests/test_system.py's six tasks (``tests/system_tasks.py``) through
    the port on the card, both backends, equal to the CPU port: ids,
    baselines, tokens and batches."""
    import types

    import system_tasks
    from repro_torch.core import baselines, lake, plan
    from repro_torch.data import pipeline

    def ns(backend, device):
        return types.SimpleNamespace(
            lake=lake, build_index=build_index, Plan=plan.Plan,
            Seekers=plan.Seekers, Combiners=plan.Combiners,
            baselines=baselines, pipeline=pipeline,
            executor=lambda idx: Executor(idx, backend=backend,
                                          device=device))

    want = system_tasks.TASKS[task](ns("sorted", "cpu"))
    for backend in ("sorted", "bucket"):
        got = system_tasks.TASKS[task](ns(backend, cuda))
        assert got["ids"] == want["ids"], backend
        for key in ("mate", "josie", "qcr", "ids_unoptimized"):
            if key in want:
                assert got[key] == want[key], (backend, key)
        if "tokens" in want:
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            for a, b in zip(got["batches"], want["batches"]):
                np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- the sharded lake

def _same_result(got, want, ctx=""):
    assert got.ids == want.ids, ctx
    assert torch.equal(got.scores.cpu(), want.scores.cpu()), ctx


def test_sharded_session_equals_one_shard_and_cpu_on_card(fused_lake):
    """A 4-shard live session on the card (shard i on ``cuda:(i %
    device_count)``) equals a 1-shard session on the card and the 4-shard
    CPU port, through an add and a drop, with ``n_groups + 1`` launches and
    no overflow; the second table of each step replays every program."""
    lake, _ = fused_lake
    n_dev = torch.cuda.device_count()
    s4 = blend.connect(lake, shards=4, live=True, backend="bucket")
    s1 = blend.connect(lake, shards=1, live=True, backend="bucket")
    cpu = blend.connect(lake, shards=4, live=True, backend="sorted",
                        device="cpu")
    assert s4.executor.devices == [torch.device("cuda", i % n_dev)
                                   for i in range(4)]
    for step in ("connect", "add", "drop"):
        if step == "add":
            tids = {s.add_table(_guard_table("g0", "guardq"))
                    for s in (s4, s1, cpu)}
            assert len(tids) == 1
        elif step == "drop":
            for s in (s4, s1, cpu):
                s.drop_table(5)
        for tab in (2, 9):
            plan = _fused_plan(lake, tab)
            got, one, want = (s.query(plan) for s in (s4, s1, cpu))
            _same_result(got, one, (step, tab, "1 shard"))
            _same_result(got, want, (step, tab, "cpu"))
            assert got.info.launches == one.info.launches == 5 + 1
            assert got.info.overflow == 0 and got.info.failed_shards == []
        q = blend.kw(["guardq_1", "guardq_2"], k=5)
        _same_result(s4.query(q), cpu.query(q), step)
    assert s4.live.store.epoch == cpu.live.store.epoch
    assert all(len(sh.programs) for sh in s4.executor.shards)


def test_sharded_retry_drops_the_failed_shards_programs_on_card(
        fused_lake):
    """Shard 1 fails once and is retried on a rebuilt engine; a mutation
    within the same geometry then refills the rebuilt arena.  Warm queries
    afterwards equal the CPU port, which holds only if shard 1's programs
    captured over its old arena were dropped with it (the old arena is
    kept alive here, so a stale program would read the unmutated lake)."""
    lake, _ = fused_lake
    s = blend.connect(lake, shards=4, live=True, backend="bucket")
    cpu = blend.connect(lake, shards=4, live=True, backend="sorted",
                        device="cpu")
    plan = _fused_plan(lake, 2)
    own = lake.tables[5]                     # table 5 lives on shard 1
    q = blend.kw(list(own.columns[0][:6]), k=12)
    clean = [s.query(x) for x in (plan, q)]
    assert clean[1].ids[:1] == [5]
    old = s.executor.shards[1]
    with faults.inject(FaultInjector(fail={"shard.probe.1": 1})):
        retried = s.query(plan)
    _same_result(retried, clean[0], "retried")
    assert retried.info.failed_shards == []
    assert s.executor.shards[1] is not old
    for x in (plan, q):                      # warm
        _same_result(s.query(x), cpu.query(x), "warm")
    for sess in (s, cpu):
        sess.drop_table(5)
    got = s.query(q)
    assert 5 not in got.ids
    _same_result(got, cpu.query(q), "after drop")
    _same_result(s.query(plan), cpu.query(plan), "after drop")
    del old


def test_sharded_degraded_response_through_dispatcher_on_card(fused_lake):
    """Shard 2 fails on every probe while the server's dispatcher thread
    runs a batch: each response is flagged degraded with
    ``failed_shards == [2]``, holds no table of shard 2, and every table it
    holds that the clean answer holds keeps its clean score; afterwards
    the same batch is clean again."""
    from repro_torch.serve.server import DiscoveryServer
    lake, _ = fused_lake
    eng = DiscoveryEngine(lake, shards=4, live=True, backend="bucket")
    batch = _server_batch(lake, 3)
    clean = [eng.serve(q, fused=True) for q in batch]
    store = eng.executor.index
    srv = DiscoveryServer(eng, max_batch=len(batch),
                          interactive_window_s=1.0)
    try:
        with faults.inject(FaultInjector(fail={"shard.probe.2": 10 ** 6})):
            futs = [srv.submit(q) for q in batch]
            got = [f.result(timeout=120) for f in futs]
        after = [f.result(timeout=120) for f in
                 [srv.submit(q) for q in batch]]
    finally:
        srv.stop()
    assert max(r.batch_size for r in got) == len(batch)
    for r, c in zip(got, clean):
        assert not isinstance(r, BaseException), r
        assert r.degraded is True and r.failed_shards == [2]
        for tid in r.table_ids:
            assert store.owner_of(tid) != 2
            if tid in c.table_ids:
                assert r.scores[tid] == c.scores[tid]
    assert srv.stats()["degraded"] == len(batch)
    for r, c in zip(after, clean):
        assert r.degraded is False and r.failed_shards == []
        _same_response(r, c)


def test_two_shards_group_programs_summed_by_one_dag_on_card(fused_lake):
    """Two shards on one card, a plan of two groups (SC, KW): each shard's
    group programs replay into buffers of their own, outside every graph
    pool, and the one DAG program sums them group by group, equal to the
    1-shard session and the CPU port; a second table replays every
    program (no capture) with the same outcome."""
    lake, _ = fused_lake
    s2 = blend.connect(lake, shards=2, backend="bucket")
    s1 = blend.connect(lake, shards=1, backend="bucket")
    cpu = blend.connect(lake, shards=2, backend="bucket", device="cpu")
    ex = s2.executor

    def query(tab):
        t = lake.tables[tab]
        return blend.sc(list(t.columns[0][:6]), k=12) | blend.kw(
            [t.columns[1][0], t.columns[1][1]], k=12)

    outs = []
    launch = fused._launch_group

    def keep(ex_, key, tasks, failed=None):
        out = launch(ex_, key, tasks, failed)
        if ex_ is ex:
            outs.append(out[0])
        return out

    fused._launch_group = keep
    try:
        for tab in (2, 9):
            before = dict(seek.TRACE_COUNTS)
            outs.clear()
            got = s2.query(query(tab))
            torch.cuda.synchronize()
            if tab == 9:
                assert dict(seek.TRACE_COUNTS) == before
            _same_result(got, s1.query(query(tab)), tab)
            _same_result(got, cpu.query(query(tab)), tab)
            assert got.info.launches == 3
            assert len(outs) == 2 and all(len(o) == 2 for o in outs)
            ptrs = {o.data_ptr() for pair in outs for o in pair}
            assert len(ptrs) == 4
    finally:
        fused._launch_group = launch
    pools = {}
    for seg in torch.cuda.memory_snapshot():
        pools[(seg["address"], seg["total_size"])] = \
            tuple(seg["segment_pool_id"])
    for ptr in ptrs:
        (pool,) = [p for (a, n), p in pools.items() if a <= ptr < a + n]
        assert pool == (0, 0)


def test_shards_on_separate_cards_merge_like_one_card(fused_lake):
    """One shard per card (shard i on ``cuda:i``): every shard's engine
    and programs live on its own card, the merge runs on card 0, and the
    answers equal one card's 1-shard session and the CPU port, through a
    retried shard failure and an add."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    lake, _ = fused_lake
    sn = blend.connect(lake, shards=n, live=True, backend="bucket")
    s1 = blend.connect(lake, shards=1, live=True, backend="bucket")
    cpu = blend.connect(lake, shards=n, live=True, backend="sorted",
                        device="cpu")
    ex = sn.executor
    assert ex.devices == [torch.device("cuda", i) for i in range(n)]
    assert ex.device == torch.device("cuda", 0)
    for step in ("connect", "retry", "add"):
        if step == "add":
            for s in (sn, s1, cpu):
                s.add_table(_guard_table("g0", "guardm"))
        for tab in (2, 9):
            plan = _fused_plan(lake, tab)
            if step == "retry":
                with faults.inject(FaultInjector(
                        fail={f"shard.probe.{n - 1}": 1})):
                    got = sn.query(plan)
            else:
                got = sn.query(plan)
            assert got.scores.device == torch.device("cuda", 0)
            _same_result(got, s1.query(plan), (step, tab))
            _same_result(got, cpu.query(plan), (step, tab))
            assert got.info.failed_shards == []
    for i, sh in enumerate(ex.shards):
        assert sh.engine.dev["hash"].device == torch.device("cuda", i)
        assert sh.programs.device == torch.device("cuda", i)


# ------------------------------------------------------- the approximate tier

APPROX_PROBE_FIELDS = ("est", "bound_lo", "bound_hi", "ci_lo", "ci_hi",
                       "impossible")


def _approx_lake():
    """Text columns with more distinct values than the sketches' K = 128
    and more rows than the row sample, so SC, KW and C all estimate."""
    return synthetic_lake(n_tables=30, rows=160, cols=4, vocab=2000,
                          seed=0, numeric_cols=2)


def _approx_queries(lake):
    t, small = lake.tables[4], min(lake.tables, key=lambda t: t.n_rows)
    cells = [lake.tables[i].columns[i % 2][i] for i in range(30)] * 2
    return {"sc": blend.sc(cells, k=8),
            "sc narrow": blend.sc(list(small.columns[0]), k=1),
            "kw": blend.kw(cells, k=8),
            "corr": blend.corr(list(t.columns[0][:48]),
                               [float(v) for v in t.columns[2][:48]],
                               k=8, h=64)}


def _same_approx(got, want, ctx=""):
    """Two ``query(approx=)`` results agree: ids, scores, launches and
    every ``ApproxInfo`` field but the probe's seconds."""
    _same_result(got, want, ctx)
    assert got.info.launches == want.info.launches, ctx
    a, b = got.approx, want.approx
    for f in ("kind", "estimator", "escalated", "candidates", "threshold",
              "escalated_ids", "fallback"):
        assert getattr(a, f) == getattr(b, f), (ctx, f)
    for f in ("est", "ci_lo", "ci_hi"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{ctx} {f}")


def test_approx_query_on_card_equals_cpu(cuda):
    """A static approximate query at epsilon 0 and 0.05 on the card equals
    the CPU port's: every probe field, ``ApproxInfo``, ids, scores and
    launches; the top-k of the estimates runs on the card (the scores live
    there) and at epsilon 0 the answer is the exact one."""
    lake = _approx_lake()
    card = blend.connect(lake, backend="bucket")
    cpu = blend.connect(lake, backend="sorted", device="cpu")
    branches = set()
    for label, q in _approx_queries(lake).items():
        spec = card.compile(q).plan.nodes[card.compile(q).plan.output].spec
        p, w = card.executor.sketch_probe(spec), \
            cpu.executor.sketch_probe(spec)
        for f in APPROX_PROBE_FIELDS:
            x, y = getattr(p, f), getattr(w, f)
            assert (x is None) == (y is None), (label, f)
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f"{label} {f}")
        for approx in ({"epsilon": 0.0}, {"epsilon": 0.05}):
            for fused in (False, True):
                got = card.query(q, approx=approx, fused=fused)
                assert got.scores.device.type == "cuda", label
                _same_approx(got, cpu.query(q, approx=approx, fused=fused),
                             (label, approx, fused))
                branches.add(bool(got.approx.escalated))
                if approx["epsilon"] == 0.0:
                    _same_result(got, cpu.query(q), (label, "exact"))
    assert branches == {False, True}


def test_sharded_approx_on_card_equals_one_shard(cuda):
    """A 2-shard session (on two cards where present) answers every
    approximate query like a 1-shard session: each probe bit for bit, ids,
    scores and ``ApproxInfo``, the top-k on the merge device."""
    lake = _approx_lake()
    s2 = blend.connect(lake, shards=2, backend="bucket")
    s1 = blend.connect(lake, shards=1, backend="bucket")
    assert len(s2.executor.sketch_views()) == 2
    for label, q in _approx_queries(lake).items():
        spec = s1.compile(q).plan.nodes[s1.compile(q).plan.output].spec
        a, b = s2.executor.sketch_probe(spec), s1.executor.sketch_probe(spec)
        for f in APPROX_PROBE_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), (label, f)
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f"{label} {f}")
        for approx in ({"epsilon": 0.0}, {"epsilon": 0.05}):
            got = s2.query(q, approx=approx)
            assert got.scores.device == s2.executor.devices[0], label
            _same_approx(got, s1.query(q, approx=approx), (label, approx))


def test_cached_approx_hit_records_no_device_kernel(cuda):
    """An approximate request misses, then hits with the same
    ``ApproxInfo``; the hit records no device activity, launches no kernel
    wrapper and builds no program; an exact request of the same query is
    its own entry (``approx`` None)."""
    lake = _approx_lake()
    s = blend.connect(lake, cache=True, backend="bucket")
    for label, q in _approx_queries(lake).items():
        for approx in ({"epsilon": 0.0}, {"epsilon": 0.05}):
            s.cache.clear()
            first = s.query(q, approx=approx)
            assert first.cache.status == "miss", label
            first.ids
            before = ([f.launches for f in QUERY_WRAPPERS],
                      dict(seek.TRACE_COUNTS))
            got = []
            names = _device_events(lambda: got.append(
                s.query(q, approx=approx)))
            assert names == [], (label, approx, names)
            assert ([f.launches for f in QUERY_WRAPPERS],
                    dict(seek.TRACE_COUNTS)) == before, label
            assert all(r.cache.status == "hit" for r in got), label
            assert all(r.approx is first.approx for r in got), label
            _same_result(got[-1], first, label)
            # the exact key holds an entry only where the approximate
            # request ran the exact path
            exact = s.query(q)
            assert exact.approx is None, label
            assert exact.cache.status == (
                "hit" if first.approx.escalated else "miss"), label
