"""repro_torch's CUDA kernels on the card, against their plain versions.

Every kernel test takes the ``cuda`` fixture, which skips without a card;
the default-device test runs everywhere.  This file imports no JAX, so it
runs on the H100 machine as it is:
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import repro_torch as blend
from repro_torch.core.executor import Executor
from repro_torch.core.hashing import MISSING
from repro_torch.core.index import build_index, hash_keys
from repro_torch.core.lake import synthetic_lake
from repro_torch.core.match import MatchEngine
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
    assert eng.bucket_hashes.is_cuda
    assert all(t.is_cuda for t in eng.dev.values() if torch.is_tensor(t))
