"""repro_torch's CUDA kernels on the card, against their plain versions.

Every test takes the ``cuda`` fixture, which skips without a card.  This file
imports no JAX, so it runs on the H100 machine as it is:
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
from repro_torch.kernels.bucket_probe import ops as bucket_ops
from repro_torch.kernels.bucket_probe.ref import bucket_probe_ref
from repro_torch.kernels.qcr_score import ops as qcr_ops
from repro_torch.kernels.qcr_score.ref import qcr_segments_ref
from repro_torch.kernels.superkey_filter import ops as sk_ops
from repro_torch.kernels.superkey_filter.ref import superkey_filter_rows_ref


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


def test_superkey_kernel_on_card(cuda):
    rng = np.random.default_rng(0)
    for t, m in ((5, 33), (24, 128), (256, 1024)):
        sk = rng.integers(0, 2 ** 32, (2, t, m), dtype=np.uint32)
        q = sk[:, :, 0] & rng.integers(0, 2 ** 32, (2, t), dtype=np.uint32)
        arrays = [_t(a.view(np.int32), cuda) for a in (*sk, *q)]
        got = sk_ops.filter_candidates(*arrays)
        torch.cuda.synchronize()
        assert torch.equal(got, superkey_filter_rows_ref(*arrays))
        assert got.any()


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
