"""The three kernels of repro_torch against the JAX package's kernels.

On the CPU each wrapper runs its plain PyTorch version; these are held to
the JAX reference (``bucket_probe_ref``, whose Pallas kernel does not trace
on this JAX) and to the Pallas kernels in interpret mode, with exact
equality.  The CUDA kernels themselves are held to these plain versions
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import build_index as ref_build_index
from repro.core.lake import synthetic_lake
from repro.kernels.bucket_probe.ref import bucket_probe_ref as jax_probe_ref
from repro.kernels.qcr_score import ops as jax_qcr
from repro.kernels.superkey_filter import ops as jax_sk
from repro_torch.core.hashing import MISSING
from repro_torch.core.index import hash_keys
from repro_torch.kernels.bucket_probe import ops as bucket_ops
from repro_torch.kernels.qcr_score import ops as qcr_ops
from repro_torch.kernels.superkey_filter import ops as sk_ops


def _layout(seed, bits):
    """A real padded bucket layout plus hit / miss / sentinel queries."""
    idx = ref_build_index(synthetic_lake(n_tables=20, rows=16, vocab=120,
                                         seed=seed), bucket_bits=bits)
    width = -(-idx.max_bucket_count() // 32) * 32
    bh, bp, ovf = idx.padded_buckets(width)
    assert ovf == 0
    rng = np.random.default_rng(seed)
    q = np.concatenate([rng.choice(idx.cell_hash, 40),
                        rng.integers(0, 2 ** 32, 20, dtype=np.uint32),
                        np.full(5, MISSING, np.uint32)]).astype(np.uint32)
    return bh, bp, q


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed,bits", [(0, 12), (1, 5), (2, 8)])
def test_bucket_probe_matches_jax_ref(seed, bits):
    bh, bp, q = _layout(seed, bits)
    want = np.asarray(jax_probe_ref(jnp.asarray(bh), jnp.asarray(bp),
                                    jnp.asarray(q), bits))
    before = bucket_ops.probe.launches
    got = bucket_ops.probe(_t(hash_keys(bh)), _t(bp), _t(hash_keys(q)), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any() and (want[-5:] == -1).all()
    assert bucket_ops.probe.launches == before       # CPU: plain version


def _sk_inputs(t, m):
    rng = np.random.default_rng(t * 10 + m)
    sk_lo = rng.integers(0, 2 ** 32, (t, m), dtype=np.uint32)
    sk_hi = rng.integers(0, 2 ** 32, (t, m), dtype=np.uint32)
    q_lo = sk_lo[:, 0] & rng.integers(0, 2 ** 32, t, dtype=np.uint32)
    q_hi = sk_hi[:, 0] & rng.integers(0, 2 ** 32, t, dtype=np.uint32)
    q_hi[::3] = rng.integers(0, 2 ** 32, len(q_hi[::3]), dtype=np.uint32)
    return sk_lo, sk_hi, q_lo, q_hi


@pytest.mark.parametrize("t,m", [(8, 64), (24, 128), (5, 32)])
def test_superkey_rows_matches_pallas(t, m):
    arrays = _sk_inputs(t, m)
    want = np.asarray(jax_sk.filter_candidates(
        *map(jnp.asarray, arrays), use_kernel=True, interpret=True,
        t_block=4))
    got = sk_ops.filter_candidates(*(_t(a.view(np.int32)) for a in arrays))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def _qcr_inputs(d):
    rng = np.random.default_rng(d)
    n_all = rng.integers(0, 12, d).astype(np.float32)
    n_agree = np.minimum(rng.integers(0, 12, d), n_all).astype(np.float32)
    return n_agree, n_all


@pytest.mark.parametrize("d", [128, 2048, 5000])
def test_qcr_segments_matches_pallas(d):
    n_agree, n_all = _qcr_inputs(d)
    want = np.asarray(jax_qcr.score_segments(
        jnp.asarray(n_agree), jnp.asarray(n_all), use_kernel=True,
        interpret=True, d_block=128))
    got = qcr_ops.score_segments(_t(n_agree), _t(n_all))
    np.testing.assert_array_equal(got.numpy(), want)
    # another support floor, against the JAX plain version
    got1 = qcr_ops.score_segments(_t(n_agree), _t(n_all), min_support=1)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(
        jax_qcr.score_segments(jnp.asarray(n_agree), jnp.asarray(n_all),
                               min_support=1)))


def test_wrappers_reject_bad_inputs():
    bh, bp, q = _layout(0, 6)
    kh, kq = _t(hash_keys(bh)), _t(hash_keys(q))
    with pytest.raises(ValueError, match="int32"):
        bucket_ops.probe(kh.to(torch.int64), _t(bp), kq, 6)
    with pytest.raises(ValueError, match="2\\^bucket_bits"):
        bucket_ops.probe(kh, _t(bp), kq, 7)
    with pytest.raises(ValueError, match="devices|device"):
        bucket_ops.probe(kh, _t(bp), kq.to("meta"), 6)
    lo = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="\\[T\\]"):
        sk_ops.filter_candidates(lo, lo, lo[:3, 0], lo[:3, 0])
    with pytest.raises(ValueError, match="f32"):
        qcr_ops.score_segments(torch.zeros(4, dtype=torch.float64),
                               torch.zeros(4, dtype=torch.float64))
