"""The kernel packages' own entry points of repro_torch against the JAX
package: ``superkey_filter.ops.filter_rows``, ``qcr_score.ops.score`` and
``flash_attention.ops.attention``.

On the CPU each wrapper runs its plain PyTorch version.  ``filter_rows`` and
``score`` are held to the Pallas kernels in interpret mode, exactly.  The
Pallas flash kernel does not trace on this JAX (``pl.load``), so
``attention`` is held to the JAX ``attention_ref`` and to the model-side
``chunked_attention``, within the repo's tolerances (2e-5 for f32, 2e-2 for
bf16, ``tests/test_kernels.py``).  The CUDA kernels themselves are held to
these plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.kernels.qcr_score import ops as jax_qcr
from repro.kernels.superkey_filter import ops as jax_sk
from repro.models.attention import chunked_attention
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.qcr_score import ops as qcr_ops
from repro_torch.kernels.superkey_filter import ops as sk_ops

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _i32(a):
    return _t(np.asarray(a, np.uint32).view(np.int32))


def _sk_digests(n, t, seed):
    """Random row digests and queries; half the queries are cut from rows so
    some pairs are contained."""
    rng = np.random.default_rng(seed)
    sk_lo = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
    sk_hi = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
    pick = rng.integers(0, n, t)
    mask = rng.integers(0, 2 ** 32, (2, t), dtype=np.uint32) \
        & rng.integers(0, 2 ** 32, (2, t), dtype=np.uint32)
    q_lo, q_hi = sk_lo[pick] & mask[0], sk_hi[pick] & mask[1]
    q_hi[1::2] = rng.integers(0, 2 ** 32, len(q_hi[1::2]), dtype=np.uint32)
    return sk_lo, sk_hi, q_lo, q_hi


@pytest.mark.parametrize("n,t", [(1024, 4), (3000, 5), (1000, 1)])
def test_filter_rows_matches_pallas(n, t):
    arrays = _sk_digests(n, t, seed=n + t)
    want = np.asarray(jax_sk.filter_rows(*map(jnp.asarray, arrays),
                                         use_kernel=True, interpret=True))
    got = sk_ops.filter_rows(*map(_i32, arrays))
    assert got.dtype == torch.bool and got.shape == (t, n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()
    assert sk_ops.filter_rows.launches == 0          # CPU: plain version


def test_filter_rows_containment():
    """(a | b) contains a: query i is built to lie in row i."""
    rng = np.random.default_rng(7)
    a_lo = rng.integers(0, 2 ** 32, 256, dtype=np.uint32)
    a_hi = rng.integers(0, 2 ** 32, 256, dtype=np.uint32)
    b_lo = rng.integers(0, 2 ** 32, 256, dtype=np.uint32)
    arrays = (a_lo | b_lo, a_hi, a_lo[:4], a_hi[:4])
    got = sk_ops.filter_rows(*map(_i32, arrays))
    want = np.asarray(jax_sk.filter_rows(*map(jnp.asarray, arrays),
                                         use_kernel=True, interpret=True,
                                         t_block=4, n_block=256))
    np.testing.assert_array_equal(got.numpy(), want)
    assert all(bool(got[i, i]) for i in range(4))


def _qcr_inputs(g, h, seed):
    rng = np.random.default_rng(seed)
    quad = rng.integers(0, 2, (g, h)).astype(np.int8)
    qb = rng.integers(0, 2, (g, h)).astype(np.int8)
    val = rng.random((g, h)) < 0.6
    return quad, qb, val


@pytest.mark.parametrize("g,h", [(64, 32), (200, 128), (7, 33)])
def test_score_matches_pallas(g, h):
    arrays = _qcr_inputs(g, h, seed=g + h)
    want = np.asarray(jax_qcr.score(*map(jnp.asarray, arrays),
                                    use_kernel=True, interpret=True,
                                    g_block=64))
    got = qcr_ops.score(*map(_t, arrays))
    assert got.dtype == torch.float32 and got.shape == (g,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).any()
    assert qcr_ops.score.launches == 0               # CPU: plain version


def test_score_all_agree_is_one():
    ones = np.ones((8, 64), np.int8)
    got = qcr_ops.score(_t(ones), _t(ones), _t(ones.astype(bool)))
    want = np.asarray(jax_qcr.score(jnp.asarray(ones), jnp.asarray(ones),
                                    jnp.asarray(ones.astype(bool)),
                                    use_kernel=True, interpret=True,
                                    g_block=8))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), 1.0)


def _qkv(b, sq, skv, h, k, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, sq, h, d)).astype(np.float32),
            rng.normal(0, 1, (b, skv, k, d)).astype(np.float32),
            rng.normal(0, 1, (b, skv, k, d)).astype(np.float32))


def _both(arrays, dtype):
    """The same inputs in torch and in JAX, cast to ``dtype`` in each."""
    return ([_t(a).to(getattr(torch, dtype)) for a in arrays],
            [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               atol=ATOL[dtype])


# (dtype, causal, B, Sq, Skv, H, K, D): G = H / K in {1, 2, 3}, Sq < Skv,
# Sq > Skv (fully masked rows under the causal mask) and Sq = 1
ATTENTION_CASES = [
    ("float32", True, 2, 48, 48, 2, 2, 64),
    ("float32", True, 1, 20, 72, 4, 2, 128),
    ("float32", True, 1, 70, 33, 6, 2, 64),
    ("float32", False, 1, 17, 40, 3, 1, 64),
    ("bfloat16", True, 1, 64, 64, 4, 2, 128),
    ("bfloat16", False, 2, 9, 31, 2, 1, 64),
    ("bfloat16", True, 1, 40, 24, 3, 1, 128),
    ("bfloat16", True, 1, 1, 77, 2, 2, 64),
]


@pytest.mark.parametrize("dtype,causal,b,sq,skv,h,k,d", ATTENTION_CASES)
def test_attention_matches_jax_ref(dtype, causal, b, sq, skv, h, k, d):
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(b, sq, skv, h, k, d, sq + d),
                                       dtype)
    got = fa_ops.attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, jax_attention(jq, jk, jv, causal=causal), dtype)
    assert fa_ops.attention.launches == 0            # CPU: plain version


# (dtype, causal, Sq, Skv, H, K, D): chunked_attention needs whole chunks
# of 32; its q_offset = Skv - Sq is the kernel's bottom-right causal mask
CHUNKED_CASES = [
    ("float32", True, 64, 96, 4, 2, 64),
    ("float32", False, 32, 64, 3, 1, 128),
    ("float32", True, 96, 64, 6, 2, 64),
    ("bfloat16", True, 64, 64, 4, 4, 128),
    ("bfloat16", True, 96, 32, 3, 1, 64),
]


@pytest.mark.parametrize("dtype,causal,sq,skv,h,k,d", CHUNKED_CASES)
def test_attention_matches_chunked_attention(dtype, causal, sq, skv, h, k, d):
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(1, sq, skv, h, k, d, skv + h),
                                       dtype)
    got = fa_ops.attention(tq, tk, tv, causal=causal)
    want = chunked_attention(jq, jk, jv, q_chunk=32, kv_chunk=32,
                             causal=causal, q_offset=skv - sq)
    _close(got, want, dtype)


def test_attention_fully_masked_rows_average_v():
    """Sq > Skv under the causal mask: the first Sq - Skv rows see no key,
    score -1e30 everywhere and come out as the mean of v."""
    tq, tk, tv = map(_t, _qkv(1, 12, 5, 2, 1, 64, 0))
    got = fa_ops.attention(tq, tk, tv, causal=True)
    mean_v = tv.mean(dim=1, keepdim=True).repeat_interleave(2, dim=2)
    torch.testing.assert_close(got[:, :7], mean_v.expand(1, 7, 2, 64),
                               atol=2e-5, rtol=0)
    assert torch.isfinite(got).all()


def test_entry_wrappers_reject_bad_inputs():
    lo = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        sk_ops.filter_rows(lo.long(), lo, lo[:2], lo[:2])
    with pytest.raises(ValueError, match="\\[T\\]"):
        sk_ops.filter_rows(lo, lo, lo[:2], lo[:3])
    with pytest.raises(ValueError, match="\\[N\\]"):
        sk_ops.filter_rows(lo.view(4, 4), lo.view(4, 4), lo[:2], lo[:2])
    quad = torch.zeros((4, 8), dtype=torch.int8)
    valid = torch.zeros((4, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="int8"):
        qcr_ops.score(quad.int(), quad, valid)
    with pytest.raises(ValueError, match="bool"):
        qcr_ops.score(quad, quad, quad)
    with pytest.raises(ValueError, match="shape"):
        qcr_ops.score(quad, quad[:3], valid)
    q = torch.zeros((1, 4, 4, 64))
    kv = torch.zeros((1, 6, 2, 64))
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.attention(q[..., :32], kv[..., :32], kv[..., :32])
    with pytest.raises(ValueError, match="f32 or bf16"):
        fa_ops.attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="f32 or bf16"):
        fa_ops.attention(q, kv.bfloat16(), kv.bfloat16())
    with pytest.raises(ValueError, match="multiple"):
        fa_ops.attention(torch.zeros((1, 4, 3, 64)), kv, kv)
    with pytest.raises(ValueError, match="shape"):
        fa_ops.attention(q, kv, kv[:, :5])
    with pytest.raises(ValueError, match="devices|device"):
        fa_ops.attention(q, kv, kv.to("meta"))
    assert sk_ops.filter_rows.launches == qcr_ops.score.launches == \
        fa_ops.attention.launches == 0
