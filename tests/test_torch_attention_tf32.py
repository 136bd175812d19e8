"""The f32 attention kernel's precision scheme, emulated on the CPU.

``csrc/flash_attention.cu`` computes f32 attention on the tensor cores as
3xTF32: each operand x is split into ``hi = tf32(x)`` and
``lo = tf32(x - hi)``, both rounded to nearest with ties away from zero
(``cvt.rna``'s rounding, which the kernel also takes by integer operations),
and a product is summed as ``a_lo b_hi + a_hi b_lo + a_hi b_hi``.  The
kernel runs only on the card, so this file repeats its arithmetic in plain
PyTorch (the same TF32 rounding, the three-term products, the online
softmax in the log2 domain over 64-key tiles, each tile's P V added to the
running output in f32) and holds it to the JAX ``attention_ref`` within the
repo's f32 tolerance, 2e-5.  A second test shows that a truncated split,
which is what ``wgmma`` fed raw f32 would give, is further from the exact
result than the rounded one.

The emulation is no plain version of the kernel: nothing but these tests
calls it.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention

KEYS = 64                      # keys of the kernel's K/V tile
LOG2E = 1.4426950408889634
MASKED = -1e30
TF32_DROP = 0x1FFF             # the 13 mantissa bits TF32 does not keep
YI_6B = (32, 4, 128)
SMOLLM_360M = (15, 5, 64)


def tf32_rna(x):
    """f32 -> TF32 to nearest, ties away from zero: add half of the last
    kept bit to the magnitude bits, then clear the dropped ones."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~TF32_DROP).view(torch.float32)


def tf32_trunc(x):
    """f32 -> TF32 by dropping the low bits, as wgmma reads raw f32."""
    return (x.contiguous().view(torch.int32) & ~TF32_DROP).view(torch.float32)


def mm_3xtf32(a, b, rnd):
    """a @ b from TF32 parts: a_lo b_hi + a_hi b_lo + a_hi b_hi, each TF32
    product exact (22-bit mantissas), summed and rounded to f32."""
    a_hi = rnd(a)
    b_hi = rnd(b)
    a_lo = rnd(a - a_hi)
    b_lo = rnd(b - b_hi)
    f = torch.float64
    s = a_lo.to(f) @ b_hi.to(f) + a_hi.to(f) @ b_lo.to(f) \
        + a_hi.to(f) @ b_hi.to(f)
    return s.to(torch.float32)


def emulate(q, k, v, causal, rnd):
    """The kernel's arithmetic on f32 q [B, Sq, H, D], k/v [B, Skv, K, D]."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    qh = q.permute(0, 2, 1, 3)                            # [B, H, Sq, D]
    kv_head = torch.arange(h) // g
    kh_ = k.permute(0, 2, 1, 3)[:, kv_head]               # [B, H, Skv, D]
    vh = v.permute(0, 2, 1, 3)[:, kv_head]
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    m = torch.full((b, h, sq, 1), MASKED)
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, d))
    for j0 in range(0, skv, KEYS):
        kt = kh_[:, :, j0:j0 + KEYS]
        x = mm_3xtf32(qh, kt.transpose(-1, -2), rnd) * scale
        key = torch.arange(j0, j0 + kt.shape[2])[None, :]
        if causal:
            x = x.masked_fill(qpos < key, MASKED)
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2(m - mx)
        p = torch.exp2(x - mx)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + mm_3xtf32(p, vh[:, :, j0:j0 + KEYS], rnd)
        m = mx
    o = o / torch.where(l == 0, 1.0, l)
    return o.permute(0, 2, 1, 3).contiguous()


def exact(q, k, v, causal):
    """The same attention in float64 with numpy."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    qg = q.astype(np.float64).reshape(b, sq, kh, h // kh, d)
    s = np.einsum("bqhgd,bshd->bhgqs", qg, k.astype(np.float64)) / np.sqrt(d)
    if causal:
        s = np.where(np.tril(np.ones((sq, skv), bool), skv - sq), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    o = np.einsum("bhgqs,bshd->bqhgd", p, v.astype(np.float64))
    return o.reshape(b, sq, h, d)


def _qkv(sq, skv, widths, seed):
    h, kh, d = widths
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((1, sq, h, d), (1, skv, kh, d),
                               (1, skv, kh, d)))


@pytest.mark.parametrize("widths", [YI_6B, SMOLLM_360M],
                         ids=["yi-6b", "smollm-360m"])
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_matches_jax_ref(widths, causal):
    # S = 300 crosses the kernel's 64-key tiles and its 128-query tiles
    arrays = _qkv(300, 300, widths, seed=widths[2] + causal)
    got = emulate(*map(torch.from_numpy, arrays), causal, tf32_rna)
    want = np.asarray(jax_attention(*map(jnp.asarray, arrays),
                                    causal=causal))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_3xtf32_fully_masked_rows_match_jax_ref():
    # Sq > Skv: the first Sq - Skv rows see no key and average v
    arrays = _qkv(150, 70, YI_6B, seed=3)
    got = emulate(*map(torch.from_numpy, arrays), True, tf32_rna)
    want = np.asarray(jax_attention(*map(jnp.asarray, arrays), causal=True))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("widths", [YI_6B, SMOLLM_360M],
                         ids=["yi-6b", "smollm-360m"])
def test_truncated_split_is_less_accurate(widths):
    arrays = _qkv(300, 300, widths, seed=7)
    truth = exact(*arrays, causal=True)
    err = {name: np.abs(emulate(*map(torch.from_numpy, arrays), True, rnd)
                        .numpy() - truth).max()
           for name, rnd in (("rna", tf32_rna), ("trunc", tf32_trunc))}
    assert err["trunc"] > 2 * err["rna"], err
