"""GQA attention: chunked (flash-style) training/prefill path + decode path.

The JAX package's ``models/attention.py`` on torch.  The training and
prefill path is a plain-torch blockwise online softmax (Python loops over
query and key/value chunks in place of ``lax.scan``), so it never
materializes the [S, S] score matrix.  Like the JAX package's LM, which
calls ``chunked_attention`` and never its Pallas flash kernel, this path
launches no hand-written kernel: its products are ``torch.einsum`` /
``torch.bmm``.

Baseline causality is mask-based (fully-masked kv blocks are still
computed).  ``block_skip=True`` switches to the triangular schedule that
only visits j <= i blocks.

Left out, because they mean nothing without a device mesh: the sharding
hooks ``maybe_constrain``, ``_heads_factorizable`` and ``_constrain_blocks``
(context-parallel pinning of the query-chunk dim).  They come with
ROADMAP queue A, item A8d.  Each ``jax.checkpoint`` around a scan step
is ``layers.checkpoint`` here (``torch.utils.checkpoint`` without
reentry, a plain call without autograd): each query chunk and, inside
it, each key/value step of the rectangular schedule, and each block pair
of the triangular one, so the backward pass recomputes the score tiles
instead of keeping a [B, K, G, Tq, Tk] residual per block.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope, checkpoint, dense_init

NEG_INF = -1e30


def init_attention(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   dtype, device):
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype, device),
        "wk": dense_init(gen, d_model, n_kv * head_dim, dtype, device),
        "wv": dense_init(gen, d_model, n_kv * head_dim, dtype, device),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, device),
    }


def _qkv(params, x, n_heads, n_kv, head_dim, positions, rope_theta):
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(B, S, n_kv, head_dim)
    v = (x @ params["wv"]).reshape(B, S, n_kv, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def chunked_attention(q, k, v, *, q_chunk: int, kv_chunk: int, causal: bool,
                      q_offset=0, kv_lens=None, block_skip: bool = False):
    """Online-softmax blockwise attention.

    q: [B, Sq, H, D]; k/v: [B, Skv, K, D] with H = K*G (GQA).
    q_offset: global position of q[0] (prefill continuation / decode).
    kv_lens: optional [B] valid kv lengths (padding mask).
    Returns [B, Sq, H, D].
    """
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    assert nq * q_chunk == Sq and nk * kv_chunk == Skv, "seq must divide chunks"
    scale = 1.0 / torch.sqrt(torch.tensor(float(D), device=q.device))

    qb = q.reshape(B, nq, q_chunk, K, G, D).permute(1, 0, 3, 4, 2, 5)  # [nq,B,K,G,Tq,D]
    kb = k.reshape(B, nk, kv_chunk, K, D).permute(1, 0, 3, 2, 4)       # [nk,B,K,Tk,D]
    vb = v.reshape(B, nk, kv_chunk, K, D).permute(1, 0, 3, 2, 4)
    if block_skip and causal:
        out = _triangular_attention(qb, kb, vb, scale, q_chunk, kv_chunk,
                                    q_offset, kv_lens)
    else:
        out = _rect_attention(qb, kb, vb, scale, q_chunk, kv_chunk, causal,
                              q_offset, kv_lens)
    # out: [nq, B, K, G, Tq, D] -> [B, Sq, H, D]
    return out.permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, H, D)


def _block(q_blk, k_blk, v_blk, m, l, acc, qi, kj, scale, q_chunk, kv_chunk,
           causal, q_offset, kv_lens):
    """One online-softmax update.  q_blk [B,K,G,Tq,D]; k/v [B,K,Tk,D]."""
    dev = q_blk.device
    s = torch.einsum("bkgqd,bktd->bkgqt", q_blk.float(),
                     k_blk.float()) * scale
    qpos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
    kpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
    mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=dev)
    if causal:
        mask = qpos[:, None] >= kpos[None, :]
    if kv_lens is not None:
        mask = mask[None] & (kpos[None, None, :] < kv_lens[:, None, None])
        mask = mask[:, None, None]          # [B,1,1,Tq,Tk]
    else:
        mask = mask[None, None, None]       # [1,1,1,Tq,Tk]
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p, dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bkgqt,bktd->bkgqd", p, v_blk.float())
    return m_new, l_new, acc_new


def _finish(m, l, acc, dtype):
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l[..., None]).to(dtype)


def _init_state(shape, D, device):
    m = torch.full(shape, NEG_INF, dtype=torch.float32, device=device)
    l = torch.zeros(shape, dtype=torch.float32, device=device)
    acc = torch.zeros((*shape, D), dtype=torch.float32, device=device)
    return m, l, acc


def _rect_attention(qb, kb, vb, scale, q_chunk, kv_chunk, causal, q_offset,
                    kv_lens):
    nq, B, K, G, Tq, D = qb.shape
    nk = kb.shape[0]

    def per_q(qi, q_blk):
        m, l, acc = _init_state((B, K, G, Tq), D, qb.device)
        for kj in range(nk):
            # remat: recompute scores/probs/mask in bwd instead of saving
            # the [B,K,G,Tq,Tk] residuals per block
            m, l, acc = checkpoint(_block, q_blk, kb[kj], vb[kj], m, l, acc,
                                   qi, kj, scale, q_chunk, kv_chunk, causal,
                                   q_offset, kv_lens)
        return _finish(m, l, acc, qb.dtype)

    return torch.stack([checkpoint(per_q, qi, qb[qi]) for qi in range(nq)])


def _triangular_attention(qb, kb, vb, scale, q_chunk, kv_chunk, q_offset,
                          kv_lens):
    """Causal-only schedule visiting exactly the j <= i block pairs, in the
    JAX package's order (grouped by q block, so the online-softmax updates
    stay ordered).  Requires q_chunk == kv_chunk; ~halves attention FLOPs
    against the rectangular schedule."""
    nq, B, K, G, Tq, D = qb.shape
    nk = kb.shape[0]
    assert nq == nk and q_chunk == kv_chunk, "block_skip needs equal chunks"
    out = []
    for i in range(nq):
        m, l, acc = _init_state((B, K, G, Tq), D, qb.device)
        for j in range(i + 1):
            m, l, acc = checkpoint(_block, qb[i], kb[j], vb[j], m, l, acc,
                                   i, j, scale, q_chunk, kv_chunk, True,
                                   q_offset, kv_lens)
        out.append(_finish(m, l, acc, qb.dtype))
    return torch.stack(out)


def attention_train(params, x, *, n_heads, n_kv, head_dim, rope_theta,
                    q_chunk, kv_chunk, causal=True, block_skip=False):
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(params, x, n_heads, n_kv, head_dim, positions, rope_theta)
    out = chunked_attention(q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk,
                            causal=causal, block_skip=block_skip)
    return out.reshape(B, S, n_heads * head_dim) @ params["wo"]


def attention_prefill(params, x, *, n_heads, n_kv, head_dim, rope_theta,
                      q_chunk, kv_chunk, block_skip=False):
    """Like train but also returns the (k, v) cache contents."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(params, x, n_heads, n_kv, head_dim, positions, rope_theta)
    out = chunked_attention(q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk,
                            causal=True, block_skip=block_skip)
    return out.reshape(B, S, n_heads * head_dim) @ params["wo"], (k, v)


def decode_qkv(params, x_t, pos, *, n_heads, n_kv, head_dim, rope_theta):
    """Single-token q/k/v for decode.  x_t: [B, D]; pos: [B]."""
    B = x_t.shape[0]
    q = (x_t @ params["wq"]).reshape(B, 1, n_heads, head_dim)
    k = (x_t @ params["wk"]).reshape(B, 1, n_kv, head_dim)
    v = (x_t @ params["wv"]).reshape(B, 1, n_kv, head_dim)
    q = apply_rope(q, pos[:, None], rope_theta)
    k = apply_rope(k, pos[:, None], rope_theta)
    return q, k, v


def _bmm_f32(a, b):
    """``a @ b`` (batched) accumulated and returned in f32, without an f32
    copy of ``b``: ``preferred_element_type=jnp.float32``.  bf16 on the card
    asks cuBLAS for an f32 output; the CPU has no such ``bmm``, and there
    the operands are widened (the same products and f32 sums)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def decode_scores(params, q, cache_k, cache_v, pos, *, n_heads, n_kv,
                  head_dim, dtype):
    """Attention read over a (layer-sliced) cache.  q: [B,1,H,D];
    cache_k/v: [B,T,K,D] with the CURRENT token already written."""
    B, T = cache_k.shape[0], cache_k.shape[1]
    K = n_kv
    G = n_heads // K
    qg = q.reshape(B * K, G, head_dim)
    # accumulate in f32 WITHOUT materializing an f32 copy of the cache
    ck = cache_k.permute(0, 2, 3, 1).reshape(B * K, head_dim, T)
    s = _bmm_f32(qg, ck).reshape(B, K, G, T) / head_dim ** 0.5
    valid = torch.arange(T, device=q.device)[None, :] <= pos[:, None]  # [B, T]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    cv = cache_v.permute(0, 2, 1, 3).reshape(B * K, T, head_dim)
    o = _bmm_f32(p.reshape(B * K, G, T).to(cache_v.dtype), cv)
    o = o.reshape(B, n_heads * head_dim).to(dtype)
    return o @ params["wo"]


def attention_decode(params, x_t, cache_k, cache_v, pos, *, n_heads, n_kv,
                     head_dim, rope_theta):
    """One decode step over a per-layer cache (compat path; the lm decode
    loop uses decode_qkv/decode_scores with full-stack in-place updates).
    The token's k/v are written into ``cache_k`` / ``cache_v`` in place at
    ``pos[0]``, and the same tensors are returned."""
    q, k, v = decode_qkv(params, x_t, pos, n_heads=n_heads, n_kv=n_kv,
                         head_dim=head_dim, rope_theta=rope_theta)
    at = pos[:1].long()
    cache_k.index_copy_(1, at, k.to(cache_k.dtype))
    cache_v.index_copy_(1, at, v.to(cache_v.dtype))
    out = decode_scores(params, q, cache_k, cache_v, pos, n_heads=n_heads,
                        n_kv=n_kv, head_dim=head_dim, dtype=x_t.dtype)
    return out, cache_k, cache_v
