"""Decoder-only LM, the ``dense`` family (smollm-360m, yi-6b, olmo-1b,
minitron-8b).

The JAX package's ``models/lm.py`` on torch, as plain functions over a
dict of tensors with the JAX package's keys: the layer stack's parameters
are stacked on a leading ``L`` axis, and ``lax.scan`` over the layers
becomes a Python loop over that axis.  A tree from the JAX package carries
across leaf by leaf (``registry.params_from_numpy``).  The vocabulary is
padded to a multiple of 128, as there.

Training: ``lm_loss`` and ``chunked_ce_loss`` run under autograd, and each
``jax.checkpoint`` of the JAX package is ``layers.checkpoint`` here
(``torch.utils.checkpoint`` without reentry): the layer body when
``cfg.remat``, and each cross-entropy chunk.  ``forward_hidden`` unbinds
the stacked leaves once (``unstack``), so the backward pass stacks each
leaf's gradient once.  Serving: ``prefill`` and ``decode_step`` run under
``torch.inference_mode()``, and ``decode_step`` writes the token's keys
and values into the cache's buffers in place (the JAX engine donates the
cache).  The ``moe``, ``ssm``, ``hybrid``, ``vlm`` and ``audio`` families
come with ROADMAP queue A, item A8b, and until then every entry point
raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_norm, checkpoint, dense_init,
                                       dtype_of, embed_init, norm_param,
                                       swiglu)

_FAMILIES = ("dense",)


def check_family(cfg):
    """Raise for a family the port does not serve yet."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family comes with ROADMAP "
            "queue A, item A8b; the port serves the dense family")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, dtype, device):
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device),
    }


def mlp_apply(params, x):
    return swiglu(x @ params["w_gate"], x @ params["w_up"]) @ params["w_down"]


def _init_layer(cfg, gen, device):
    dtype = dtype_of(cfg.dtype)
    return {"norm1": norm_param(cfg.d_model, cfg.norm_type, dtype, device),
            "norm2": norm_param(cfg.d_model, cfg.norm_type, dtype, device),
            "attn": attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.head_dim, dtype,
                                        device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer(layers, i: int):
    """Layer ``i``'s parameters out of the stacked tree (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def unstack(layers, n: int) -> list:
    """The stacked tree as ``n`` per-layer trees, one ``unbind`` per leaf:
    its backward pass stacks the layers' gradients once, where a view per
    layer (``layer``) would allocate the whole stacked shape for each."""
    parts = {k: unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
             for k, v in layers.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def init_lm(cfg, gen, *, device):
    """Random parameters from ``gen`` (a ``torch.Generator`` on ``device``;
    ``None`` with ``device="meta"`` for the shapes alone)."""
    check_family(cfg)
    dtype = dtype_of(cfg.dtype)
    with torch.no_grad():
        params = {
            "tok_embed": embed_init(gen, cfg.vocab_padded, cfg.d_model,
                                    dtype, device),
            "layers": _stack([_init_layer(cfg, gen, device)
                              for _ in range(cfg.n_layers)]),
            "final_norm": norm_param(cfg.d_model, cfg.norm_type, dtype,
                                     device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_padded,
                                           dtype, device)
    return params


# --------------------------------------------------------------------------
# blocks (full-sequence path)
# --------------------------------------------------------------------------

def _attn_block_train(lp, x, cfg, collect_kv=False):
    h = apply_norm(x, lp["norm1"], cfg.norm_type)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
              rope_theta=cfg.rope_theta, q_chunk=cfg.q_chunk,
              kv_chunk=cfg.kv_chunk, block_skip=cfg.causal_block_skip)
    if collect_kv:
        a, kv = attn.attention_prefill(lp["attn"], h, **kw)
    else:
        a, kv = attn.attention_train(lp["attn"], h, **kw), None
    x = x + a
    h = apply_norm(x, lp["norm2"], cfg.norm_type)
    return x + mlp_apply(lp["mlp"], h), {}, kv


def forward_hidden(params, cfg, x, collect_caches=False):
    """Run the layer stack on embedded input x [B,S,D].

    Returns (hidden, aux, caches): ``aux`` is empty for the dense family,
    and ``caches`` is ``(k, v)`` stacked along the leading layer axis
    ([L, B, S, K, hd] each) when requested, else None.
    """
    check_family(cfg)
    ks, vs = [], []
    for lp in unstack(params["layers"], cfg.n_layers):
        if cfg.remat:
            x, _, kv = checkpoint(_attn_block_train, lp, x, cfg,
                                  collect_caches)
        else:
            x, _, kv = _attn_block_train(lp, x, cfg,
                                         collect_kv=collect_caches)
        if collect_caches:
            ks.append(kv[0])
            vs.append(kv[1])
    caches = (torch.stack(ks), torch.stack(vs)) if collect_caches else None
    return x, {}, caches


def embed_tokens(params, cfg, tokens):
    return params["tok_embed"][tokens]


def logits_fn(params, cfg, hidden):
    h = apply_norm(hidden, params["final_norm"], cfg.norm_type)
    w = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w


def chunked_ce_loss(params, cfg, hidden, labels, mask, chunk: int = 512):
    """Cross-entropy over the (padded) vocab, a loop over sequence chunks so
    the [B, S, V] logits tensor never fully materializes: each chunk is
    checkpointed, so the backward pass recomputes its logits too."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    n = S // chunk
    rem = S - n * chunk

    def one(h_blk, y_blk, m_blk):
        logits = logits_fn(params, cfg, h_blk).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y_blk[..., None].long())[..., 0]
        return torch.sum((lse - gold) * m_blk), torch.sum(m_blk)

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n)]
    if rem:
        bounds.append((n * chunk, S))
    for lo, hi in bounds:
        s, c = checkpoint(one, hidden[:, lo:hi], labels[:, lo:hi],
                          mask[:, lo:hi])
        tot, cnt = tot + s, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, cfg, batch):
    """Next-token cross-entropy of ``batch["tokens"]`` [B, S] (the last
    position predicts nothing) and the aux dict (empty for the dense
    family)."""
    check_family(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens)
    hidden, aux, _ = forward_hidden(params, cfg, x)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    loss = chunked_ce_loss(params, cfg, hidden, labels, mask)
    return loss, aux


# --------------------------------------------------------------------------
# decode path
# --------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, *, device):
    """Decode cache (stacked along the leading layer axis)."""
    check_family(cfg)
    dtype = dtype_of(cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


@torch.inference_mode()
def decode_step(params, cfg, cache, token):
    """One greedy decode step.  token: [B] int32 -> (new_cache, logits [B, V]).

    The token's keys and values are written into ``cache["k"]`` /
    ``cache["v"]`` in place, one position per layer, so the new cache holds
    the same buffers (the JAX package carries them through the scan and its
    engine donates them); ``pos`` stays a 0-d int32 tensor on the device.
    """
    check_family(cfg)
    pos = cache["pos"]
    x = params["tok_embed"][token]                                 # [B, D]
    B = x.shape[0]
    akw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
               rope_theta=cfg.rope_theta)
    posv = pos.expand(B)
    at = pos.reshape(1).long()
    k_all, v_all = cache["k"], cache["v"]
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        h = apply_norm(x, lp["norm1"], cfg.norm_type)
        q, k, v = attn.decode_qkv(lp["attn"], h, posv, **akw)
        ck, cv = k_all[i], v_all[i]
        ck.index_copy_(1, at, k.to(ck.dtype))
        cv.index_copy_(1, at, v.to(cv.dtype))
        a = attn.decode_scores(lp["attn"], q, ck, cv, posv,
                               n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                               head_dim=cfg.head_dim, dtype=h.dtype)
        x = x + a
        h = apply_norm(x, lp["norm2"], cfg.norm_type)
        x = x + mlp_apply(lp["mlp"], h)
    new_cache = {"k": k_all, "v": v_all, "pos": pos + 1}
    logits = logits_fn(params, cfg, x[:, None, :])[:, 0]
    return new_cache, logits


# --------------------------------------------------------------------------
# prefill path (inference-prefill shape): build the cache for a full prompt
# --------------------------------------------------------------------------

@torch.inference_mode()
def prefill(params, cfg, tokens, max_len: int):
    """Returns (cache at position S, last-token logits [B, V])."""
    check_family(cfg)
    B, S = tokens.shape
    if max_len < S:
        raise ValueError(f"max_len {max_len} is shorter than the prompt {S}")
    x = embed_tokens(params, cfg, tokens)
    hidden, _, (ks, vs) = forward_hidden(params, cfg, x, collect_caches=True)
    pad = (0, 0, 0, 0, 0, max_len - S)
    cache = {"k": torch.nn.functional.pad(ks, pad),
             "v": torch.nn.functional.pad(vs, pad),
             "pos": torch.tensor(S, dtype=torch.int32, device=tokens.device)}
    last = logits_fn(params, cfg, hidden[:, -1:, :])[:, 0]
    return cache, last
