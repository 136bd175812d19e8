"""AdamW with configurable state dtype + optional gradient compression.

State dtype matters at scale: the 480B-param MoE cell keeps the second moment
in bf16.  The compression hook implements int8 quantization with error
feedback (1-bit-Adam-style residual accumulation) for cross-pod gradient
reduction.

The JAX package's ``train/optim.py`` on torch.  The state has the JAX
package's tree layout (``m`` and ``v`` mirror the parameter tree, a
factored leaf of ``v`` is ``{"vr", "vc"}``, ``step`` is a 0-d int32), so a
checkpoint's paths are the same in both packages.  Where the JAX package
returns new arrays (and its launcher donates the old ones),
``adamw_update`` writes the parameters and the state in place under
``torch.no_grad()`` and returns the same trees; every product is taken in
f32, as there, with the bias corrections ``b ** t`` computed in f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.layers import dtype_of


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"
    factored: bool = False   # Adafactor-style factored second moment (>=2D)


def _is_factored(p, cfg) -> bool:
    # factor only genuinely-2D weight matrices (skip stacked norms/gates where
    # one of the trailing dims is small)
    return cfg.factored and p.ndim >= 2 and min(p.shape[-1], p.shape[-2]) >= 128


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` are trees of the
    same keys, walked alongside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def adamw_init(params, cfg: AdamWConfig):
    dt = dtype_of(cfg.state_dtype)

    def zeros(shape, p):
        return torch.zeros(shape, dtype=dt, device=p.device)

    def v_init(p):
        if _is_factored(p, cfg):
            return {"vr": zeros(p.shape[:-1], p),
                    "vc": zeros(p.shape[:-2] + p.shape[-1:], p)}
        return zeros(p.shape, p)

    device = next(iter(_leaves(params))).device
    return {"m": tree_map(lambda p: zeros(p.shape, p), params),
            "v": tree_map(v_init, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: AdamWConfig):
    """One AdamW step: ``params`` and ``opt_state`` are updated in place
    and returned (the JAX package returns new trees)."""
    opt_state["step"] += 1
    t = opt_state["step"].float()
    f32 = dict(dtype=torch.float32, device=t.device)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, **f32), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, **f32), t)
    dt = dtype_of(cfg.state_dtype)

    def upd(p, g, m, v):
        g32 = g.float()
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        mhat = m32 / bc1
        if _is_factored(p, cfg):
            g2 = torch.square(g32) + 1e-30
            vr = cfg.b2 * v["vr"].float() + (1 - cfg.b2) * \
                torch.mean(g2, dim=-1)
            vc = cfg.b2 * v["vc"].float() + (1 - cfg.b2) * \
                torch.mean(g2, dim=-2)
            denom = torch.mean(vr, dim=-1, keepdim=True)
            vhat = (vr[..., None] * vc[..., None, :]) / \
                torch.clamp(denom[..., None], min=1e-30) / bc2
            v["vr"].copy_(vr.to(dt))
            v["vc"].copy_(vc.to(dt))
        else:
            v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g32)
            vhat = v32 / bc2
            v.copy_(v32.to(dt))
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * \
            p.float()
        p.copy_((p.float() - cfg.lr * delta).to(p.dtype))
        m.copy_(m32.to(dt))

    # walked by the parameters' structure, so a factored v leaf (a dict)
    # reaches ``upd`` whole
    tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    return params, opt_state


# --------------------------------------------------------------------------
# gradient compression (int8 + error feedback) — cross-pod reduction trick
# --------------------------------------------------------------------------

def compress_int8(g, residual):
    """Quantize g+residual to int8 with a per-tensor scale; returns
    (q, scale, new_residual)."""
    x = g.float() + residual
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, x - deq


def decompress_int8(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def compressed_grads(grads, residuals):
    """Apply int8+error-feedback compression leaf-wise; returns (grads',
    residuals').  Used on the cross-pod (slow-link) reduction path."""
    out = tree_map(compress_int8, grads, residuals)
    deq = tree_map(lambda g, o: decompress_int8(o[0], o[1], g.dtype), grads,
                   out)
    return deq, tree_map(lambda _g, o: o[2], grads, out)
