"""Train / serve step builders: the JAX package's ``train/step.py`` on
torch.

``make_train_step``'s step takes gradients with ``torch.autograd.grad`` of
``registry.loss_fn`` at detached aliases of the parameters (so the state's
tensors need no ``requires_grad`` and are never part of a graph), with
``grad_accum`` microbatching as there (gradients summed in the parameter
dtype, then divided by the count), and updates the state in place through
``adamw_update``: where the JAX launcher donates the state to a jitted
step, the port's step returns the same tensors.  ``state_from_numpy``
carries a whole train state across from the JAX package, leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.index import resolve_device
from repro_torch.models import lm, registry
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update, \
    tree_map


def make_train_state(cfg, gen, opt_cfg: AdamWConfig | None = None, *,
                     device=None):
    """Parameters drawn from ``gen`` (a ``torch.Generator`` on ``device``,
    the card unless ``device="cpu"``) and a zero AdamW state."""
    opt_cfg = opt_cfg or _default_opt(cfg)
    params = registry.init_params(cfg, gen, device=device)
    return {"params": params, "opt": adamw_init(params, opt_cfg)}


def train_state_specs(cfg, opt_cfg: AdamWConfig | None = None):
    """The train state's shapes and dtypes, allocated nowhere (on the
    ``meta`` device: ``jax.eval_shape`` of ``make_train_state``)."""
    return make_train_state(cfg, None, opt_cfg, device="meta")


def _default_opt(cfg):
    return AdamWConfig(state_dtype=cfg.opt_state_dtype,
                       factored=getattr(cfg, "opt_factored", False))


def state_from_numpy(tree, cfg, opt_cfg: AdamWConfig | None = None, *,
                     device=None):
    """The JAX package's train state for ``cfg`` (``{"params", "opt": {"m",
    "v", "step"}}``, numpy arrays as leaves; factored ``v`` leaves as
    ``{"vr", "vc"}``) as the port's state on ``device``.  Every path, shape
    and dtype must match ``make_train_state``'s for ``cfg`` and
    ``opt_cfg``; a missing or extra leaf raises."""
    lm.check_family(cfg)
    device = resolve_device(device)
    opt_cfg = opt_cfg or _default_opt(cfg)
    meta = lm.init_lm(cfg, None, device="meta")
    template = {"params": meta, "opt": adamw_init(meta, opt_cfg)}
    want, got = registry.leaves(template), registry.leaves(tree)
    missing, extra = sorted(want.keys() - got), sorted(got.keys() - want)
    if missing or extra:
        raise ValueError(f"{cfg.name}: train state differs: missing "
                         f"{missing}, extra {extra}")
    for key, spec in want.items():
        if tuple(np.shape(got[key])) != tuple(spec.shape):
            raise ValueError(f"{cfg.name}: {key} has shape "
                             f"{tuple(np.shape(got[key]))}, expected "
                             f"{tuple(spec.shape)}")

    def build(node, spec):
        if isinstance(node, dict):
            return {k: build(v, spec[k]) for k, v in node.items()}
        return registry.to_tensor(node, spec.dtype, device)

    return build(tree, template)


def grads_of(loss, params, batch):
    """``((l, aux), grads)`` of ``loss(params, batch)``: the gradient tree by
    ``torch.autograd.grad`` at detached aliases of ``params`` (a leaf the
    loss never reads gets zeros, as in JAX); nothing keeps a graph."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        l, aux = loss(live, batch)
        flat = list(registry.leaves(live).values())
        gs = iter(torch.autograd.grad(l, flat, allow_unused=True))

    def take(p):
        g = next(gs)
        return torch.zeros_like(p) if g is None else g

    aux = {k: v.detach() for k, v in aux.items()}
    return (l.detach(), aux), tree_map(take, live)


def make_train_step(cfg, opt_cfg: AdamWConfig | None = None):
    """``train_step(state, batch) -> (state, metrics)``: one AdamW step on
    the gradient of the mean loss over ``batch`` (``{"tokens": [B, S]}``,
    tensors or numpy, moved to the parameters' device), in place."""
    opt_cfg = opt_cfg or _default_opt(cfg)
    loss = registry.loss_fn(cfg)
    accum = max(getattr(cfg, "grad_accum", 1), 1)

    def train_step(state, batch):
        params = state["params"]
        batch = {k: torch.as_tensor(v, device=params["tok_embed"].device)
                 for k, v in batch.items()}
        if accum == 1:
            (l, aux), grads = grads_of(loss, params, batch)
        else:
            # microbatched gradient accumulation (activation memory / accum)
            micro = {k: x.reshape(accum, x.shape[0] // accum, *x.shape[1:])
                     for k, x in batch.items()}
            grads = tree_map(torch.zeros_like, params)
            l, aux = torch.zeros((), device=micro["tokens"].device), {}
            for i in range(accum):
                (li, auxi), g = grads_of(loss, params,
                                         {k: x[i] for k, x in micro.items()})
                tree_map(lambda a, b: a.add_(b.to(a.dtype)), grads, g)
                l = l + li
                aux = {k: aux.get(k, 0) + v for k, v in auxi.items()}
                del g
            tree_map(lambda g: g.div_(accum), grads)
            l = l / accum
            aux = {k: a / accum for k, a in aux.items()}
        params, opt = adamw_update(params, grads, state["opt"], opt_cfg)
        metrics = {"loss": l, **aux}
        return {"params": params, "opt": opt}, metrics

    return train_step


def make_serve_step(cfg):
    decode = registry.decode_fn(cfg)

    @torch.inference_mode()
    def serve_step(params, cache, token):
        new_cache, logits = decode(params, cache, token)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return new_cache, next_token, logits

    return serve_step


def make_prefill_step(cfg, max_len: int):
    prefill = registry.prefill_fn(cfg, max_len)

    @torch.inference_mode()
    def prefill_step(params, batch):
        cache, logits = prefill(params, batch)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return cache, next_token

    return prefill_step
