"""Serve step builders: the serving half of the JAX package's
``train/step.py``.

``make_train_state`` and ``make_train_step`` (with the optimizer of
``train/optim.py``) come with training, ROADMAP queue A, item A8c.
"""
from __future__ import annotations

import torch

from repro_torch.models import registry


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
