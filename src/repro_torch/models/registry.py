"""Model registry: a uniform (init / loss / prefill / decode / batch) API
over the architectures, the JAX package's ``models/registry.py``.

``params_from_numpy`` carries a parameter tree across from the JAX package
(handed over as numpy arrays), leaf by leaf: the LM's counterpart of
``UnifiedIndex.from_numpy``.  ``input_specs``, ``cache_specs`` and
``param_specs_tree`` come with the analysis tools (ROADMAP queue A, item
A8e).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.index import resolve_device
from repro_torch.models import lm
from repro_torch.models.layers import dtype_of


def is_encdec(cfg) -> bool:
    return cfg.family == "audio"


def init_params(cfg, gen, *, device=None):
    """Random parameters drawn from ``gen``, a ``torch.Generator`` on
    ``device`` (the card unless ``device="cpu"``)."""
    lm.check_family(cfg)          # audio (enc-dec) included
    return lm.init_lm(cfg, gen, device=resolve_device(device))


def loss_fn(cfg):
    """``(params, batch) -> (loss, aux)``, differentiable in ``params``."""
    lm.check_family(cfg)
    return lambda params, batch: lm.lm_loss(params, cfg, batch)


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    lm.check_family(cfg)
    return lm.init_cache(cfg, batch, max_len, device=resolve_device(device))


def decode_fn(cfg):
    lm.check_family(cfg)
    return lambda params, cache, token: lm.decode_step(params, cfg, cache,
                                                       token)


def prefill_fn(cfg, max_len: int):
    lm.check_family(cfg)
    return lambda params, batch: lm.prefill(params, cfg, batch["tokens"],
                                            max_len)


def make_batch(cfg, shape, gen, *, vocab_cap=None, device=None):
    """A concrete random batch (for smoke tests / benchmarks): ``tokens``
    [B, S] int32 drawn from ``gen`` on ``device``."""
    lm.check_family(cfg)
    hi = vocab_cap or cfg.vocab
    tokens = torch.randint(0, hi, (shape.global_batch, shape.seq_len),
                           generator=gen, dtype=torch.int32,
                           device=resolve_device(device))
    return {"tokens": tokens}


def leaves(tree, prefix="") -> dict:
    """A parameter or cache tree's leaves by path (``"layers/attn/wq"``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def to_tensor(a, dtype, device) -> torch.Tensor:
    """A numpy array (ml_dtypes' bfloat16 included, bit for bit) as a
    tensor of ``dtype`` on ``device``."""
    a = np.array(a, order="C")           # a copy the tensor may own
    if a.dtype.name == "bfloat16":         # ml_dtypes' bfloat16, bit for bit
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree, cfg, *, device=None, dtype=None):
    """The JAX package's parameter tree for ``cfg`` (the same nested keys,
    numpy arrays as leaves) as the port's tree on ``device``, in ``dtype``
    (a torch dtype; default ``cfg.dtype``).  Every key and shape must match
    ``init_params``'s tree for ``cfg``; a missing or extra leaf raises."""
    lm.check_family(cfg)
    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg.dtype)
    want = leaves(lm.init_lm(cfg, None, device="meta"))
    got = leaves(tree)
    missing, extra = sorted(want.keys() - got), sorted(got.keys() - want)
    if missing or extra:
        raise ValueError(f"{cfg.name}: parameter tree differs: missing "
                         f"{missing}, extra {extra}")
    for key, spec in want.items():
        if tuple(np.shape(got[key])) != tuple(spec.shape):
            raise ValueError(f"{cfg.name}: {key} has shape "
                             f"{tuple(np.shape(got[key]))}, expected "
                             f"{tuple(spec.shape)}")

    def build(node):
        return {k: build(v) if isinstance(v, dict)
                else to_tensor(v, dtype, device) for k, v in node.items()}

    return build(tree)
