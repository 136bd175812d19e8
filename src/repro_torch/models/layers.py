"""Shared layer primitives: init helpers, norms, rotary embeddings.

The JAX package's ``models/layers.py`` on torch.  Initialisation draws from
an explicit ``torch.Generator`` (on the device of the tensor it fills);
``generator=None`` with ``device="meta"`` gives the shapes and dtypes of a
tree without allocating it.  ``checkpoint`` is ``jax.checkpoint``'s
counterpart, for the LM's training path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as torch_checkpoint


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ``"float32"``) as a torch
    dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def checkpoint(fn, *args):
    """``jax.checkpoint(fn)(*args)``: under autograd, ``fn`` keeps none of
    its intermediates for the backward pass, which runs it again
    (``torch.utils.checkpoint`` without reentry; nothing it computes draws
    random numbers, so no RNG state is stashed); without autograd, a plain
    call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                       preserve_rng_state=False)


def _truncated_normal(gen, shape, scale, dtype, device) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], times ``scale``, drawn in f32
    and cast to ``dtype`` (``jax.random.truncated_normal`` then ``astype``)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.mul_(scale)
    return t.to(dtype)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device) -> torch.Tensor:
    return _truncated_normal(gen, (in_dim, out_dim), in_dim ** -0.5, dtype,
                             device)


def embed_init(gen, vocab: int, dim: int, dtype, device) -> torch.Tensor:
    return _truncated_normal(gen, (vocab, dim), 0.02, dtype, device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor | None,
            eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True)
                        + eps)
    if scale is not None:
        x = x * (1.0 + scale.float())
    return x.to(dtype)


def nonparam_ln(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo-style non-parametric LayerNorm (no scale/bias)."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dtype)


def apply_norm(x: torch.Tensor, scale, norm_type: str) -> torch.Tensor:
    if norm_type == "nonparam_ln":
        return nonparam_ln(x)
    return rmsnorm(x, scale)


def norm_param(d_model: int, norm_type: str, dtype, device) -> torch.Tensor:
    if norm_type == "nonparam_ln":
        # placeholder so the trees stay uniform
        return torch.zeros((1,), dtype=dtype, device=device)
    return torch.zeros((d_model,), dtype=dtype, device=device)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)              # [hd/2]
    angles = positions[..., :, None].float() * freqs        # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up
