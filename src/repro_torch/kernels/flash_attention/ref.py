"""Plain PyTorch version of attention: the whole score matrix at once."""
import math

import torch


def attention_ref(q, k, v, causal=True):
    """q [B, Sq, H, D]; k/v [B, Skv, K, D], H = K G -> [B, Sq, H, D] in q's
    dtype.  f32 scores q.k / sqrt(D); the causal mask keeps
    q_pos + (Skv - Sq) >= k_pos and writes -1e30 where it masks."""
    B, Sq, H, D = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    qg = q.reshape(B, Sq, Kh, G, D).to(torch.float32)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, k.to(torch.float32)) \
        / math.sqrt(D)
    if causal:
        mask = torch.ones((Sq, Skv), dtype=torch.bool,
                          device=q.device).tril(Skv - Sq)
        s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqs,bshd->bqhgd", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, D).to(q.dtype)
