"""Attention wrapper: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors.  ``attention.launches`` counts kernel launches."""
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (64, 128)


def attention(q, k, v, *, causal=True):
    """q [B, Sq, H, D]; k/v [B, Skv, K, D] with H = K G, f32 or bf16, D in
    ``HEAD_DIMS`` -> [B, Sq, H, D] in q's dtype
    (``csrc/flash_attention.cu``)."""
    name = "flash_attention"
    dev = _build.device_of(name, q, k, v)
    need = _build.require
    need(name, q.dtype in (torch.float32, torch.bfloat16)
         and q.dtype == k.dtype == v.dtype, "f32 or bf16 inputs of one dtype")
    need(name, q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
         "q must be [B, Sq, H, D] and k/v one [B, Skv, K, D] shape")
    B, Sq, H, D = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    need(name, k.shape[0] == B and k.shape[3] == D,
         "q and k/v must share B and D")
    need(name, Kh > 0 and H % Kh == 0, f"H={H} must be a multiple of K={Kh}")
    need(name, Skv > 0, "Skv must be at least 1")
    need(name, D in HEAD_DIMS, f"head dim D={D} must be one of {HEAD_DIMS}")
    if dev.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    need(name, all(t.is_contiguous() for t in (q, k, v)), "contiguous inputs")
    # both kernels read q, k and v by TMA, from 16-byte-aligned bases
    need(name, all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
         "inputs must start on a 16-byte boundary (TMA reads them)")
    out = torch.empty_like(q)
    _build.launch(name, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), B, Sq, Skv, H, Kh, D, int(causal),
                  int(q.dtype == torch.bfloat16))
    attention.launches += 1
    return out


attention.launches = 0
