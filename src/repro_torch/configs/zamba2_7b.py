"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, conv_kernel=4,
    attn_every=6,
    grad_accum=4,
)
