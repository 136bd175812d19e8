"""internvl2-76b [vlm] — InternViT + InternLM2 backbone.

[arXiv:2404.16821; unverified] — the ViT frontend is a STUB: input_specs()
provides precomputed patch embeddings [B, n_patches, d_model].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256,
    n_patches=256,
    fsdp=True,
    grad_accum=8,
)
