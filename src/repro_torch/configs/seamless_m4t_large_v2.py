"""seamless-m4t-large-v2 [audio] — enc-dec multimodal backbone.

[arXiv:2308.11596; hf] — the speech frontend is a STUB: input_specs()
provides precomputed frame embeddings [B, seq//enc_ratio, d_model].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206,
    n_enc_layers=24, enc_ratio=4,
)
