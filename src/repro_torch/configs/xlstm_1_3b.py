"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

Implemented as mLSTM (matrix-memory) blocks in chunked gated-linear-attention
form; d_ff=0 (the block carries its own up/down projections).  See DESIGN.md
for the exp-gating stabilization note.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    ssm_state=0, ssm_expand=2, ssm_headdim=0,  # mLSTM uses n_heads over d_inner
)
