"""arctic-480b [moe] — 128 experts top-2 + dense residual FFN.

[hf:Snowflake/snowflake-arctic-base; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    n_experts=128, top_k=2, d_expert=4864, dense_residual=True,
    # 480B params: bf16 second moment to fit 256x16GB (see EXPERIMENTS §Dry-run)
    opt_state_dtype="bfloat16",
    fsdp=True,
    grad_accum=16,
    moe_group_size=2048,
    opt_factored=True,
)
