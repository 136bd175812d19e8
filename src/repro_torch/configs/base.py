"""Architecture config schema + the assigned input-shape sets.

Every assigned architecture gets one module ``src/repro_torch/configs/<id>.py``
exporting ``CONFIG`` (exact published hyper-parameters) — see the per-file
``[source]`` notes.  ``reduced()`` shrinks any config for CPU smoke tests.
These are the JAX package's configs, copied field for field: the port
imports nothing of that package.  The training knobs (``remat``,
``grad_accum``, ``fsdp``, ``opt_*``, ``moe_*``) are kept so that the two
agree; the serving path reads none of them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0               # per-expert ffn hidden dim
    n_shared_experts: int = 0
    dense_residual: bool = False    # Arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    attn_every: int = 0             # hybrid: shared attn block every N layers
    # --- enc-dec / multimodal ---
    n_enc_layers: int = 0
    enc_ratio: int = 4              # encoder len = seq_len // enc_ratio
    n_patches: int = 0              # vlm: stub patch embeddings prepended
    # --- common ---
    norm_type: str = "rmsnorm"      # rmsnorm | nonparam_ln
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # training-time knobs (hillclimb levers; defaults = paper-faithful baseline)
    q_chunk: int = 1024
    kv_chunk: int = 1024
    ssm_chunk: int = 128
    remat: bool = True
    causal_block_skip: bool = True   # triangular schedule (OFF = paper-faithful baseline rect)
    opt_state_dtype: str = "float32"
    fsdp: bool = False               # ZeRO-3: shard params+opt state over data axis
    grad_accum: int = 1              # microbatched gradient accumulation
    opt_factored: bool = False       # Adafactor-style factored 2nd moment
    moe_group_size: int = 4096       # GShard dispatch group size
    expert_data_shard: bool = False  # resident EP over the data axis (no FSDP re-gather)
    moe_impl: str = "auto"          # sorted | einsum | shard_map | auto

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab + 127) // 128) * 128

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


# The assigned LM-family shape set (applies to every assigned architecture).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: run only for ssm/hybrid families.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True


def reduced(cfg: ArchConfig, *, seq_hint: int = 64) -> ArchConfig:
    """Shrink a config to a CPU-smoke-testable size, preserving the family."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=512,
        q_chunk=max(16, seq_hint // 4),
        kv_chunk=max(16, seq_hint // 4),
        ssm_chunk=16,
        dtype="float32",
        grad_accum=1,
        fsdp=False,
        opt_factored=False,
    )
    if cfg.n_experts:
        kw.update(n_experts=8 if cfg.n_experts % 2 == 0 else 7, top_k=min(cfg.top_k, 2),
                  d_expert=32, n_shared_experts=min(cfg.n_shared_experts, 2))
        kw["n_experts"] = 8
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_headdim=16)
    if cfg.attn_every:
        kw.update(attn_every=2)
    if cfg.n_enc_layers:
        kw.update(n_enc_layers=2)
    if cfg.n_patches:
        kw.update(n_patches=8)
    return cfg.replace(**kw)
