"""Config registry: one module per assigned architecture (``--arch <id>``).

``blend_gittables`` (the discovery dry-run's config) is not here: it reads
``GITTABLES_SCALE`` from the JAX package's ``dist/shard.py``, which comes
with ROADMAP queue A, item A8e.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    SUBQUADRATIC_FAMILIES,
    ArchConfig,
    ShapeConfig,
    reduced,
    shape_applicable,
)

ARCH_IDS = [
    "arctic-480b",
    "qwen2-moe-a2.7b",
    "smollm-360m",
    "minitron-8b",
    "yi-6b",
    "olmo-1b",
    "xlstm-1.3b",
    "zamba2-7b",
    "internvl2-76b",
    "seamless-m4t-large-v2",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
