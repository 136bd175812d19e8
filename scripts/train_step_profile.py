#!/usr/bin/env python3
"""Where a full-width train step's time goes on the card.

Runs ``make_train_step`` of the port (bf16 parameters, f32 AdamW state,
remat on, TF32 off) for each config of ``chip_smoke.TRAIN_FULL`` at
``chip_smoke``'s 8 x 4096, one warm-up step, then one step under
``torch.profiler`` (``chip_smoke.device_events``, which reads only what
follows its marker kernel), and prints one JSON line per config: wall ms,
the card's busy ms and idle share, device ms by kind of kernel (matrix
products, the rest) and the top kernels by device time.

    python3 scripts/train_step_profile.py [--arch smollm-360m]

Needs one CUDA card; about two minutes.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.train.step import make_train_state, make_train_step  # noqa

#: substrings of the names of cuBLAS / CUTLASS matrix-product kernels
PRODUCTS = ("gemm", "nvjet", "xmma", "cutlass", "Kernel2")
TOP = 20


def profile_step(arch: str, overrides: dict) -> dict:
    cfg = configs.get_config(arch).replace(**overrides)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    state = make_train_state(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (cs.TRAIN_BATCH, cs.TRAIN_SEQ),
                           generator=gen, dtype=torch.int32, device=dev)
    step = make_train_step(cfg)
    holder = {"state": state}

    def one():
        holder["state"], _ = step(holder["state"], {"tokens": tokens})

    one()                                   # warm-up
    torch.cuda.reset_peak_memory_stats()
    wall, events, _, _ = cs.device_events(one, 1)
    busy = sum(ms for _, ms in events.values())
    products = sum(ms for name, (_, ms) in events.items()
                   if any(p in name for p in PRODUCTS))
    top = sorted(events.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {"phase": "train_step_profile", "card": cs.card_line(),
            "arch": arch, "n_layers": cfg.n_layers,
            "batch": cs.TRAIN_BATCH, "seq": cs.TRAIN_SEQ,
            "grad_accum": cfg.grad_accum, "wall_ms": wall,
            "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "product_ms": products, "other_ms": busy - products,
            "device_records": sum(n for n, _ in events.values()),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "top": [{"name": name[:120], "records": n, "ms": ms}
                    for name, (n, ms) in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(cs.TRAIN_FULL), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_step_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch, overrides in cs.TRAIN_FULL.items():
        if args.arch in (None, arch):
            print(json.dumps(profile_step(arch, overrides)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
