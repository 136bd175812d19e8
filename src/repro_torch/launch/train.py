"""Fault-tolerant training launcher: the JAX package's ``launch/train.py``
on torch.

Features exercised end-to-end by the tests and ``chip_smoke.py``:
* checkpoint/restart: atomic checkpoints every ``ckpt_every`` steps; on start
  the latest checkpoint is restored and the step-indexed data pipeline
  replays the exact order (no data loss / duplication on restart),
* straggler watchdog: per-step wall times tracked; steps slower than
  ``straggler_factor`` x the running median trigger the (pluggable) callback
  — on a real pod this is where the slow host gets cordoned,
* SIGTERM handling: preemption saves a final checkpoint before exit.

The state lives on ``device`` (the card unless ``device="cpu"``), each
batch is moved there, and the step updates the state in place (the JAX
launcher donates it to a jitted step).  Elastic rescale (``restore`` onto
another placement) waits for ROADMAP queue A, item A8d.
"""
from __future__ import annotations

import os
import signal
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.index import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.step import make_train_state, make_train_step


@dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    straggler_factor: float = 3.0
    keep: int = 3


@dataclass
class LoopReport:
    losses: list = field(default_factory=list)
    step_seconds: list = field(default_factory=list)
    straggler_steps: list = field(default_factory=list)
    resumed_from: int | None = None
    final_step: int = 0


def train_loop(cfg, stream, loop_cfg: TrainLoopConfig,
               straggler_cb=None, gen=None, hooks=(), *,
               device=None) -> LoopReport:
    """Run (or resume) a training job.  ``stream.batch_at(step)`` supplies
    deterministic batches; ``gen`` (a ``torch.Generator`` on ``device``,
    seed 0 by default) draws the initial parameters."""
    device = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    report = LoopReport()
    step_fn = make_train_step(cfg)

    state = make_train_state(cfg, gen, device=device)
    start = 0
    last = ckpt.latest_step(loop_cfg.ckpt_dir)
    if last is not None:
        state, start = ckpt.restore(state, loop_cfg.ckpt_dir, device=device)
        report.resumed_from = start

    interrupted = {"flag": False}

    def on_term(signum, frame):
        interrupted["flag"] = True

    old = signal.signal(signal.SIGTERM, on_term)
    try:
        for step in range(start, loop_cfg.steps):
            t0 = time.perf_counter()
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in stream.batch_at(step).items()}
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            report.losses.append(loss)
            report.step_seconds.append(dt)
            med = float(np.median(report.step_seconds))
            if len(report.step_seconds) > 5 and \
                    dt > loop_cfg.straggler_factor * med:
                report.straggler_steps.append(step)
                if straggler_cb is not None:
                    straggler_cb(step, dt, med)
            for h in hooks:
                h(step, state, metrics)
            done = step + 1
            if done % loop_cfg.ckpt_every == 0 or done == loop_cfg.steps or \
                    interrupted["flag"]:
                ckpt.save(state, loop_cfg.ckpt_dir, done, keep=loop_cfg.keep)
            if interrupted["flag"]:
                break
            report.final_step = done
    finally:
        signal.signal(signal.SIGTERM, old)
    return report
