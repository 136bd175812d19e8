"""Unified observability for the serving stack: metrics + span tracing.

One switch, three surfaces::

    from repro_torch import obs

    reg = obs.enable()                  # install a real MetricsRegistry
    ...run queries...
    print(reg.render())                 # counters / gauges / p50-p95-p99
    obs.disable()                       # back to the no-op singleton

* **metrics** (``obs/metrics.py``) — every layer records counters, gauges
  and log-bucketed latency histograms into ``obs.registry()``.  Disabled
  (the default), that accessor returns a no-op singleton, so instrumented
  hot paths cost one dynamic call that does nothing.
* **tracing** (``obs/trace.py``) — span trees threaded through a contextvar
  (``obs.trace.recording``), exportable as Chrome trace-event JSON
  (``obs.dump_chrome``).  Tracing works with metrics disabled and vice
  versa.
* **synchronized timing** (:func:`set_sync_timing`) — opt-in accuracy mode
  for the executor's per-node timings.  CUDA launches are asynchronous, so
  a default timing measures *enqueue* cost, not device compute: a seeker
  that launches in 40us and computes for 4ms reports 40us.  With sync
  timing on, the executor synchronizes its stream on a CUDA
  device after each seeker / combiner / fused group / DAG program before
  reading the clock, so ``ExecInfo.node_seconds`` and
  the trace spans measure real compute — at the price of serializing
  dispatch (pipelining across nodes and batched requests is lost, so
  end-to-end latency degrades; use it in benchmarks and offline traces,
  never in production serving).  Results are bit-identical either way.

This registry is the port's own: enabling it leaves the JAX package's
``repro.obs`` as it was, and the other way round.
"""
from __future__ import annotations

import time

from repro_torch.obs import trace  # noqa: F401  (re-export)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                               MetricsRegistry, NULL_REGISTRY, NullRegistry)
from repro_torch.obs.trace import (NULL_RECORDER, Recorder, Span,  # noqa: F401
                             chrome_trace, dump_chrome, recording)

_registry = NULL_REGISTRY
_sync_timing = False


def enable(registry: MetricsRegistry | None = None, *,
           sync_timing: bool | None = None,
           now=time.perf_counter) -> MetricsRegistry:
    """Install (and return) the process-local registry.  A fresh registry
    is created unless one is passed; ``sync_timing`` optionally flips the
    synchronized-timing mode in the same call."""
    global _registry
    _registry = registry if registry is not None \
        else MetricsRegistry(now=now)
    if sync_timing is not None:
        set_sync_timing(sync_timing)
    return _registry


def disable():
    """Back to the no-op singleton (also clears sync timing)."""
    global _registry
    _registry = NULL_REGISTRY
    set_sync_timing(False)


def enabled() -> bool:
    return _registry is not NULL_REGISTRY


def registry():
    """The active registry — the no-op singleton unless :func:`enable` was
    called.  Instrumented code calls this unconditionally."""
    return _registry


def set_sync_timing(flag: bool):
    """Opt in/out of synchronized per-node timing (see module docstring:
    accurate device timings, serialized dispatch)."""
    global _sync_timing
    _sync_timing = bool(flag)


def sync_timing() -> bool:
    return _sync_timing
