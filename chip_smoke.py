#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of BLEND (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it exits non-zero, printing no result,
without them or outside a checkout.

Phases (each prints JSON lines):

1. set-up: the card's name and power limit, the build of every kernel from
   ``src/repro_torch/kernels/csrc``, a 7.7 M-posting synthetic lake at
   Gittables' width and numeric share, and ``repro_torch.connect(lake,
   backend="bucket")`` over it.  One warm-up pass over the queries, unfused
   through the session and fused through a throwaway executor on the same
   index (each query, then all of them as one ``query_many`` batch),
   records the largest input each kernel wrapper is given on either path.
2. kernels: each kernel at those main-path inputs, plus ragged edges, must
   equal its plain PyTorch version exactly.  Kernel and plain versions are
   timed per call with CUDA events (L2 flushed before each call), the
   kernel alone with the profiler, beside the least time the card could
   take.  ``superkey_filter_rows`` is also checked and timed at the widest
   window the MC stage can give ([256, 1024], the index's digests gathered
   at seeded random postings), and beside each of its inputs stands a
   ``fill_`` of the same output bytes (``fill_ms``, the card's store path).
3. main path: every query runs 5 times warm through the bucket session with
   the launch counters set to 0 just before and read just after; each
   kernel must have launched.  One more profiled run per query gives the
   card's busy time.  Every result (ids and scores) must equal a
   ``sorted``-backend Executor on the card and the port on the CPU.
3b. fused path: the same queries through ``session.query(q, fused=True)``
   (one CUDA graph per seeker group and one per plan's combiner DAG),
   warmed once, then 5 timed runs each with the counters set to 0 just
   before and read just after (each query-path kernel must have launched
   on replay, and no program may be captured), ``ExecInfo.launches``
   beside phase 3's, peak memory, all eight as one ``query_many`` batch,
   and one profiled run per query, whose trace must show each query-path
   kernel exactly as many times as the programs ticked its counter in
   that run (``traced_launches``: a query whose trace falls short is
   profiled again, up to three runs, and fails if none is equal).  Every
   profiled run follows a warm-up run in the same profiler session and a
   marker kernel, and only what follows the marker is read: the profiler
   drops the earliest device records of a session.  Every fused
   and batched result must equal phase 3's, ids and scores, bit for bit.

4. entry points: the kernel packages' own entry points, which no query
   runs (``superkey_filter.ops.filter_rows``, ``qcr_score.ops.score``,
   ``flash_attention.ops.attention`` once on bf16 and once on f32 inputs,
   which launch different kernels), each driven REPEATS times at real
   widths with its launch counter set to 0 just before and read just after,
   then held to its plain version there and at ragged edges (exactly, or
   within the attention tolerance) and timed as in phase 2, attention also
   beside PyTorch's own ``scaled_dot_product_attention`` (the backend it
   ran is named), ``filter_rows`` beside ``fill_ms``.  An ``attention`` line reads both tensor-core attention
   kernels at their main inputs (achieved TFLOP/s, share of the bound,
   time over SDPA's, event time over event time and device time over
   device time), the bf16 one also at smollm-360m's width at the same
   length, and the kernels' registers, spills and shared memory from the
   build's ``-Xptxas -v`` report.

5. live lake (run between 3b and 4, which frees the lake): the same lake
   through ``connect(lake, live=True, backend="bucket", wal=...)``, then
   ``add_tables`` of 64 tables of the same width, ``drop_table`` of 32
   base tables (tombstones), ``add_table`` of a guard table,
   ``snapshot``, a drop and re-add of the guard (auto-compaction merged
   its first delta, so the re-add is a new geometry) and a second drop and
   re-add (a geometry seen before).  After each step:
   mutate, refresh and first-query ms, arena bytes copied, programs built
   (0 for the tombstones, the snapshot, the drops and the seen geometry),
   the programs the executor holds and the device memory allocated,
   0 captures in the timed runs, the fused p50 of the eight queries and of
   two guard queries (``sc`` / ``kw`` over the guard's first column: the
   guard first while live, absent once dropped), every result equal to
   the unfused run and to a ``sorted`` Executor on the same store.  Then
   traced = ticked launches on one profiled fused run per query, as in
   3b, each distinct kernel input of the live path against the plain
   version, the results against a static ``sorted`` rebuild of the live tables through
   ``live_ids()``, a full ``compact()`` (results unchanged) and
   ``repro_torch.recover`` from the snapshot and the WAL (results and
   epoch equal to the session it replaces).  The launch counters are set
   to 0 at the phase's start and read at its end.

6. serve (run between 3b and 5, and at the end of 5): the serving tier
   at the smoke lake's width.  ``DiscoveryEngine(session=<phase 3's
   session>)``: ``serve`` of each query, fused and unfused, equals phase
   3; ``serve_many`` of the eight, fused and unfused, equals eight
   ``serve`` calls bit for bit and makes exactly one device-to-host copy
   (the profiler's ``Memcpy DtoH`` records); p50 of 5 warm runs of each,
   with the ``execute`` / ``drain`` / ``transfer`` split, and 0 captures
   in the timed runs.  Then ``connect(lake, cache=True,
   backend="bucket")``: a cold ``serve_many`` of the eight is all
   ``miss`` and equals phase 3; a second pass is all ``hit``, equal, with
   no kernel launched, no device activity in its trace and no program
   built (hit p50 beside cold p50); ``sc | kw'`` (a new ``kw``) is
   ``partial`` and equals phase 3's session; ``sc`` over A cached on the
   fused path, ``sc`` over B (same width and capacity, so the same
   programs replay with other values), then ``sc | corr`` served A's
   ``sc`` from the cache and equals phase 3 (the aliasing guard).  Phase
   5's ``recover`` opens its session with ``cache=True``: after a
   ``drop_table`` and an ``add_table`` of the guard table the first query
   is a ``miss``, the guard queries rank it first only while it is live,
   and every answer equals the card's ``sorted`` executor on the same
   store.  Every kernel input shape of the serving path is held to the
   plain versions; peak device memory and the cache's device bytes are
   printed.  The launch counters are set to 0 at the start of each part
   and read at its end.

7. server (run after 6's static part, and at the end of 5 after 6's live
   part): the batching front tier, ``DiscoveryServer`` with up to 16
   requests a batch, on the sessions phases 3 and 5 left (no new index).
   Static, on phase 3's session: four submitter threads each submit the
   eight queries (lanes and tenants mixed), a warm-up pass and three timed
   passes; every answer equals phase 3's, ids and scores, the largest batch
   holds two or more, and the timed passes capture nothing.  One profiled
   batch of the eight: its trace shows each query-path kernel as often as
   the dispatcher's replays ticked it.  ``trace=True``: each request's
   queue and batch spans tile its root, and ``dump_trace`` writes Chrome
   JSON.  ``explain`` through the server renders ``== server ==``.  The
   load generator (``make_trace(lake, seed=0, duration_s=2.0)`` at 100 and
   3000 requests a second, one unpaced warm-up replay, then one open-loop
   replay of each): every answer equals a sequential ``serve(q,
   fused=True)`` of its pool query, every shed is a typed ``Overloaded``,
   no lane's queue outgrows its bound, no future is left pending after
   ``stop()``; goodput, client p50 / p99, shed rate, mean batch size and
   launches per batch are printed.  ``RetryingClient`` from four threads
   against a token bucket (``rate=40``, ``burst=4``): retries and
   gave-ups.  Live, on phase 5's recovered session: from one thread,
   without waiting, twice over, the ten queries, ``add_table(guard)``, the
   ten, ``drop_table`` by name, then the ten once more; the guard ranks
   first only while live, every answer equals a sequential replay after
   ``stop()`` (the guard's id mapped), and the second round builds no
   program.  Every kernel input shape of the server path (the eight as one
   batch, the load generator's 2-6-value queries alone and in batches, the
   ten on the live store) is held to the plain versions.  The launch
   counters are set to 0 at the start of each part and read at its end.

Any phase that captures an empty CUDA graph fails: that warning is an
error here.  A ``replaced_kernels`` line quotes, as constants not measured in the run,
the device times of the superkey kernels this version replaced
(``scripts/superkey_ab.py`` times another build against this one in one
process).  The last two lines are the card's ``nvidia-smi`` name and power
limit and ``{"ok": true, "device": {...}}``.  Any mismatch raises.
"""
from __future__ import annotations

import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import repro_torch as blend  # noqa: E402  (fails outside a checkout)
from repro_torch import obs  # noqa: E402
from repro_torch.core import seekers as seek  # noqa: E402
from repro_torch.core.executor import Executor  # noqa: E402
from repro_torch.core.lake import DataLake, synthetic_lake  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bucket_probe import ops as bucket_ops  # noqa: E402
from repro_torch.kernels.bucket_probe.ref import bucket_probe_ref  # noqa
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa
from repro_torch.kernels.qcr_score import ops as qcr_ops  # noqa: E402
from repro_torch.kernels.qcr_score.ref import (  # noqa: E402
    qcr_score_ref, qcr_segments_ref)
from repro_torch.kernels.superkey_filter import ops as sk_ops  # noqa: E402
from repro_torch.kernels.superkey_filter.ref import (  # noqa: E402
    superkey_filter_ref, superkey_filter_rows_ref)
from repro_torch.obs import trace as otrace  # noqa: E402
from repro_torch.errors import Overloaded  # noqa: E402
from repro_torch.serve.batching import BATCH, INTERACTIVE  # noqa: E402
from repro_torch.serve.client import RetryingClient  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    DiscoveryEngine, DiscoveryResponse)
from repro_torch.serve.loadgen import (  # noqa: E402
    make_trace, query_pool, replay)
from repro_torch.serve.server import DiscoveryServer  # noqa: E402

# Gittables' width (max_cols=8) and numeric share (25%), cut to 20k tables
LAKE = dict(n_tables=20_000, rows=64, cols=8, numeric_cols=2, vocab=200_000,
            seed=0)
REPEATS = 5
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the non-tensor f32
# rate, the dense bf16 tensor-core rate (the bound of bf16 attention) and
# the dense TF32 rate.  f32 attention is bound by 3xTF32: each f32-accurate
# product is three TF32 products (a_hi b_hi + a_hi b_lo + a_lo b_hi, with
# x = x_hi + x_lo split to nearest), so 495 / 3 = 165 TFLOP/s effective
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
TENSOR_BF16_OPS_PER_S = 989e12
TENSOR_TF32_OPS_PER_S = 495e12
F32_3XTF32_OPS_PER_S = TENSOR_TF32_OPS_PER_S / 3
SEED = 0
MARKER = "spin_kernel"        # the kernel torch.cuda._sleep launches
TRACE_TRIES = 3               # profiled sessions a trace check may take
ABSORBED = 16                 # kernels a profiled session starts with

#: name -> (wrapper module, wrapper attribute, plain version, source, TPU kernel)
KERNELS = {
    "bucket_probe": (bucket_ops, "probe", bucket_probe_ref,
                     "src/repro_torch/kernels/csrc/bucket_probe.cu",
                     "src/repro/kernels/bucket_probe/kernel.py:34"),
    "superkey_filter_rows": (
        sk_ops, "filter_candidates", superkey_filter_rows_ref,
        "src/repro_torch/kernels/csrc/superkey_filter_rows.cu",
        "src/repro/kernels/superkey_filter/kernel.py:34"),
    "qcr_segments": (qcr_ops, "score_segments", qcr_segments_ref,
                     "src/repro_torch/kernels/csrc/qcr_segments.cu",
                     "src/repro/kernels/qcr_score/kernel.py:36"),
}

#: the kernels no query runs, reached through their packages' own entry
#: points (phase 4); same fields as KERNELS
ENTRY_KERNELS = {
    "superkey_filter": (sk_ops, "filter_rows", superkey_filter_ref,
                        "src/repro_torch/kernels/csrc/superkey_filter.cu",
                        "src/repro/kernels/superkey_filter/kernel.py:58"),
    "qcr_score": (qcr_ops, "score", qcr_score_ref,
                  "src/repro_torch/kernels/csrc/qcr_score.cu",
                  "src/repro/kernels/qcr_score/kernel.py:55"),
    "flash_attention": (fa_ops, "attention", attention_ref,
                        "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:54"),
    # the same entry point on f32 inputs, which launch their own kernel
    "flash_attention_f32": (fa_ops, "attention", attention_ref,
                            "src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:54"),
}
#: entry kernel -> the input dtype of its attention cases
ATTENTION_DTYPE = {"flash_attention": torch.bfloat16,
                   "flash_attention_f32": torch.float32}
#: attention widths of the repo's LM configs: (heads, kv heads, head dim)
YI_6B = (32, 4, 128)          # src/repro/configs/yi_6b.py
SMOLLM_360M = (15, 5, 64)     # src/repro/configs/smollm_360m.py
#: (label, dtype, causal, B, Sq, Skv, widths); the first of each dtype is
#: that kernel's main input, yi-6b at train_4k's length with B cut from 256
#: to 1
ATTENTION_CASES = [
    ("yi-6b S=4096", torch.bfloat16, True, 1, 4096, 4096, YI_6B),
    ("yi-6b f32 S=4096", torch.float32, True, 1, 4096, 4096, YI_6B),
    ("smollm-360m S=4096", torch.bfloat16, True, 1, 4096, 4096, SMOLLM_360M),
    ("smollm-360m S=2048", torch.bfloat16, True, 1, 2048, 2048, SMOLLM_360M),
    ("yi-6b f32 S=1024 non-causal", torch.float32, False, 1, 1024, 1024,
     YI_6B),
    ("yi-6b Sq=100 Skv=4096", torch.bfloat16, True, 1, 100, 4096, YI_6B),
    ("smollm-360m Sq=300 Skv=200", torch.bfloat16, True, 1, 300, 200,
     SMOLLM_360M),
    ("yi-6b f32 Sq=1 Skv=777", torch.float32, True, 1, 1, 777, YI_6B),
]
ATTENTION_ATOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
#: cases after the main input that are also timed beside SDPA
ATTENTION_TIMED = ("smollm-360m S=4096",)
QCR_H = 256                   # h_sample of configs/blend_gittables.py
#: device ms of the superkey kernels the current ones replaced (commit
#: e71dedb), read by this script at these output shapes on one NVIDIA H100
#: 80GB HBM3 at 700.00 W; printed as quoted constants, never as a reading
REPLACED = {"source": "chip_smoke.py on commit e71dedb, NVIDIA H100 80GB "
                      "HBM3, 700.00 W",
            "device_ms": [["superkey_filter", [256, 958_623], 0.1557245],
                          ["superkey_filter_rows", [256, 128], 0.0022773],
                          ["superkey_filter_rows", [256, 1024], 0.0032677]]}


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_queries(lake, seed=1):
    """Main-path queries at the shapes of configs/blend_gittables.py: 1024
    values per SC/KW/C probe batch, 256 two-column MC tuples from real rows,
    h=256."""
    rng = np.random.default_rng(seed)
    n_cat = LAKE["cols"] - LAKE["numeric_cols"]

    def cells(n):
        out = []
        for _ in range(n):
            t = lake.tables[int(rng.integers(lake.n_tables))]
            out.append(t.columns[int(rng.integers(n_cat))]
                       [int(rng.integers(t.n_rows))])
        return out

    def tuples(n):
        out = []
        for _ in range(n):
            t = lake.tables[int(rng.integers(lake.n_tables))]
            r = int(rng.integers(t.n_rows))
            out.append((t.columns[0][r], t.columns[1][r]))
        return out

    def targets(n):
        return [float(x) for x in rng.normal(0, 1, n).round(4)]

    sc = blend.sc(cells(1024))
    kw = blend.kw(cells(1024))
    mc = blend.mc(tuples(256))
    corr = blend.corr(cells(1024), targets(1024), h=256)
    # one table's own rows: its values as keywords, its first column as
    # join keys and its first numeric column as the target, so the
    # correlation seeker runs mask-threaded and the answer is not empty
    t = lake.tables[int(rng.integers(lake.n_tables))]
    num = t.columns[LAKE["cols"] - LAKE["numeric_cols"]]
    sql_expr = blend.kw(t.columns[1][:64], k=50) & blend.corr(
        t.columns[0], [float(v) for v in num], k=50)
    return {
        "sc": sc, "kw": kw, "mc": mc, "corr": corr,
        "(mc & sc) - mc": (mc & sc) - blend.mc(tuples(64)),
        "sc | corr": sc | corr,
        "counter(sc, kw, mc)": blend.counter(sc, kw, mc),
        "sql": sql_expr.to_sql(),
    }


def run_query(session, q, fused=False):
    if fused:
        return session.query(q, fused=True)
    return session.sql(q) if isinstance(q, str) else session.query(q)


def record_kernel_inputs(session, queries, drive=None):
    """Warm-up pass that keeps, per kernel, the largest argument set the
    main path hands its wrapper, unfused through ``session`` and fused
    (each query, then all of them as one ``query_many``) through a
    throwaway bucket executor on the same index (so that no recording
    wrapper stands in while the session's programs are captured); or, with
    ``drive``, whatever ``drive()`` runs (on executors of its own).
    Returns (largest on either path, largest unfused, {kernel: {signature:
    input}} with one input per distinct argument shape seen)."""
    seen = {}
    shapes = {name: {} for name in KERNELS}
    originals = {}
    for name, (mod, attr, *_rest) in KERNELS.items():
        fn = getattr(mod, attr)
        originals[name] = fn

        def spy(*args, _name=name, _fn=fn, **kwargs):
            # a call under graph capture runs nothing, so its arguments
            # hold no values; each program's eager warm-up call is kept
            size = sum(a.numel() for a in args if torch.is_tensor(a))
            if not torch.cuda.is_current_stream_capturing():
                if size >= seen.get(_name, (-1,))[0]:
                    seen[_name] = (size, args, kwargs)
                sig = tuple(tuple(a.shape) if torch.is_tensor(a) else a
                            for a in args)
                shapes[_name].setdefault(sig, (args, kwargs))
            return _fn(*args, **kwargs)

        # a wrapper counts into the function its module name is bound to:
        # while the spy stands in, the warm-up launches count on the spy
        spy.launches = 0
        setattr(mod, attr, spy)
    try:
        if drive is not None:
            drive()
            return {}, {}, shapes
        for q in queries.values():
            run_query(session, q)
        unfused = dict(seen)
        throwaway = blend.Session(Executor(session.index, backend="bucket"))
        for q in queries.values():
            run_query(throwaway, q, fused=True)
        # all eight as one batch: it groups same-kind seekers across the
        # queries, so its groups are the widest the fused path builds
        throwaway.query_many(list(queries.values()))
        torch.cuda.synchronize()
        del throwaway
    finally:
        for name, (mod, attr, *_rest) in KERNELS.items():
            setattr(mod, attr, originals[name])
    torch.cuda.synchronize()
    missing = set(KERNELS) - set(unfused)
    if missing:
        raise RuntimeError(f"main path never reached {sorted(missing)}")
    return tuple({name: (args, kwargs) for name, (_, args, kwargs)
                  in found.items()} for found in (seen, unfused)) + (shapes,)


def l2_flusher(device):
    """A function that evicts the card's 50 MB L2 (by writing 128 MB), so a
    timed call reads its inputs from device memory, as a main-path probe
    of a resident index mostly does."""
    buf = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    return buf.zero_


def time_ms(fn, flush, iters=20) -> float:
    """Mean ms of one call on the card's timeline (CUDA events around each
    call, L2 flushed before each)."""
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in events:
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def device_events(fn, iters):
    """Run ``fn`` once, then ``iters`` times, under one ``torch.profiler``
    session.  Returns (wall ms per counted run, {device activity name:
    [records, device ms]} of the counted runs, {kernel: launches its
    wrapper ticked in them}, {kernel: launches of the first run its trace
    lacks}).  The profiler on the H100 machine drops the earliest device
    records of a session (PERF.md section 6), so ``ABSORBED`` small
    kernels and the first run absorb that loss and only what follows a
    marker kernel (``torch.cuda._sleep``) is read; a session whose trace lost the marker too is run again, up
    to ``TRACE_TRIES`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(TRACE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # records for the profiler to drop first: a function that runs
            # nothing on the card (a cache hit) would leave it the marker
            absorb = torch.zeros(1, device="cuda")
            for _ in range(ABSORBED):
                absorb.add_(1)
            first = kernel_launches()
            fn()
            torch.cuda.synchronize()
            first = {k: v - first[k] for k, v in kernel_launches().items()}
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            before = kernel_launches()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
            ticked = {k: v - before[k] for k, v in kernel_launches().items()}
        device = sorted((e.start_ns(), e.name(), e.duration_ns())
                        for e in prof.profiler.kineto_results.events()
                        if e.device_type() != DeviceType.CPU)
        marks = [i for i, (_, name, _) in enumerate(device)
                 if MARKER in name]
        if len(marks) == 1:
            break
    else:
        raise AssertionError(f"the profiler's trace lost the marker kernel "
                             f"in {TRACE_TRIES} sessions")
    events: dict = {}
    for _, name, ns in device[marks[0] + 1:]:
        rec = events.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += ns / 1e6
    lost = {k: n - sum(f"{k}_kernel" in name
                       for _, name, _ in device[:marks[0]])
            for k, n in first.items()}
    return wall, events, ticked, lost


def profiled(fn, iters):
    """(wall ms per run, {device activity: device ms per run}) of ``fn``
    run ``iters`` times under the profiler (``device_events``)."""
    wall, events, _, _ = device_events(fn, iters)
    return wall, {name: ms / iters for name, (_, ms) in events.items()}


def kernel_device_ms(fn, symbol, flush, iters=20):
    """Device time of one launch of the kernel whose name holds ``symbol``
    (the mean over the launches the trace recorded), L2 flushed before
    each (None when the profiler sees no device time)."""
    _, events, _, _ = device_events(lambda: (flush(), fn()), iters)
    hits = [ms / n for name, (n, ms) in events.items() if symbol in name]
    return sum(hits) if hits else None


def device_kernels(fn, flush, iters=20) -> dict:
    """{kernel: device ms per call} of every kernel ``fn`` launches, L2
    flushed before each call, the flush's own kernels left out."""
    _, device = profiled(lambda: (flush(), fn()), iters)
    flush_kernels = set(profiled(flush, 1)[1])
    return {k: ms for k, ms in device.items() if k not in flush_kernels}


def fill_yardstick(shape, flush) -> dict:
    """The card's store path on the bytes of a bool output of ``shape``:
    ``fill_`` of a tensor allocated outside the timed region (CUDA-event ms
    and profiler device ms, L2 flushed before each).  A yardstick only: it
    does not compute the function, and the port never calls it."""
    out = torch.empty(shape, dtype=torch.bool, device="cuda")
    fill = lambda: out.fill_(True)  # noqa: E731
    return {"fill_ms": time_ms(fill, flush),
            "fill_device_ms": sum(device_kernels(fill, flush).values())}


def store_rates(row) -> dict:
    """GB/s and share of the bound of a superkey row, by device time."""
    ms = row["device_ms"] or row["ms"]
    return {"gb_per_s": row["bytes"] / ms / 1e6,
            "share_of_bound": row["bound_ms"] / ms}


def work(name, args, out):
    """(bytes the function must move, scalar operations) for one call."""
    if name == "bucket_probe":
        bh, bp, q, bits = args
        rows = torch.unique((q.to(torch.int64) + (1 << 31)) >> (32 - bits))
        width = bh.shape[1]
        moved = q.numel() * 4 + rows.numel() * width * 8 + out.numel() * 4
        return moved, out.numel()                  # one compare per element
    if name == "superkey_filter_rows":
        sk_lo, sk_hi, q_lo, q_hi = args
        moved = sk_lo.numel() * 8 + q_lo.numel() * 8 + out.numel()
        return moved, 5 * out.numel()              # 2 AND, 2 compare, 1 AND
    n_agree, n_all = args
    return n_agree.numel() * 8 + out.numel() * 4, 6 * out.numel()


def max_abs_err(got, want) -> float:
    return float((got.to(torch.float64) - want.to(torch.float64)).abs()
                 .max().item()) if got.numel() else 0.0


def ragged_cases(name, args, kwargs):
    """Edge shapes cut from the main-path inputs: counts that are not a
    multiple of a warp, single rows, and sentinel queries."""
    if name == "bucket_probe":
        bh, bp, q, bits = args
        q = q[:1000].clone()
        q[::7] = torch.iinfo(torch.int32).max      # the MISSING sentinel
        return [((bh, bp, q, bits), {}), ((bh, bp, q[:1].clone(), bits), {})]
    if name == "superkey_filter_rows":
        sk_lo, sk_hi, q_lo, q_hi = args
        cut = lambda a, t, m: a[:t, :m].contiguous()  # noqa: E731
        return [((cut(sk_lo, 5, 33), cut(sk_hi, 5, 33), q_lo[:5].clone(),
                  q_hi[:5].clone()), {}),
                ((cut(sk_lo, 1, 1), cut(sk_hi, 1, 1), q_lo[:1].clone(),
                  q_hi[:1].clone()), {})]
    n_agree, n_all = args
    return [((n_agree[:1000].clone(), n_all[:1000].clone()), kwargs),
            ((n_agree[:1].clone(), n_all[:1].clone()), kwargs)]


def wide_rows_input(engine, q_lo, q_hi, m):
    """``superkey_filter_rows`` at the widest window the MC stage can give
    (``m_cap_max``): the index's row digests gathered at posting indices
    drawn from a generator seeded with SEED, against the main path's
    per-row query digests."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n = engine.dev["sk_lo"].shape[0]
    pidx = torch.randint(0, n, (q_lo.shape[0], m), generator=gen,
                         device="cuda")
    return (engine.dev["sk_lo"][pidx], engine.dev["sk_hi"][pidx],
            q_lo.clone(), q_hi.clone())


def time_rows_shape(args, flush) -> dict:
    """``superkey_filter_rows`` at one input: checked, timed, with its bound
    and the store yardstick of its output bytes."""
    wrapper = sk_ops.filter_candidates
    out = wrapper(*args)
    want = superkey_filter_rows_ref(*args)
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError("superkey_filter_rows disagrees with its plain "
                             f"version at {list(out.shape)}")
    moved, ops = work("superkey_filter_rows", args, out)
    row = {"shape": list(out.shape), "bytes": moved,
           "true_share": float(want.float().mean()),
           "ms": time_ms(lambda: wrapper(*args), flush),
           "device_ms": kernel_device_ms(lambda: wrapper(*args),
                                         "superkey_filter_rows_kernel", flush),
           "plain_ms": time_ms(lambda: superkey_filter_rows_ref(*args),
                               flush),
           "bound_ms": max(moved / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S)
           * 1e3}
    return {**row, **store_rates(row),
            **fill_yardstick(out.shape, flush)}


def check_kernels(inputs, wide_rows) -> dict:
    """Phase 2: every kernel equals its plain version, timed;
    ``superkey_filter_rows`` also at ``wide_rows``."""
    rows = {}
    flush = l2_flusher(torch.device("cuda"))
    for name, (mod, attr, plain, source, replaces) in KERNELS.items():
        wrapper = getattr(mod, attr)
        args, kwargs = inputs[name]
        plain_kwargs = {"min_support": kwargs["min_support"]} \
            if "min_support" in kwargs else {}
        for case_args, case_kwargs in [(args, kwargs)] + \
                ragged_cases(name, args, kwargs):
            got = wrapper(*case_args, **case_kwargs)
            want = plain(*case_args, **plain_kwargs)
            torch.cuda.synchronize()
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version at {list(got.shape)}")
        out = wrapper(*args, **kwargs)
        want = plain(*args, **plain_kwargs)
        moved, ops = work(name, args, out)
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = ops / SCALAR_OPS_PER_S * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            "max_abs_err": max_abs_err(out, want),
            "ms": time_ms(lambda: wrapper(*args, **kwargs), flush),
            "device_ms": kernel_device_ms(lambda: wrapper(*args, **kwargs),
                                          f"{name}_kernel", flush),
            "plain_ms": time_ms(lambda: plain(*args, **plain_kwargs), flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "equal": True,
            "shape": [list(a.shape) for a in args if torch.is_tensor(a)],
            "bytes": moved,
        }
        if name == "superkey_filter_rows":
            rows[name].update(store_rates(rows[name]))
            rows[name].update(fill_yardstick(out.shape, flush))
            rows[name]["wide"] = time_rows_shape(wide_rows, flush)
            rows[name]["ptxas"] = _build.ptxas_usage("superkey_filter")
        emit({"phase": "kernel", **rows[name]})
    return rows


def run_main_path(session, queries) -> dict:
    """Phase 3: each query REPEATS times warm, counters read around it."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    results, p50 = {}, {}
    for label, q in queries.items():
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            res = run_query(session, q)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        results[label] = res
        p50[label] = statistics.median(times)
    launches = kernel_launches()
    emit({"phase": "main_path", "p50_ms": p50, "repeats": REPEATS,
          "launches": launches,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    busy = {}
    for label, q in queries.items():
        wall, device = profiled(lambda: run_query(session, q), 1)
        busy[label] = {"wall_ms": wall, "device_ms": sum(device.values())}
    emit({"phase": "device_busy", "note": "one profiled run per query",
          "queries": busy})
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"main path never launched {idle}")
    return results, launches, p50


def kernel_launches() -> dict:
    return {name: getattr(mod, attr).launches
            for name, (mod, attr, *_rest) in KERNELS.items()}


def reset_launches():
    for mod, attr, *_rest in KERNELS.values():
        getattr(mod, attr).launches = 0


def same_result(got, want) -> bool:
    return got.ids == want.ids and torch.equal(got.scores, want.scores)


def run_fused_path(session, queries, unfused) -> dict:
    """Phase 3b: each query on the fused path, warmed once, then REPEATS
    timed runs with the counters read around them; all of them as one
    ``query_many`` batch; one profiled run per query.  ``unfused`` is phase
    3's output: every fused result must equal its result."""
    results, launches_unfused, p50_unfused = unfused
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for q in queries.values():
        run_query(session, q, fused=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    programs = dict(seek.TRACE_COUNTS)
    reset_launches()
    p50, launches, bad = {}, {}, []
    for label, q in queries.items():
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            res = run_query(session, q, fused=True)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        p50[label] = {"fused": statistics.median(times),
                      "unfused": p50_unfused[label]}
        launches[label] = {"fused": res.info.launches,
                           "unfused": results[label].info.launches}
        if not same_result(res, results[label]):
            bad.append(label)
    kernels = kernel_launches()
    captures = sum(seek.TRACE_COUNTS.values()) - sum(programs.values())
    emit({"phase": "fused", "p50_ms": p50, "repeats": REPEATS,
          "exec_launches": launches, "kernel_launches": kernels,
          "unfused_kernel_launches": launches_unfused,
          "captures_in_timed_runs": captures,
          "programs": len(session.executor.programs),
          "warm_up_seconds": warm_s,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "memory_reserved_bytes": torch.cuda.memory_reserved()})

    batch = list(queries.values())
    before = sum(seek.TRACE_COUNTS.values())
    session.query_many(batch)          # builds the batch's own programs
    torch.cuda.synchronize()
    batch_programs = sum(seek.TRACE_COUNTS.values()) - before
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        outs = session.query_many(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    bad += [f"query_many {label}" for label, res in zip(queries, outs)
            if not same_result(res, results[label])]
    reg = obs.enable()
    session.query_many(batch)
    torch.cuda.synchronize()
    device_programs = reg.counter("exec.launches").value
    obs.disable()
    batch_captures = sum(seek.TRACE_COUNTS.values()) - before - \
        batch_programs
    emit({"phase": "fused_batch", "queries": len(batch),
          "p50_ms": statistics.median(times), "repeats": REPEATS,
          "device_programs": device_programs,
          "exec_launches": [res.info.launches for res in outs],
          "programs_built_in_warm_up": batch_programs,
          "captures_in_timed_runs": batch_captures})

    # the launches the card ran, read from the trace, beside the ones the
    # programs ticked on replay in the same runs
    busy, traced, ticked, lost = traced_launches(session, queries)
    emit({"phase": "fused_device_busy", "note": "one profiled run per query",
          "queries": busy, "kernel_launches_traced": traced,
          "kernel_launches_ticked": ticked,
          "warm_up_launches_untraced": lost})
    if bad:
        raise AssertionError(f"fused results differ from phase 3: {bad}")
    if captures or batch_captures:
        raise AssertionError(f"{captures} + {batch_captures} programs "
                             f"captured in timed runs")
    idle = [name for name, n in traced.items() if n == 0]
    if idle:
        raise AssertionError(f"no launch of {idle} in the fused path's "
                             f"trace")
    return kernels


def check_results(session, results):
    """Every result equals the sorted backend on the card and the port on
    the CPU (plain versions), ids and scores exactly."""
    index = session.index
    others = {"sorted_cuda": Executor(index, backend="sorted", device="cuda"),
              "bucket_cpu": Executor(index, backend="bucket", device="cpu")}
    summary = {}
    for label, res in results.items():
        scores = res.scores.cpu()
        if scores.shape != (index.n_tables,) or \
                not torch.isfinite(scores).all():
            raise AssertionError(f"{label}: malformed scores")
        for other, ex in others.items():
            rs, _ = ex.run(res.compiled.plan)
            if not torch.equal(rs.scores.cpu(), scores) or \
                    [int(t) for t in rs.ids()] != res.ids:
                raise AssertionError(f"{label} differs from {other}")
        summary[label] = {"n_ids": len(res.ids), "top": res.ids[:5]}
    if not any(s["n_ids"] for s in summary.values()):
        raise AssertionError("every query came back empty")
    emit({"phase": "check", "equal_to": sorted(others), "queries": summary})


# ------------------------------------------------------------ phase 5: live

#: phase 5's mutations: tables ``add_tables`` adds, base tables it drops
LIVE_ADDS = 64
LIVE_DROPS = 32


def live_tables(n, seed, prefix):
    """``n`` tables at the smoke lake's width from ``synthetic_lake`` with
    ``seed``, renamed ``prefix`` + i so that no name is a base table's."""
    tables = synthetic_lake(**{**LAKE, "n_tables": n, "seed": seed}).tables
    for i, t in enumerate(tables):
        t.name = f"{prefix}{i}"
    return tables


def guard_queries(table) -> dict:
    """An ``sc`` and a ``kw`` over the cells of ``table``'s first text
    column: while the table is live they rank it first."""
    cells = list(table.columns[0])
    return {"guard sc": blend.sc(cells), "guard kw": blend.kw(cells)}


def run_all(session, queries, fused) -> dict:
    out = {label: run_query(session, q, fused=fused)
           for label, q in queries.items()}
    torch.cuda.synchronize()
    return out


def check_guard(results, tid, live, step):
    """The guard queries rank table ``tid`` first while it is live, and
    never once it is dropped."""
    for label in ("guard sc", "guard kw"):
        ids = results[label].ids
        if (live and ids[:1] != [tid]) or (not live and tid in ids):
            raise AssertionError(f"live step {step}: {label} gives "
                                 f"{ids[:3]} with table {tid} "
                                 f"{'live' if live else 'dropped'}")


def live_step(session, checker, queries, step, mutate) -> tuple:
    """One step of phase 5: ``mutate`` (host-timed), the refresh and the
    first fused query, the rest warmed, then REPEATS timed fused runs of
    every query and one unfused run.  Every result must equal the card's
    ``sorted`` executor on the same store (``checker``) and the unfused
    run; no program may be captured in the timed runs.  Returns (the
    step's line, fused results)."""
    ex = session.executor
    t0 = time.perf_counter()
    mutate()
    mutate_ms = (time.perf_counter() - t0) * 1e3
    built0 = sum(seek.TRACE_COUNTS.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.refresh()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    first = next(iter(queries.values()))
    run_query(session, first, fused=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    run_all(session, queries, fused=True)
    built = sum(seek.TRACE_COUNTS.values()) - built0
    p50, results = {}, {}
    for label, q in queries.items():
        times = []
        for _ in range(REPEATS):
            t3 = time.perf_counter()
            results[label] = run_query(session, q, fused=True)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t3) * 1e3)
        p50[label] = statistics.median(times)
    captures = sum(seek.TRACE_COUNTS.values()) - built0 - built
    unfused = run_all(session, queries, fused=False)
    bad = [label for label, res in results.items()
           if not same_result(unfused[label], res)]
    for label, res in results.items():
        rs, _ = checker.run(res.compiled.plan)
        if not torch.equal(rs.scores, res.scores) or \
                [int(t) for t in rs.ids()] != res.ids:
            bad.append(f"{label} (sorted)")
    shape = session.index_shape()
    line = {"phase": "live", "step": step, "mutate_ms": mutate_ms,
            "refresh_ms": (t1 - t0) * 1e3,
            "first_query_ms": (t2 - t0) * 1e3,
            "arena_copied_bytes": ex.arena.copied_bytes,
            "arena_generation": ex.arena.generation,
            "programs_built": built, "captures_in_timed_runs": captures,
            "programs": len(ex.programs),
            "memory_allocated_bytes": torch.cuda.memory_allocated(),
            "p50_ms": p50, "epoch": shape["epoch"],
            "segments": shape["segments"],
            "postings_per_segment": shape["postings_per_segment"],
            "live_tables": shape["live_tables"],
            "tombstoned": len(shape["tombstoned"]),
            "table_slots": shape["table_slots"]}
    emit(line)
    if bad:
        raise AssertionError(f"live step {step}: {bad} differ")
    if captures:
        raise AssertionError(f"live step {step}: {captures} programs "
                             f"captured in timed runs")
    return line, results


def traced_launches(session, queries) -> tuple:
    """One profiled fused run per query (``device_events``, after a
    warm-up run in the same session): the query-path kernels its trace
    shows must equal the launches its programs ticked in that run, kernel
    by kernel.  A trace can still lack one whole graph launch's records
    (PERF.md section 6), so a query whose trace falls short is profiled
    again, up to ``TRACE_TRIES`` runs; a query with no equal run fails, as
    does a trace with more launches than ticked.  Returns ({query: wall ms,
    device ms and runs of its equal run}, traced, ticked, the warm-up
    runs' launches their traces lack), the launches summed over the
    queries' equal runs."""
    busy, short = {}, {}
    traced, ticked = dict.fromkeys(KERNELS, 0), dict.fromkeys(KERNELS, 0)
    warm_up_lost = dict.fromkeys(KERNELS, 0)
    for label, q in queries.items():
        for run in range(1, TRACE_TRIES + 1):
            wall, events, want, lost = device_events(
                lambda: run_query(session, q, fused=True), 1)
            got = {name: sum(n for key, (n, _) in events.items()
                             if f"{name}_kernel" in key)
                   for name in KERNELS}
            for name in KERNELS:
                warm_up_lost[name] += lost[name]
            if any(got[k] > want[k] for k in KERNELS):
                raise AssertionError(f"{label}: traced {got} but ticked "
                                     f"{want}")
            if got == want:
                break
            short[label] = short.get(label, []) + [
                {k: want[k] - got[k] for k in KERNELS}]
        else:
            raise AssertionError(f"{label}: no profiled run traced the "
                                 f"{want} launches ticked: {short[label]}")
        busy[label] = {"wall_ms": wall, "runs": run, "device_ms": sum(
            ms for _, ms in events.values())}
        for name in KERNELS:
            traced[name] += got[name]
            ticked[name] += want[name]
    if short:
        emit({"phase": "trace_reruns", "short": short})
    return busy, traced, ticked, warm_up_lost


def window_widths(session, queries) -> list:
    """The probe windows' shapes, ``[nq, n_segments * m_cap]``, of one
    unfused run of every query."""
    from repro_torch.core.match import MatchEngine
    fan_out = MatchEngine._fan_out
    seen = set()

    def spy(self, *args):
        out = fan_out(self, *args)
        seen.add(tuple(out[0].shape))
        return out

    MatchEngine._fan_out = spy
    try:
        run_all(session, queries, fused=False)
    finally:
        MatchEngine._fan_out = fan_out
    return sorted(seen)


def host_counts_ms(store, values) -> dict:
    """Median ms of the store's planner counts over ``values``' hashes,
    with tombstoned postings (capacities) and without (statistics)."""
    from repro_torch.core.hashing import hash_array
    h = np.unique(hash_array(values))
    out = {"values": int(len(h))}
    for live_only in (False, True):
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            store.host_counts(h, live_only=live_only)
            times.append((time.perf_counter() - t0) * 1e3)
        out["live_only_ms" if live_only else "all_ms"] = \
            statistics.median(times)
    return out


def check_path_kernels(session, queries, phase="live_kernels",
                       drive=None) -> dict:
    """Every distinct argument shape a path hands each kernel
    (``record_kernel_inputs`` on ``session``, or whatever ``drive``
    runs), the kernel equal to its plain version there; one ``phase``
    line.  These comparison launches are taken back off the counters."""
    counts = kernel_launches()
    _, _, shapes = record_kernel_inputs(session, queries, drive)
    checked = {}
    for name, (mod, attr, plain, *_rest) in KERNELS.items():
        wrapper = getattr(mod, attr)
        checked[name] = []
        for args, kwargs in shapes[name].values():
            plain_kwargs = {"min_support": kwargs["min_support"]} \
                if "min_support" in kwargs else {}
            got = wrapper(*args, **kwargs)
            want = plain(*args, **plain_kwargs)
            torch.cuda.synchronize()
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version at {list(got.shape)} in "
                                     f"{phase}")
            checked[name].append([list(a.shape) for a in args
                                  if torch.is_tensor(a)])
    for (mod, attr, *_rest), n in zip(KERNELS.values(), counts.values()):
        getattr(mod, attr).launches = n
    del shapes
    gc.collect()
    emit({"phase": phase, "equal": True, "shapes": checked})
    return {name: len(c) for name, c in checked.items()}


def rebuild_parity(session, queries, results) -> float:
    """The live results equal a static ``sorted`` session over the live
    tables, ids and scores mapped through ``live_ids()`` (the JAX
    package's own acceptance of a live lake).  Returns its build seconds."""
    live_ids = session.live.live_ids()
    tables = session.live.tables
    t0 = time.perf_counter()
    static = blend.connect(DataLake([tables[t] for t in live_ids]),
                           backend="sorted")
    build_s = time.perf_counter() - t0
    bad = []
    for label, q in queries.items():
        got, want = results[label], run_query(static, q)
        slots = torch.tensor(live_ids, device=got.scores.device)
        rest = torch.ones_like(got.scores, dtype=torch.bool)
        rest[slots] = False
        if [live_ids[t] for t in want.ids] != got.ids or \
                not torch.equal(got.scores[slots], want.scores) or \
                bool(got.scores[rest].any()):
            bad.append(label)
    del static
    gc.collect()
    if bad:
        raise AssertionError(f"live results differ from the rebuild: {bad}")
    return build_s


def run_live_path(lake, queries, static_results, static_connect_s) -> tuple:
    """Phase 5: ``connect(lake, live=True, wal=...)`` on the smoke lake,
    the mutation steps (module docstring), each checked and timed; the
    rebuild parity; ``compact``; ``recover(..., cache=True)`` from the
    snapshot and the WAL, then phase 6's live cache steps and phase 7's
    live server on it.  Returns (each kernel's launches in the phase, the
    number of distinct inputs of each checked against its plain version,
    the live cache steps' launches, the live server's launches and
    inputs checked)."""
    tmp = Path(tempfile.mkdtemp(prefix="blend-live-"))
    wal, snap = tmp / "lake.wal", tmp / "lake.snap"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = blend.connect(lake, live=True, backend="bucket", wal=str(wal))
    connect_s = time.perf_counter() - t0
    checker = Executor(session.live.store, backend="sorted")
    adds = live_tables(LIVE_ADDS, 1, "live_add_")
    guard = live_tables(1, 2, "live_guard_")[0]
    queries = {**queries, **guard_queries(guard)}
    # the tables phase 3's answers rank first: dropping them shows
    drops = list(dict.fromkeys(
        t for label in ("sc", "kw", "mc", "corr")
        for t in static_results[label].ids))[:LIVE_DROPS]
    reset_launches()
    steps, n = [], lake.n_tables

    def step(name, mutate):
        line, res = live_step(session, checker, queries, name, mutate)
        steps.append(line)
        return line, res

    _, res = step("connect", lambda: None)
    unfused = run_all(session, queries, fused=False)
    for label, want in static_results.items():
        for got in (res[label], unfused[label]):
            if got.ids != want.ids or \
                    not torch.equal(got.scores[:n], want.scores) or \
                    bool(got.scores[n:].any()):
                raise AssertionError(f"live {label} differs from phase 3")
    step("add_tables", lambda: session.add_tables(adds))
    _, res = step("drop_tables",
                  lambda: [session.drop_table(t) for t in drops])
    if any(t in r.ids for r in res.values() for t in drops):
        raise AssertionError("a dropped table is still answered")
    tid = {}
    _, res = step("add_table",
                  lambda: tid.setdefault("a", session.add_table(guard)))
    check_guard(res, tid["a"], True, "add_table")
    line, _ = step("snapshot", lambda: session.snapshot(str(snap)))
    snap_ms = line["mutate_ms"]
    snap_bytes = sum(p.stat().st_size for p in tmp.glob("lake.*")
                     if p.suffix in (".npz", ".json"))
    _, res = step("drop_table", lambda: session.drop_table(tid["a"]))
    check_guard(res, tid["a"], False, "drop_table")
    _, res = step("add_table_again", lambda: tid.setdefault(
        "b", session.add_table(guard, name="live_guard_again")))
    check_guard(res, tid["b"], True, "add_table_again")
    _, res = step("drop_table_again", lambda: session.drop_table(tid["b"]))
    check_guard(res, tid["b"], False, "drop_table_again")
    _, res = step("add_table_seen_geometry", lambda: tid.setdefault(
        "c", session.add_table(guard, name="live_guard_seen")))
    check_guard(res, tid["c"], True, "add_table_seen_geometry")
    for line in steps:
        if line["step"] in ("drop_tables", "snapshot", "drop_table",
                            "drop_table_again",
                            "add_table_seen_geometry") and \
                line["programs_built"]:
            raise AssertionError(f"live step {line['step']} built "
                                 f"{line['programs_built']} programs")

    report = {"segments": steps[-1]["segments"],
              "postings_per_segment": steps[-1]["postings_per_segment"],
              "table_slots": steps[-1]["table_slots"],
              "windows": window_widths(session, queries),
              "host_counts": host_counts_ms(
                  session.live.store, queries["sc"].values)}
    _, traced, ticked, report["warm_up_launches_untraced"] = \
        traced_launches(session, queries)
    report["shapes_checked"] = check_path_kernels(session, queries)
    rebuild_s = rebuild_parity(session, queries, res)

    kept = res
    _, res = step("compact", session.compact)
    bad = [label for label in queries
           if not same_result(res[label], kept[label])]
    if bad:
        raise AssertionError(f"compaction changed {bad}")
    epoch, kept = session.live.epoch, res
    del session, checker, res
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    back = blend.recover(str(snap), wal=str(wal), backend="bucket",
                         cache=True)
    recover_s = time.perf_counter() - t0
    got = run_all(back, queries, fused=True)
    misses = [r.cache.status for r in got.values()].count("miss")
    back.cache.clear()                   # the unfused pass runs cold too
    unfused = run_all(back, queries, fused=False)
    bad = [label for label in queries
           if not same_result(got[label], kept[label]) or
           not same_result(unfused[label], kept[label])]
    launches = kernel_launches()
    recovered_epoch = back.live.epoch
    emit({"phase": "live_summary", "connect_s": connect_s,
          "static_connect_s": static_connect_s, "recover_s": recover_s,
          "epoch": epoch, "recovered_epoch": recovered_epoch,
          "snapshot_ms": snap_ms, "snapshot_bytes": snap_bytes,
          "rebuild_connect_s": rebuild_s, "launches": launches,
          "kernel_launches_traced": traced, "kernel_launches_ticked": ticked,
          "recovered_misses": misses,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          **report})
    serve_launches = server = None
    if not bad and recovered_epoch == epoch:
        serve_launches, guard_tid = serve_live_cache(back, queries, guard,
                                                     tid["c"])
        server = server_live(back, queries, guard, guard_tid)
    del back, got, unfused, kept
    shutil.rmtree(tmp, ignore_errors=True)
    if bad or recovered_epoch != epoch:
        raise AssertionError(f"recovered session differs: {bad}, epoch "
                             f"{recovered_epoch} against {epoch}")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"the live path never launched {idle}")
    return launches, report["shapes_checked"], serve_launches, server


# ----------------------------------------------------------- phase 6: serve

def same_response(resp, want) -> bool:
    """A ``DiscoveryResponse`` equals a ``QueryResult``: ids and scores."""
    return resp.table_ids == want.ids and \
        np.array_equal(resp.scores, want.scores.cpu().numpy())


def same_responses(a, b) -> bool:
    return a.table_ids == b.table_ids and a.overflow == b.overflow and \
        a.scores.dtype == b.scores.dtype and np.array_equal(a.scores,
                                                           b.scores)


def device_copies(events, kind="Memcpy DtoH") -> int:
    return sum(n for name, (n, _) in events.items() if name.startswith(kind))


def serve_split(engine, batch, fused) -> dict:
    """One warm ``serve_many`` under a span recorder: wall ms and its
    ``execute`` / ``drain`` / ``transfer`` spans' ms."""
    rec = otrace.Recorder()
    t0 = time.perf_counter()
    with otrace.recording(rec):
        engine.serve_many(batch, fused=fused)
    out = {"wall": (time.perf_counter() - t0) * 1e3}
    for span in rec.roots:
        out[span.name] = span.duration * 1e3
    return out


def other_values(lake, index, values, seed):
    """As many distinct cells as ``values`` holds: its more frequent half,
    and cells of other tables of the lake no more frequent than its most
    frequent one.  An ``sc`` over them has the width and capacity of one
    over ``values`` (the same programs) and other answers."""
    from repro_torch.core.hashing import hash_array
    vals = list(dict.fromkeys(values))
    counts = index.host_counts(hash_array(vals))
    top = int(counts.max())
    out = [vals[i] for i in np.argsort(-counts, kind="stable")
           [:len(vals) // 2]]
    seen = set(vals)
    rng = np.random.default_rng(seed)
    n_cat = LAKE["cols"] - LAKE["numeric_cols"]
    while len(out) < len(vals):
        t = lake.tables[int(rng.integers(lake.n_tables))]
        cell = t.columns[int(rng.integers(n_cat))][int(rng.integers(
            t.n_rows))]
        if cell not in seen and \
                int(index.host_counts(hash_array([cell]))[0]) <= top:
            seen.add(cell)
            out.append(cell)
    return out


def cache_device_bytes(cache) -> int:
    """Device bytes the cache's result and seeker entries hold (each
    tensor storage once)."""
    seen = {}
    for level in (cache.results, cache.seekers):
        for entry in level.data.values():
            rs = entry.value.result
            for t in (rs.scores, rs.mask):
                seen[t.untyped_storage().data_ptr()] = t.untyped_storage(
                ).nbytes()
    return sum(seen.values())


def serve_engine(session, queries, unfused) -> dict:
    """Phase 6, engine: ``serve`` and ``serve_many`` on phase 3's session
    (checked, timed, one device-to-host copy per batch)."""
    results, _, p50_unfused = unfused
    engine = DiscoveryEngine(None, session=session)
    batch = list(queries.values())
    bad = []
    for fused in (False, True):          # warm: builds what is missing
        serial = [engine.serve(q, fused=fused) for q in batch]
        bad += [f"serve {label} fused={fused}" for label, r in
                zip(queries, serial) if not same_response(r, results[label])]
        many = engine.serve_many(batch, fused=fused)
        bad += [f"serve_many {label} fused={fused}" for label, a, b in
                zip(queries, serial, many) if not same_responses(a, b)]
    torch.cuda.synchronize()
    built0 = sum(seek.TRACE_COUNTS.values())
    line = {"phase": "serve_engine", "repeats": REPEATS}
    for fused in (False, True):
        key = "fused" if fused else "unfused"
        p50 = {}
        for label, q in queries.items():
            times = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                engine.serve(q, fused=fused)
                times.append((time.perf_counter() - t0) * 1e3)
            p50[label] = statistics.median(times)
        splits = [serve_split(engine, batch, fused) for _ in range(REPEATS)]
        line[f"serve_p50_ms_{key}"] = p50
        line[f"serve_many_p50_ms_{key}"] = {
            part: statistics.median(sp[part] for sp in splits)
            for part in ("wall", "execute", "drain", "transfer")}
        _, events, _, _ = device_events(
            lambda: engine.serve_many(batch, fused=fused), 1)
        line[f"serve_many_dtoh_copies_{key}"] = device_copies(events)
        line[f"serve_many_htod_copies_{key}"] = device_copies(
            events, "Memcpy HtoD")
    line["phase3_p50_ms"] = p50_unfused
    line["captures_in_timed_runs"] = sum(seek.TRACE_COUNTS.values()) - built0
    emit(line)
    if bad:
        raise AssertionError(f"serving differs: {bad}")
    if line["captures_in_timed_runs"]:
        raise AssertionError("programs captured in timed serve runs")
    copies = [line[f"serve_many_dtoh_copies_{k}"] for k in ("unfused",
                                                            "fused")]
    if copies != [1, 1]:
        raise AssertionError(f"serve_many made {copies} device-to-host "
                             f"copies, not one each")
    return line


def serve_cache(lake, session, queries, unfused) -> dict:
    """Phase 6, static cache: cold, hit, partial and the aliasing guard on
    ``connect(lake, cache=True, backend="bucket")``."""
    results = unfused[0]
    t0 = time.perf_counter()
    cached = blend.connect(lake, cache=True, backend="bucket")
    connect_s = time.perf_counter() - t0
    cache = cached.cache
    engine = DiscoveryEngine(None, session=cached)
    batch = list(queries.values())
    bad = []
    cold = engine.serve_many(batch, fused=True)
    after_cold = {"entries": cache.entries,
                  "resident_bytes": cache.resident_bytes,
                  "device_bytes": cache_device_bytes(cache)}
    statuses = {"cold": [r.cache["status"] for r in cold]}
    bad += [f"cold {label}" for label, r in zip(queries, cold)
            if not same_response(r, results[label])]
    # the hit pass: nothing launched, built or traced on the device
    before = (kernel_launches(), sum(seek.TRACE_COUNTS.values()))
    hits = [cached.query(q) for q in batch]
    launched = {k: v - before[0][k] for k, v in kernel_launches().items()}
    built = sum(seek.TRACE_COUNTS.values()) - before[1]
    statuses["hit"] = [r.cache.status for r in hits]
    bad += [f"hit {label}" for label, r in zip(queries, hits)
            if not same_result(r, results[label])]
    _, hit_events, _, _ = device_events(
        lambda: [cached.query(q) for q in batch], 1)
    p50 = {}
    for label, q in queries.items():
        cold_t, hit_t = [], []
        for _ in range(REPEATS):
            cache.clear()
            t0 = time.perf_counter()
            cached.query(q).ids
            torch.cuda.synchronize()
            cold_t.append((time.perf_counter() - t0) * 1e3)
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            cached.query(q).ids
            hit_t.append((time.perf_counter() - t0) * 1e3)
        p50[label] = {"cold": statistics.median(cold_t),
                      "hit": statistics.median(hit_t)}
    # partial: ``sc`` from the cache, a new ``kw`` run
    kw_new = blend.kw(other_values(lake, cached.index,
                                   queries["kw"].values, SEED + 3))
    partial_q = queries["sc"] | kw_new
    cache.clear()
    cached.query(queries["sc"])
    part = cached.query(partial_q)
    part_want = session.query(partial_q)
    if part.cache.status != "partial" or not same_result(part, part_want):
        bad.append(f"partial ({part.cache.status})")
    # the aliasing guard: A's cached sc outlives a replay of its programs
    cache.clear()
    sc_a, corr = queries["sc"], queries["corr"]
    sc_b = blend.sc(other_values(lake, cached.index, sc_a.values, SEED + 4))
    cached.query(sc_a, fused=True)
    built0 = sum(seek.TRACE_COUNTS.values())
    b = cached.query(sc_b, fused=True)
    torch.cuda.synchronize()
    alias = {"b_programs_built": sum(seek.TRACE_COUNTS.values()) - built0,
             "b_differs": not torch.equal(b.scores, results["sc"].scores)}
    spec = cached.compile(sc_a).plan.nodes["sc0"].spec
    entry = cache.get_seeker(cache.seeker_key(spec))
    alias["entry_equal"] = torch.equal(entry.result.scores,
                                       results["sc"].scores)
    r = cached.query(sc_a | corr, fused=True)
    alias["status"] = r.cache.status
    alias["equal"] = same_result(r, results["sc | corr"])
    line = {"phase": "serve_cache", "connect_s": connect_s,
            "statuses": statuses, "hit_kernel_launches": launched,
            "hit_programs_built": built,
            "hit_device_events": sum(n for n, _ in hit_events.values()),
            "p50_ms": p50, "repeats": REPEATS,
            "after_cold": after_cold,
            "partial": {**part.cache.as_dict()}, "aliasing_guard": alias,
            "entries": cache.entries, "resident_bytes": cache.resident_bytes,
            "evictions": cache.evictions,
            "device_bytes": cache_device_bytes(cache)}
    emit(line)
    if statuses["cold"] != ["miss"] * len(batch) or \
            statuses["hit"] != ["hit"] * len(batch):
        bad.append(f"statuses {statuses}")
    if any(launched.values()) or built or line["hit_device_events"]:
        bad.append("a hit touched the device")
    if alias["b_programs_built"] or not alias["b_differs"] or \
            not alias["entry_equal"] or alias["status"] != "partial" or \
            not alias["equal"]:
        bad.append(f"aliasing guard {alias}")
    if bad:
        raise AssertionError(f"the cached session differs: {bad}")
    del cached, engine, cold, hits
    gc.collect()
    return line


def serve_live_cache(back, queries, guard, guard_tid) -> tuple:
    """Phase 6, live cache, on phase 5's recovered session (opened with
    ``cache=True``): a ``drop_table`` and an ``add_table`` of the guard;
    after each the first query is a ``miss``, a second pass is all hits,
    and every answer equals the card's ``sorted`` executor on the same
    store.  Returns (each kernel's launches in it, the id of the guard it
    left live)."""
    reset_launches()
    checker = Executor(back.live.store, backend="sorted")
    tid = guard_tid
    steps, bad = [], []
    for step, live in (("drop_guard", False), ("add_guard", True)):
        if live:
            tid = back.add_table(guard, name="live_guard_cached")
        else:
            back.drop_table(tid)
        first = [back.query(q) for q in queries.values()]
        again = [back.query(q) for q in queries.values()]
        res = dict(zip(queries, first))
        check_guard(res, tid, live, step)
        for label, a, b in zip(queries, first, again):
            rs, _ = checker.run(a.compiled.plan)
            if not torch.equal(rs.scores, a.scores) or \
                    [int(t) for t in rs.ids()] != a.ids or \
                    not same_result(a, b):
                bad.append(f"{step} {label}")
        steps.append({"step": step, "first": first[0].cache.status,
                      "statuses": [r.cache.status for r in first],
                      "again": [r.cache.status for r in again]})
        if first[0].cache.status != "miss" or \
                any(r.cache.status != "hit" for r in again):
            bad.append(f"{step} statuses")
    launches = kernel_launches()
    emit({"phase": "serve_live_cache", "steps": steps, "launches": launches,
          "invalidations": back.cache.invalidations,
          "entries": back.cache.entries,
          "device_bytes": cache_device_bytes(back.cache)})
    if bad:
        raise AssertionError(f"the live cached session differs: {bad}")
    return launches, tid


def record_serve(index, queries):
    """The serving path's kernel inputs: ``serve`` and ``serve_many``,
    fused and unfused, on a throwaway engine over ``index``."""
    def drive():
        engine = DiscoveryEngine(None, session=blend.Session(
            Executor(index, backend="bucket")))
        batch = list(queries.values())
        for fused in (False, True):
            for q in batch:
                engine.serve(q, fused=fused)
            engine.serve_many(batch, fused=fused)
        torch.cuda.synchronize()
    return drive


def run_serve_path(lake, session, queries, unfused) -> tuple:
    """Phase 6 on the static lake (module docstring): the engine, the
    cache, the kernels at the serving path's inputs.  Returns (each
    kernel's launches in it, the number of distinct inputs of each checked
    against its plain version)."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    serve_engine(session, queries, unfused)
    serve_cache(lake, session, queries, unfused)
    launches = kernel_launches()
    shapes = check_path_kernels(session, queries, "serve_kernels",
                                record_serve(session.index, queries))
    emit({"phase": "serve_summary", "seconds": time.perf_counter() - t0,
          "launches": launches,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"the serving path never launched {idle}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, shapes


# ---------------------------------------------------------- phase 7: server

#: phase 7's server: the reference's default batch bound, four submitter
#: threads, the timed passes after the warm-up, the load generator's rates
SERVER_BATCH = 16
SUBMITTERS = 4
SERVER_PASSES = 3
LOADGEN_RATES = (100.0, 3000.0)     # well under, and over, capacity
LOADGEN_SECONDS = 2.0


def percentile_ms(seconds, q) -> float:
    return float(np.percentile(np.asarray(seconds), q) * 1e3) \
        if seconds else 0.0


def histogram_ms(srv, name) -> dict:
    """Count, mean, max, and p50 / p99 (log-bucketed) of one of the
    server's latency histograms, in ms."""
    h = srv.metrics.snapshot()["histograms"].get(name)
    return {"count": h["count"], **{k: h[k] * 1e3 for k in (
        "mean", "max", "p50", "p99")}} if h else {"count": 0}


def submit_all(srv, items, lane=None, tenant="default") -> list:
    """Submit each (label, query) of ``items``; returns [(label, future,
    submit time)]."""
    out = []
    for i, (label, q) in enumerate(items):
        ln = lane or (INTERACTIVE if i % 2 else BATCH)
        out.append((label, srv.submit(q, lane=ln, tenant=tenant),
                    time.perf_counter()))
    return out


def resolved(fut, timeout=300):
    """A future's response; a future that resolves to an exception fails
    the run."""
    exc = fut.exception(timeout=timeout)
    if exc is not None:
        raise AssertionError(f"a server future failed: {exc!r}") from exc
    return fut.result()


def submitter_pass(srv, queries) -> tuple:
    """``SUBMITTERS`` threads, each submitting the eight queries (lanes and
    tenants mixed) and waiting for them.  Returns ([(label, response,
    client seconds)], wall ms)."""
    import threading
    items = list(queries.items())
    out, failures = [], []

    def client(tid):
        try:
            mine = []
            for i, (label, q) in enumerate(items):
                lane = INTERACTIVE if (i + tid) % 2 else BATCH
                mine.append((label, srv.submit(q, lane=lane,
                                               tenant=f"tenant_{tid}"),
                             time.perf_counter()))
            for label, fut, t0 in mine:
                resp = resolved(fut)
                out.append((label, resp, time.perf_counter() - t0))
        except BaseException as e:                   # noqa: BLE001
            failures.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SUBMITTERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = (time.perf_counter() - t0) * 1e3
    if failures or any(t.is_alive() for t in threads):
        raise AssertionError(f"submitter threads failed: {failures}")
    return out, wall


def server_traced(srv, queries) -> tuple:
    """One profiled batch of the eight through the server (``device_events``
    after a warm-up batch): the query-path kernels its trace shows must
    equal the launches the dispatcher's replays ticked, in one of up to
    ``TRACE_TRIES`` runs.  Returns (traced, ticked, runs)."""
    batch = list(queries.items())

    def run():
        for _, fut, _ in submit_all(srv, batch, lane=INTERACTIVE):
            resolved(fut)

    for run_i in range(1, TRACE_TRIES + 1):
        _, events, want, _ = device_events(run, 1)
        got = {name: sum(n for key, (n, _) in events.items()
                         if f"{name}_kernel" in key) for name in KERNELS}
        if any(got[k] > want[k] for k in KERNELS):
            raise AssertionError(f"server batch: traced {got} but ticked "
                                 f"{want}")
        if got == want:
            return got, want, run_i
    raise AssertionError(f"server batch: no profiled run traced the {want} "
                         f"launches ticked (last: {got})")


def server_static(session, queries, results) -> dict:
    """Phase 7, static part, on phase 3's session (module docstring)."""
    engine = DiscoveryEngine(None, session=session)
    srv = DiscoveryServer(engine, max_batch=SERVER_BATCH)
    bad, line = [], {"phase": "server", "submitters": SUBMITTERS,
                     "passes": SERVER_PASSES, "max_batch": SERVER_BATCH}
    try:
        built0 = sum(seek.TRACE_COUNTS.values())
        warm, line["warm_up_ms"] = submitter_pass(srv, queries)
        line["programs_built_in_warm_up"] = \
            sum(seek.TRACE_COUNTS.values()) - built0
        built0 = sum(seek.TRACE_COUNTS.values())
        got, walls = list(warm), []
        latencies = []
        for _ in range(SERVER_PASSES):
            out, wall = submitter_pass(srv, queries)
            got += out
            walls.append(wall)
            latencies += [s for _, _, s in out]
        line["captures_in_timed_runs"] = \
            sum(seek.TRACE_COUNTS.values()) - built0
        bad += [f"{label}" for label, resp, _ in got
                if not same_response(resp, results[label])]
        sizes = [resp.batch_size for _, resp, _ in got]
        line.update({
            "pass_wall_ms": walls, "client_p50_ms": percentile_ms(
                latencies, 50), "client_p99_ms": percentile_ms(latencies, 99),
            "max_batch_size": max(sizes),
            "mean_batch_size": float(np.mean(sizes)),
            "launches_per_response": statistics.median(
                resp.launches for _, resp, _ in got)})
        traced, ticked, runs = server_traced(srv, queries)
        line.update({"kernel_launches_traced": traced,
                     "kernel_launches_ticked": ticked, "trace_runs": runs})
        line["batch_ms"] = histogram_ms(srv, "server.batch_seconds")
        text = str(srv.explain(queries["sc"]))
        line["explain_has_server_section"] = "== server ==" in text
        st = srv.stats()
        line["stats"] = {"served": st["served"],
                         "batches": st["batches"]["formed"],
                         "mean_size": st["batches"]["mean_size"],
                         "launches_per_batch":
                         st["launches"]["per_batch_mean"]}
    finally:
        srv.stop()
    line["flight_recorder"] = flight_recorder(engine, queries, results)
    emit(line)
    if bad:
        raise AssertionError(f"server answers differ from phase 3: {bad}")
    if line["captures_in_timed_runs"]:
        raise AssertionError("programs captured in timed server passes")
    if line["max_batch_size"] < 2:
        raise AssertionError("the server never coalesced a batch")
    if not line["explain_has_server_section"]:
        raise AssertionError("explain through the server has no == server ==")
    return line


def flight_recorder(engine, queries, results) -> dict:
    """``trace=True``: each response's span tree, queue then batch,
    tiles its root within 10% (the JAX package's own bound), and
    ``dump_trace`` writes Chrome trace JSON."""
    tmp = Path(tempfile.mkdtemp(prefix="blend-trace-"))
    srv = DiscoveryServer(engine, max_batch=SERVER_BATCH, trace=True)
    try:
        got = [(label, resolved(f)) for label, f, _ in submit_all(
            srv, list(queries.items()))]
        path = srv.dump_trace(tmp / "server_trace.json")
        doc = json.loads(Path(path).read_text())
    finally:
        srv.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    gaps, bad = [], []
    need = ("queue", "batch", "pin_epoch", "execute", "drain", "transfer",
            "merge")
    for label, resp in got:
        root = resp.trace
        names = [s.name for s in root.walk()]
        covered = sum(c.duration for c in root.children)
        gaps.append(abs(root.duration - covered) / max(root.duration, 1e-9))
        if not same_response(resp, results[label]) or \
                any(n not in names for n in need) or \
                not any(n.startswith("probe:") for n in names) or \
                [c.name for c in root.children] != ["queue", "batch"] or \
                root.children[0].t0 != root.t0:
            bad.append(label)
    evs = doc["traceEvents"]
    out = {"requests": len(got), "events": len(evs),
           "max_tiling_gap": max(gaps),
           "requests_in_json": sum(e["ph"] == "X" and e["name"] == "request"
                                   for e in evs)}
    if bad or max(gaps) > 0.10 or out["requests_in_json"] != len(got) or \
            any(e["ph"] not in ("X", "M") for e in evs):
        raise AssertionError(f"flight recorder: {bad}, {out}")
    return out


class RecordingServer:
    """A server as ``loadgen.replay`` sees it, keeping every query's
    future beside its query."""

    def __init__(self, srv):
        self.srv, self.futures = srv, []

    def submit(self, query, **kw):
        fut = self.srv.submit(query, **kw)
        self.futures.append((query, fut))
        return fut

    def stats(self):
        return self.srv.stats()


def depth_sampler(srv, stop, peak):
    """Poll the lanes' queue depth every 2 ms into ``peak``."""
    while not stop.is_set():
        for lane, d in srv.stats()["queue_depth"].items():
            peak[lane] = max(peak.get(lane, 0), d)
        time.sleep(0.002)


def loadgen_replay(srv, trace, want, label) -> dict:
    """One open-loop replay of ``trace``: every completed response equal
    to its pool query's sequential ``serve``, every shed a typed
    ``Overloaded``, queue depth within each lane's bound."""
    import threading
    rec = RecordingServer(srv)
    before = srv.stats()
    peak, stop = {}, threading.Event()
    sampler = threading.Thread(target=depth_sampler, args=(srv, stop, peak))
    sampler.start()
    try:
        report = replay(rec, trace, timeout_s=300.0)
    finally:
        stop.set()
        sampler.join(timeout=10)
    after = report.server_stats
    bad, kinds = [], {}
    for q, fut in rec.futures:
        out = resolved(fut)
        kinds[type(out).__name__] = kinds.get(type(out).__name__, 0) + 1
        if isinstance(out, Overloaded):
            continue
        if not isinstance(out, DiscoveryResponse) or \
                not same_responses(out, want[id(q)]):
            bad.append(type(out).__name__)
    batches = after["batches"]["formed"] - before["batches"]["formed"]
    launches = after["launches"]["total"] - before["launches"]["total"]
    bounds = {name: cfg.max_queue
              for name, cfg in srv._former.lanes.items()}
    d = report.as_dict()
    line = {"phase": "server_loadgen", "trace": label,
            "offered_rps": trace.offered_rps, "offered": d["offered"],
            "completed": d["completed"], "shed": d["shed"],
            "shed_rate": report.shed_rate, "shed_reasons": d["shed_reasons"],
            "goodput_rps": report.goodput_rps,
            "makespan_s": report.makespan_s,
            "client_p50_ms": report.percentile_ms(50),
            "client_p99_ms": report.percentile_ms(99),
            "queue_p50_ms": percentile_ms(report.queue_s, 50),
            "queue_p99_ms": percentile_ms(report.queue_s, 99),
            "mean_batch_size": float(np.mean(report.batch_sizes))
            if report.batch_sizes else 0.0,
            "batches": batches,
            "launches_per_batch": launches / max(batches, 1),
            "peak_queue_depth": peak, "max_queue": bounds,
            "responses": kinds}
    emit(line)
    if bad:
        raise AssertionError(f"loadgen {label}: {len(bad)} responses differ "
                             f"from sequential serve: {bad[:5]}")
    if set(kinds) - {"DiscoveryResponse", "Overloaded"}:
        raise AssertionError(f"loadgen {label}: untyped responses {kinds}")
    over = {k: v for k, v in peak.items() if k in bounds and v > bounds[k]}
    if over:
        raise AssertionError(f"loadgen {label}: queue depth {over} over "
                             f"{bounds}")
    return line


def server_loadgen(lake, session) -> dict:
    """Phase 7, load generator, on phase 3's session: ``make_trace`` at
    each of ``LOADGEN_RATES`` (seed 0), a warm-up replay, the timed
    replays, then ``RetryingClient`` against a rate-limited server."""
    engine = DiscoveryEngine(None, session=session)
    traces = {rate: make_trace(lake, seed=SEED, duration_s=LOADGEN_SECONDS,
                               rate_rps=rate) for rate in LOADGEN_RATES}
    pool = {id(e.payload): e.payload for tr in traces.values()
            for e in tr.events if e.kind == "query"}
    # sequential answers, on this thread, before any server runs
    want = {key: engine.serve(q, fused=True) for key, q in pool.items()}
    srv = DiscoveryServer(engine, max_batch=SERVER_BATCH)
    warm = RecordingServer(srv)
    lines = {}
    try:
        # warm-up: the over-capacity trace without pacing builds the
        # programs of large batches
        replay(warm, traces[LOADGEN_RATES[-1]], sleep=lambda s: None,
               timeout_s=300.0)
        for rate, tr in traces.items():
            lines[rate] = loadgen_replay(srv, tr, want, f"{rate:g} rps")
    finally:
        srv.stop()
    pending = sum(not f.done() for _, f in warm.futures)
    if pending:
        raise AssertionError(f"{pending} futures pending after stop()")
    bad = [q for q, f in warm.futures if not isinstance(
        resolved(f), Overloaded) and not same_responses(f.result(),
                                                        want[id(q)])]
    if bad:
        raise AssertionError(f"{len(bad)} warm-up answers differ")
    lines["retrying_client"] = retrying_client(engine, pool, want)
    return lines


def retrying_client(engine, pool, want) -> dict:
    """``RetryingClient`` from ``SUBMITTERS`` threads against a server with
    a token bucket (``rate=``, ``burst=``) every thread shares: retries and
    gave-ups, and every answer equal to sequential ``serve``."""
    import threading
    srv = DiscoveryServer(engine, max_batch=SERVER_BATCH, rate=40.0,
                          burst=4.0)
    queries = list(pool.items())[:12]
    clients = [RetryingClient(srv, max_retries=3, seed=i)
               for i in range(SUBMITTERS)]
    answers, failures = [], []

    def run(client):
        try:
            for key, q in queries:
                answers.append((key, client.serve(q, tenant="shared")))
        except BaseException as e:                   # noqa: BLE001
            failures.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(c,)) for c in clients]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        srv.stop()
    wall = time.perf_counter() - t0
    if failures:
        raise AssertionError(f"retrying clients failed: {failures}")
    bad = [key for key, r in answers if not isinstance(r, Overloaded)
           and not same_responses(r, want[key])]
    line = {"phase": "server_retrying_client", "rate": 40.0, "burst": 4.0,
            "requests": len(answers), "seconds": wall,
            "retries": sum(c.retries for c in clients),
            "gave_up": sum(c.gave_up for c in clients),
            "backoff_s": sum(c.backoff_total_s for c in clients),
            "shed_rate_limit": srv.stats()["shed"]["rate_limit"]}
    emit(line)
    if bad:
        raise AssertionError(f"retrying client answers differ: {bad}")
    return line


def record_server(index, lake, queries):
    """The server path's kernel inputs: the eight queries as one batch and
    each load-generator pool query alone and the pool in batches, through
    a ``DiscoveryServer`` on a throwaway engine over ``index``."""
    def drive():
        engine = DiscoveryEngine(None, session=blend.Session(
            Executor(index, backend="bucket")))
        pool = query_pool(lake, np.random.default_rng(SEED))
        srv = DiscoveryServer(engine, max_batch=SERVER_BATCH, start=False)
        try:
            futs = [srv.submit(q) for q in [*queries.values(), *pool]]
            srv.start()                 # batches of 16, formed in order
            for f in futs:
                resolved(f)
            for q in pool:
                resolved(srv.submit(q))
        finally:
            srv.stop()
        torch.cuda.synchronize()
    return drive


def run_server_path(lake, session, queries, results) -> tuple:
    """Phase 7 on the static lake: the static part, the load generator,
    the kernels at the server path's inputs.  Returns (each kernel's
    launches in it, the number of distinct inputs of each checked against
    its plain version)."""
    t0 = time.perf_counter()
    reset_launches()
    server_static(session, queries, results)
    server_loadgen(lake, session)
    launches = kernel_launches()
    shapes = check_path_kernels(session, queries, "server_kernels",
                                record_server(session.index, lake, queries))
    emit({"phase": "server_summary", "seconds": time.perf_counter() - t0,
          "launches": launches})
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"the server path never launched {idle}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, shapes


def mapped_same(resp, want, tid, tid_want) -> bool:
    """``resp`` equals ``want`` with table ``tid`` read as ``tid_want`` (a
    re-added table may take a new id): ids and scores."""
    ids = [tid_want if t == tid else t for t in resp.table_ids]
    n = max(len(resp.scores), len(want.scores))
    a, b = np.zeros(n, np.float32), np.zeros(n, np.float32)
    a[:len(resp.scores)], b[:len(want.scores)] = resp.scores, want.scores
    moved = a[tid]
    a[tid] = 0.0
    a[tid_want] = moved
    return ids == want.table_ids and np.array_equal(a, b)


def record_server_live(store, queries):
    """The live server path's kernel inputs: the ten queries as one batch
    through a ``DiscoveryServer`` on a throwaway engine over ``store``."""
    def drive():
        engine = DiscoveryEngine(None, session=blend.Session(
            Executor(store, backend="bucket")))
        srv = DiscoveryServer(engine, max_batch=SERVER_BATCH, start=False)
        try:
            futs = [srv.submit(q) for q in queries.values()]
            srv.start()
            for f in futs:
                resolved(f)
        finally:
            srv.stop()
        torch.cuda.synchronize()
    return drive


def server_live(back, queries, guard, guard_tid) -> tuple:
    """Phase 7, live part, on phase 5's recovered session: from one thread,
    without waiting, twice over: the ten queries, ``add_table(guard)``, the
    ten, ``drop_table`` of it by name; then the ten once more.  The guard
    ranks first in the batches while it is live and never otherwise; every
    answer equals a sequential replay of the same operations on this thread
    after ``stop()``; once the first round has run each batch at each
    state, the mutations (into geometries seen before) build no program.
    ``guard_tid`` is the guard as phase 6 left it, live: it is dropped
    first.  Returns (each kernel's launches in it, the number of distinct
    inputs of each checked against its plain version)."""
    reset_launches()
    name = "live_guard_served"
    back.drop_table(guard_tid)
    engine = DiscoveryEngine(None, session=back)
    items = list(queries.items())
    marks = [sum(seek.TRACE_COUNTS.values())]   # programs, step by step

    def mark(_fut):                    # runs on the dispatcher thread
        marks.append(sum(seek.TRACE_COUNTS.values()))

    t0 = time.perf_counter()
    # a long window: each step's ten form one batch, cut by the barriers
    srv = DiscoveryServer(engine, max_batch=SERVER_BATCH,
                          interactive_window_s=0.5, batch_window_s=0.5)
    steps, muts = [], []
    try:
        for _ in range(2):
            steps.append(submit_all(srv, items))
            muts.append(srv.add_table(guard, name=name))
            muts[-1].add_done_callback(mark)
            steps.append(submit_all(srv, items))
            muts.append(srv.drop_table(name))
            muts[-1].add_done_callback(mark)
        steps.append(submit_all(srv, items))
        steps = [[(label, resolved(f)) for label, f, _ in fs]
                 for fs in steps]
        tids = [resolved(f) for f in muts]
    finally:
        srv.stop()
    batch_ms = histogram_ms(srv, "server.batch_seconds")
    mutation_ms = histogram_ms(srv, "server.mutation_seconds")
    wall = (time.perf_counter() - t0) * 1e3
    marks.append(sum(seek.TRACE_COUNTS.values()))
    built = [b - a for a, b in zip(marks, marks[1:])]
    launches = kernel_launches()
    # the sequential replay, from the same state, cold
    back.cache.clear()
    replayed, replay_tids = [], []
    for i in range(len(steps)):
        replayed.append({label: engine.serve(q, fused=True)
                         for label, q in items})
        if i < len(muts):
            replay_tids.append(back.add_table(guard, name=name) if i % 2 == 0
                               else back.drop_table(name))
    bad = [f"mutation {i}" for i, (a, b) in enumerate(zip(tids[::2],
                                                          tids[1::2]))
           if a != b]
    for i, (step, want) in enumerate(zip(steps, replayed)):
        live = i % 2 == 1
        tid, tid_want = (tids[i - 1], replay_tids[i - 1]) if live else (0, 0)
        for label, resp in step:
            if not mapped_same(resp, want[label], tid, tid_want):
                bad.append(f"step {i} {label}")
        for label in ("guard sc", "guard kw"):
            ids = dict(step)[label].table_ids
            if (live and ids[:1] != [tid]) or \
                    (not live and set(tids) & set(ids)):
                bad.append(f"step {i} {label} guard {ids[:3]}")
    line = {"phase": "server_live", "wall_ms": wall, "guard_tids": tids,
            "replay_guard_tids": replay_tids,
            "batch_sizes": [sorted({r.batch_size for _, r in step})
                            for step in steps],
            "programs_built_per_step": built, "batch_ms": batch_ms,
            "mutation_ms": mutation_ms, "launches": launches}
    emit(line)
    if bad:
        raise AssertionError(f"live server differs from the sequential "
                             f"replay: {bad}")
    if any(built[2:]):
        raise AssertionError(f"programs built after the first round: "
                             f"{built}")
    shapes = check_path_kernels(back, queries, "server_live_kernels",
                                record_server_live(back.live.store, queries))
    return launches, shapes


def superkey_digests(index):
    """One XASH digest per row of the lake: the index's superkeys at the
    postings of column 0, as int32 bit-views on the card."""
    first = index.col_id == 0
    return tuple(torch.from_numpy(np.ascontiguousarray(
        getattr(index, f)[first]).view(np.int32)).cuda()
        for f in ("superkey_lo", "superkey_hi"))


def qcr_groups(g, h, seed):
    """Sketch groups as benchmarks/bench_kernels.py makes them (quadrant and
    query bit uniform on {0, 1}, valid share 0.6), in slices of rows so the
    host never holds more than one slice of f64 draws."""
    rng = np.random.default_rng(seed)
    quad = np.empty((g, h), np.int8)
    qbit = np.empty((g, h), np.int8)
    valid = np.empty((g, h), bool)
    for lo in range(0, g, 1 << 16):
        hi = min(g, lo + (1 << 16))
        quad[lo:hi] = rng.integers(0, 2, (hi - lo, h))
        qbit[lo:hi] = rng.integers(0, 2, (hi - lo, h))
        valid[lo:hi] = rng.random((hi - lo, h)) < 0.6
    return tuple(torch.from_numpy(a).cuda() for a in (quad, qbit, valid))


def attention_inputs(dtype, b, sq, skv, widths, gen):
    h, kh, d = widths
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, skv, kh, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, skv, kh, d), generator=gen, device="cuda").to(dtype)
    return q, k, v


def attention_pairs(sq, skv, causal) -> int:
    """(query, key) pairs the function needs: the visible ones under the
    causal mask q_pos + (Skv - Sq) >= k_pos; a fully masked row averages
    every key."""
    if not causal:
        return sq * skv
    pairs = 0
    for r in range(sq):
        seen = min(skv, max(0, r + skv - sq + 1))
        pairs += seen if seen else skv
    return pairs


def entry_work(name, args, kwargs, out):
    """(bytes the function must move, operations, peak rate) for one call."""
    if name == "superkey_filter":
        sk_lo, _, q_lo, _ = args
        moved = 8 * sk_lo.numel() + 8 * q_lo.numel() + out.numel()
        return moved, 5 * out.numel(), SCALAR_OPS_PER_S
    if name == "qcr_score":
        quad, _, _ = args
        moved = 3 * quad.numel() + 4 * out.numel()
        # compare, AND, two counts per entry; five flops per group
        return moved, 4 * quad.numel() + 5 * out.numel(), SCALAR_OPS_PER_S
    q, k, v = args
    b, sq, h, d = q.shape
    pairs = attention_pairs(sq, k.shape[1], kwargs["causal"])
    moved = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    rate = TENSOR_BF16_OPS_PER_S if q.dtype == torch.bfloat16 \
        else F32_3XTF32_OPS_PER_S
    return moved, 4 * b * h * d * pairs, rate


def entry_cases(name, rows_sk, queries_sk, groups, gen):
    """Yields (label, args, kwargs) per case, the main input first; each
    case's tensors are made when it is reached."""
    if name == "superkey_filter":
        sk_lo, sk_hi = rows_sk
        q_lo, q_hi = queries_sk
        yield "main", (sk_lo, sk_hi, q_lo, q_hi), {}
        for t, n in ((5, 1000), (1, 1)):
            yield f"T={t} N={n}", (sk_lo[:n].clone(), sk_hi[:n].clone(),
                                   q_lo[:t].clone(), q_hi[:t].clone()), {}
    elif name == "qcr_score":
        main = qcr_groups(groups, QCR_H, SEED)
        yield "main", main, {}
        for g, h in ((1000, QCR_H), (7, 33), (1, 1)):
            yield f"G={g} H={h}", tuple(a[:g, :h].contiguous()
                                        for a in main), {}
    else:
        for label, dtype, causal, b, sq, skv, widths in ATTENTION_CASES:
            if dtype == ATTENTION_DTYPE[name]:
                yield label, attention_inputs(dtype, b, sq, skv, widths,
                                              gen), {"causal": causal}


def sdpa_call(q, k, v):
    """PyTorch's own attention on the same inputs, as a yardstick only;
    its is_causal aligns the mask top-left, so it is timed at Sq = Skv.
    bf16 takes SDPA's own choice of backend; f32 is held to its
    memory-efficient backend (3xTF32 on the tensor cores), with K/V
    repeated to H heads beforehand where that backend refuses GQA.
    Returns (call, how K/V reach the H heads)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.dtype == torch.bfloat16:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), "enable_gqa"
    gqa = "enable_gqa"
    params = torch.backends.cuda.SDPAParams(qt, kt, vt, None, 0.0, True, True)
    if not torch.backends.cuda.can_use_efficient_attention(params):
        g = q.shape[2] // k.shape[2]
        kt, vt = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
        gqa = "repeat_interleave outside the timed call"

    def call():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=gqa == "enable_gqa")
    return call, gqa


def sdpa_ms(q, k, v, flush) -> float:
    call, _ = sdpa_call(q, k, v)
    return time_ms(call, flush)


def sdpa_device_ms(q, k, v, flush) -> float:
    """SDPA's device time per call: its kernels, the ones ``sdpa_backend``
    names, summed."""
    call, _ = sdpa_call(q, k, v)
    return sum(device_kernels(call, flush).values())


def sdpa_backend(q, k, v, flush) -> dict:
    """What SDPA ran on these inputs: the device kernels of one profiled
    call, how K/V reach the H heads, and its own max |err| against the
    plain version."""
    call, gqa = sdpa_call(q, k, v)
    err = max_abs_err(call().transpose(1, 2), attention_ref(q, k, v))
    return {"kernels": sorted(device_kernels(call, flush, 1)), "gqa": gqa,
            "max_abs_err": err}


def over_library(ms, device_ms, library_ms, library_device_ms) -> dict:
    """The kernel's time over SDPA's, like with like: CUDA-event time over
    CUDA-event time, and profiler device time over device time."""
    return {"over_library": ms / library_ms,
            "over_library_device": device_ms / library_device_ms}


def attention_timing(args, kwargs, flush) -> dict:
    """Event and device ms of the attention kernel and of SDPA on one case,
    with the kernel's achieved TFLOP/s (by device time) and its time over
    SDPA's."""
    run = lambda: fa_ops.attention(*args, **kwargs)  # noqa: E731
    ms = time_ms(run, flush)
    device_ms = kernel_device_ms(run, "flash_attention_kernel", flush)
    lib, lib_device = sdpa_ms(*args, flush), sdpa_device_ms(*args, flush)
    _, ops, _ = entry_work("flash_attention", args, kwargs, None)
    return {"ms": ms, "device_ms": device_ms, "library_ms": lib,
            "library_device_ms": lib_device,
            "tflops": ops / device_ms / 1e9,
            **over_library(ms, device_ms, lib, lib_device)}


def attention_main(row) -> dict:
    """One attention kernel at its main input against its bound and SDPA."""
    ms = row["device_ms"]
    return {"ms": row["ms"], "device_ms": ms,
            "tflops": row["operations"] / ms / 1e9,
            "share_of_bound": row["bound_ms"] / ms,
            "bound_ms": row["bound_ms"], "library_ms": row["library_ms"],
            "library_device_ms": row["library_device_ms"],
            **over_library(row["ms"], ms, row["library_ms"],
                           row["library_device_ms"]),
            "sdpa": row["sdpa"], "max_abs_err": row["max_abs_err"]}


def attention_report(rows, timed) -> dict:
    """Both attention kernels at their main inputs against their bounds and
    SDPA, the timed cases, and the kernels' registers and spills
    (``-Xptxas -v``) and the bf16 kernel's dynamic shared memory per head
    dim."""
    lib = _build.library()
    return {
        "main": attention_main(rows["flash_attention"]),
        "main_f32": attention_main(rows["flash_attention_f32"]),
        "cases": timed,
        "ptxas": _build.ptxas_usage("flash_attention_kernel"),
        "tc_smem_bytes": {d: lib.flash_attention_tc_smem(d)
                          for d in fa_ops.HEAD_DIMS},
        "f32_smem_bytes": {d: lib.flash_attention_f32_smem(d)
                           for d in fa_ops.HEAD_DIMS},
    }


def run_entry_points(rows_sk, queries_sk, groups) -> dict:
    """Phase 4: each entry point driven, checked and timed, one at a time,
    its tensors freed before the next."""
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain attention is
    torch.backends.cudnn.allow_tf32 = False         # f32, not TF32
    flush = l2_flusher(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, timed = {}, {}
    for name, (mod, attr, plain, source, replaces) in ENTRY_KERNELS.items():
        cases = entry_cases(name, rows_sk, queries_sk, groups, gen)
        _, args, kwargs = next(cases)
        wrapper = getattr(mod, attr)
        for m, a, *_rest in ENTRY_KERNELS.values():
            getattr(m, a).launches = 0
        for _ in range(REPEATS):
            out = getattr(mod, attr)(*args, **kwargs)
        torch.cuda.synchronize()
        launches = wrapper.launches
        if launches == 0:
            raise AssertionError(f"entry point never launched {name}")

        errs = {}
        for label, case_args, case_kwargs in [("main", args, kwargs),
                                              *cases]:
            got = wrapper(*case_args, **case_kwargs)
            want = plain(*case_args, **case_kwargs)
            torch.cuda.synchronize()
            if got.dtype != want.dtype or got.shape != want.shape:
                raise AssertionError(f"{name} {label}: {got.dtype} "
                                     f"{list(got.shape)} against {want.dtype}"
                                     f" {list(want.shape)}")
            errs[label] = max_abs_err(got, want)
            atol = ATTENTION_ATOL[got.dtype] if name in ATTENTION_DTYPE \
                else 0.0
            if not math.isfinite(errs[label]) or errs[label] > atol or \
                    (atol == 0.0 and not torch.equal(got, want)):
                raise AssertionError(f"{name} {label} disagrees with its "
                                     f"plain version: max |err| "
                                     f"{errs[label]} > {atol}")
            if label in ATTENTION_TIMED:
                timed[label] = attention_timing(case_args, case_kwargs, flush)
            del got, want, case_args
        moved, ops, rate = entry_work(name, args, kwargs, out)
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = ops / rate * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": errs["main"],
            "ms": time_ms(lambda: wrapper(*args, **kwargs), flush),
            "device_ms": kernel_device_ms(
                lambda: wrapper(*args, **kwargs),
                "flash_attention_kernel" if name in ATTENTION_DTYPE
                else f"{name}_kernel", flush),
            "plain_ms": time_ms(lambda: plain(*args, **kwargs), flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": sdpa_ms(*args, flush)
            if name in ATTENTION_DTYPE else None,
            "case_max_abs_err": errs,
            "shape": [list(a.shape) for a in args if torch.is_tensor(a)],
            "bytes": moved, "operations": ops,
        }
        if name in ATTENTION_DTYPE:
            rows[name]["library_device_ms"] = sdpa_device_ms(*args, flush)
            rows[name]["sdpa"] = sdpa_backend(*args, flush)
        if name == "superkey_filter":
            rows[name].update(store_rates(rows[name]))
            rows[name].update(fill_yardstick(out.shape, flush))
            rows[name]["ptxas"] = _build.ptxas_usage("superkey_filter")
        emit({"phase": "entry_point", **rows[name]})
        if name == "flash_attention_f32":
            emit({"phase": "attention", **attention_report(rows, timed)})
        del out, args, cases
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # a program that captured nothing would serve stale buffers
    warnings.filterwarnings("error", message=".*CUDA Graph is empty.*")
    card = card_line()
    emit({"phase": "setup", "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    lake = synthetic_lake(**LAKE)
    t1 = time.perf_counter()
    session = blend.connect(lake, backend="bucket")
    t2 = time.perf_counter()
    engine = session.executor.engine
    emit({"phase": "index", "lake": LAKE, "lake_seconds": t1 - t0,
          "connect_seconds": t2 - t1, "postings": session.index.n_postings,
          "bucket_bits": session.index.bucket_bits,
          "bucket_width": engine.config.bucket_widths[0]})
    queries = make_queries(lake)
    inputs, unfused_inputs, _ = record_kernel_inputs(session, queries)

    # the wide rows case and phase 4 keep the unfused MC stage's 256 query
    # digests and segment space
    _, _, q_lo, q_hi = unfused_inputs["superkey_filter_rows"][0]
    rows = check_kernels(inputs, wide_rows_input(
        engine, q_lo, q_hi, session.executor.m_cap_max))
    unfused = run_main_path(session, queries)
    results, launches, _ = unfused
    check_results(session, results)
    fused_launches = run_fused_path(session, queries, unfused)
    serve_launches, serve_shapes = run_serve_path(lake, session, queries,
                                                  unfused)
    server_launches, server_shapes = run_server_path(lake, session, queries,
                                                     results)
    live_launches, live_shapes, live_serve, (live_server, live_server_shapes) \
        = run_live_path(lake, queries, results, t2 - t1)
    for name, n in launches.items():
        rows[name]["launches"] = n
        rows[name]["fused_launches"] = fused_launches[name]
        rows[name]["live_launches"] = live_launches[name]
        rows[name]["live_shapes_checked"] = live_shapes[name]
        rows[name]["serve_launches"] = serve_launches[name] + \
            live_serve[name]
        rows[name]["serve_shapes_checked"] = serve_shapes[name]
        rows[name]["server_launches"] = server_launches[name] + \
            live_server[name]
        rows[name]["server_shapes_checked"] = server_shapes[name] + \
            live_server_shapes[name]

    # phase 4 inputs from the smoke lake, then free phases 1-3
    queries_sk = (q_lo.clone(), q_hi.clone())
    rows_sk = superkey_digests(session.index)
    groups = unfused_inputs["qcr_segments"][0][0].numel()
    del session, engine, inputs, unfused_inputs, results, unfused, q_lo, q_hi
    del lake
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows.update(run_entry_points(rows_sk, queries_sk, groups))
    emit({"phase": "entry_points", "seconds": time.perf_counter() - t0})
    emit({"phase": "replaced_kernels", "measured_in_this_run": False,
          **REPLACED})
    print(json.dumps({"kernels": list(rows.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
