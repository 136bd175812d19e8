"""Keyed device programs: the port's counterpart of ``jax.jit``'s cache.

The fused path (core/fused.py) runs each seeker group and each plan's
combiner DAG as one device program, keyed on the same static key the JAX
package's jit sees (kind, capacity rung, padded widths, static arguments;
the DAG's instruction tuple and input shapes).

* On a CUDA device the first call with a key warms the function eagerly on
  a side stream (which also loads the kernels), captures it into a
  ``torch.cuda.CUDAGraph`` over static input buffers, and marks one new
  program (``seekers._mark_trace``).  Every call, the first included,
  copies its operands into those buffers and replays the graph: one
  host-to-device copy for all host operands, one device copy per device
  operand, one graph launch.  A capture that fails, or that records no
  work, raises; nothing runs the eager function in its place.  The
  garbage collector is off during a capture (it could free a dead
  program's graph there, which breaks the capture).
* On the CPU the function runs eagerly; the first call with a key is still
  marked, so the retrace-freedom contracts hold there as key discipline.

Memory.  Every program of a ``Programs`` captures into one shared graph
memory pool, which ``clear`` drops with the programs.  Sharing is safe
under two rules, and both must hold:

* **Outputs lie outside the pool.**  A capture into the pool may take any
  block an earlier capture freed, for its own temporaries or its results;
  a replay of the earlier program would then overwrite them.  So a
  program's output buffers are allocated before its capture, by the
  ordinary allocator, and the captured function ends by copying its
  results into them.  What a program holds for good is its static inputs
  and its static outputs; the pool holds only temporaries, which are dead
  when a replay ends.
* **Replays are serialized on one stream.**  Two programs replayed at once,
  or on two streams, would share those temporaries.  Every replay runs on
  the caller's current stream, and no two threads may replay programs of
  one ``Programs`` concurrently (serve/server.py gives one dispatcher
  thread the engine, on the device's default stream).

Threads.  PyTorch keeps the current device and stream per thread, so a
capture does not take them from its caller: it runs on its ``Programs``'s
device, on the side stream of its warm-up.  A capture is thread-local
(``capture_error_mode="thread_local"``): another thread may allocate,
copy, synchronize its own streams (``Stream.synchronize``, ``.item()``,
``.cpu()``) or replay on the card while it runs, a second session
included, without failing or invalidating it.  A device-wide sync is the
exception: CUDA forbids ``torch.cuda.synchronize()`` (and any other call
that waits on every stream of the device) while any stream of the device
is capturing.  Made from another thread during a capture, that call
raises in that thread (``torch.AcceleratorError``, a ``RuntimeError``:
"operation not permitted when stream is capturing") and invalidates the
capture, whose next launch and end raise "operation failed due to a
previous error during capture".  The capture is then discarded and taken
again once, into a fresh memory pool (PyTorch leaves the failed one
marked as recording, so no capture may use it again), and counted in the
``programs.recaptures`` metric; a second invalidation raises
``errors.CaptureFailed`` and caches nothing for the key.  The failed sync
is the caller's to handle: a thread that shares the card with a
capturing server syncs its own streams.
Captures themselves are serialized process-wide (``_CAPTURE``):
``torch.cuda.graph`` synchronizes the device and empties the allocator's
cache before it begins, which the allocator refuses while another capture
is underway, and the collector switch and the warning filter below are
process state.

The kernel wrappers count launches in Python, which a replay does not run:
a program records how much each query-path wrapper's counter rose during
capture (when nothing ran), takes that back, and adds it on every replay.

A replay writes the graph's own output buffers, so a program's outputs are
valid until the next run of the same key; a caller that keeps one clones
it.
"""
from __future__ import annotations

import gc
import math
import re
import threading
import warnings

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import seekers as seek
from repro_torch.errors import CaptureFailed
from repro_torch.kernels.bucket_probe import ops as bucket_ops
from repro_torch.kernels.qcr_score import ops as qcr_ops
from repro_torch.kernels.superkey_filter import ops as sk_ops

#: the launch counters of the kernel wrappers a query program can capture
COUNTED = ((bucket_ops, "probe"), (sk_ops, "filter_candidates"),
           (qcr_ops, "score_segments"))

#: serializes captures across threads (module docstring, "Threads")
_CAPTURE = threading.Lock()

#: a CUDA stream-capture error (cudaErrorStreamCapture*, codes 900-908), as
#: PyTorch words it or as the kernel launcher (``kernels/_build.py``) does
_CAPTURE_ERROR = re.compile(r"captur|cudaError 90[0-8]\b", re.IGNORECASE)

_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.int8): torch.int8,
           np.dtype(np.bool_): torch.bool}


def _pack(host):
    """Host operands (int32, int8 or bool numpy arrays) -> one flat int32
    array and the layout that ``_unpack`` reads them back with."""
    layout = tuple((a.shape, _DTYPES[a.dtype]) for a in host)
    flat = np.concatenate([a.astype(np.int32, copy=False).ravel()
                           for a in host]) if host else np.zeros(0, np.int32)
    return flat, layout


def _unpack(buf, layout):
    """Views of the flat int32 ``buf`` in each operand's shape and type."""
    out, off = [], 0
    for shape, dtype in layout:
        n = math.prod(shape)
        out.append(buf[off:off + n].view(shape).to(dtype))
        off += n
    return out


def _counts():
    return [getattr(mod, attr).launches for mod, attr in COUNTED]


def _add_counts(ticks):
    for (mod, attr), n in zip(COUNTED, ticks):
        getattr(mod, attr).launches += n


class _Graph:
    """One captured program: static inputs, the graph, static outputs."""

    def __init__(self, fn, flat, layout, dev, programs):
        device = programs.device
        self.buf = torch.empty(len(flat), dtype=torch.int32, device=device)
        self.dev_in = [torch.empty_like(t) for t in dev]
        self.load(flat, dev)

        def call():
            return fn(*_unpack(self.buf, layout), *self.dev_in)

        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warm = call()
        torch.cuda.current_stream(device).wait_stream(side)
        # outside the shared pool (module docstring)
        self.out = tuple(torch.empty_like(t) for t in warm)
        del warm
        # a capture another thread's device-wide call invalidated is taken
        # again once, into a fresh pool (module docstring, "Threads")
        for attempt in (0, 1):
            before = _counts()
            try:
                self.graph, caught = self._capture(call, side, device,
                                                   programs.pool())
                break
            except RuntimeError as e:
                if not _CAPTURE_ERROR.search(str(e)):
                    raise
                _add_counts([b - a for a, b in zip(_counts(), before)])
                programs.abandon_pool()
                if attempt:
                    raise CaptureFailed(
                        "a program's capture was invalidated twice by "
                        "another thread's device-wide call") from e
                obs.registry().counter("programs.recaptures").inc()
        self.ticks = [a - b for a, b in zip(_counts(), before)]
        _add_counts([-n for n in self.ticks])     # capture launched nothing
        for w in caught:
            if "CUDA Graph is empty" in str(w.message):
                raise RuntimeError("a program captured no work: its replay "
                                   "would leave its outputs as they were")
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)

    def _capture(self, call, side, device, pool):
        """One capture of ``call`` into a new graph -> (graph, the warnings
        it raised)."""
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE, torch.cuda.device(device):
            # the collector must not run inside the capture: freeing a
            # dead program's graph there is an operation a capture forbids,
            # and it invalidates the capture
            collecting = gc.isenabled()
            gc.disable()
            prev = torch.cuda.current_stream(device)
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    with torch.cuda.graph(graph, pool=pool, stream=side,
                                          capture_error_mode="thread_local"):
                        for static, t in zip(self.out, call()):
                            static.copy_(t)
            except RuntimeError:
                # a capture_end that raises skips the graph context's
                # restore of the caller's stream
                torch.cuda.set_stream(prev)
                raise
            finally:
                if collecting:
                    gc.enable()
        return graph, caught

    def load(self, flat, dev):
        # a pinned copy: the transfer is asynchronous, and the caching host
        # allocator keeps the block until the copy has run
        self.buf.copy_(torch.from_numpy(flat).pin_memory(), non_blocking=True)
        for static, t in zip(self.dev_in, dev):
            static.copy_(t)

    def replay(self):
        self.graph.replay()
        _add_counts(self.ticks)
        return self.out


class Programs:
    """The program cache of one executor's device."""

    def __init__(self, device: torch.device):
        self.device = device
        self._programs: dict = {}
        self._pool = None         # the graph memory pool captures share

    def __len__(self) -> int:
        return len(self._programs)

    def drop_where(self, pred):
        """Forget the programs whose key (as passed to ``run``) satisfies
        ``pred``."""
        self._programs = {full: prog for full, prog in self._programs.items()
                          if not pred(full[0])}

    def clear(self):
        """Forget every program and the memory pool their captures share."""
        self._programs = {}
        self._pool = None

    def pool(self):
        """The graph memory pool the next capture shares."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def abandon_pool(self):
        """Give later captures a fresh pool: PyTorch leaves a pool that a
        failed capture recorded to marked as recording, so no capture may
        use it again.  The programs captured into it keep it."""
        self._pool = None

    def run(self, key: tuple, kind: str, fn, host=(), dev=()):
        """``fn(*host operands on the device, *dev)`` -> tuple of tensors,
        through the program for ``key`` (see the module docstring).
        ``host`` are numpy arrays, ``dev`` tensors on this device."""
        flat, layout = _pack(host)
        full = (key, layout, tuple((tuple(t.shape), t.dtype) for t in dev))
        prog = self._programs.get(full)
        if self.device.type != "cuda":
            if prog is None:
                self._programs[full] = True
                seek._mark_trace(kind)
            return fn(*_unpack(torch.from_numpy(flat), layout), *dev)
        if prog is None:
            prog = _Graph(fn, flat, layout, dev, self)
            self._programs[full] = prog
            seek._mark_trace(kind)
        else:
            prog.load(flat, dev)
        return prog.replay()
