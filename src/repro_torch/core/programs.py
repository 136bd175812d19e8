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
  operand, one graph launch.  A capture that fails raises; nothing runs
  the eager function in its place.
* On the CPU the function runs eagerly; the first call with a key is still
  marked, so the retrace-freedom contracts hold there as key discipline.

The kernel wrappers count launches in Python, which a replay does not run:
a program records how much each query-path wrapper's counter rose during
capture (when nothing ran), takes that back, and adds it on every replay.

A replay writes the graph's own output buffers, so a program's outputs are
valid until the next run of the same key; a caller that keeps one clones
it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import seekers as seek
from repro_torch.kernels.bucket_probe import ops as bucket_ops
from repro_torch.kernels.qcr_score import ops as qcr_ops
from repro_torch.kernels.superkey_filter import ops as sk_ops

#: the launch counters of the kernel wrappers a query program can capture
COUNTED = ((bucket_ops, "probe"), (sk_ops, "filter_candidates"),
           (qcr_ops, "score_segments"))

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
    """One captured program: static inputs, the graph, its outputs."""

    def __init__(self, fn, flat, layout, dev, device):
        self.buf = torch.empty(len(flat), dtype=torch.int32, device=device)
        self.dev_in = [torch.empty_like(t) for t in dev]
        self.load(flat, dev)

        def call():
            return fn(*_unpack(self.buf, layout), *self.dev_in)

        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream(device).wait_stream(side)
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = call()
        self.ticks = [a - b for a, b in zip(_counts(), before)]
        _add_counts([-n for n in self.ticks])     # capture launched nothing

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

    def __len__(self) -> int:
        return len(self._programs)

    def drop_where(self, pred):
        """Forget the programs whose key (as passed to ``run``) satisfies
        ``pred``."""
        self._programs = {full: prog for full, prog in self._programs.items()
                          if not pred(full[0])}

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
            prog = _Graph(fn, flat, layout, dev, self.device)
            self._programs[full] = prog
            seek._mark_trace(kind)
        else:
            prog.load(flat, dev)
        return prog.replay()
