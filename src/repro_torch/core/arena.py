"""The device arena a live lake's MatchEngine is a view of.

A live executor rebuilds its engine on every epoch change
(``Executor.refresh``).  If each rebuild concatenated the segments into new
tensors, every fused program captured as a CUDA graph (core/programs.py)
would keep reading the tensors of the epoch it was captured in, and a later
replay would answer from a stale epoch without any error.  So an executor
owns one arena:

* one buffer per posting key and one per numeric key, each sized on a
  power-of-two ladder of the total padded length;
* one flat buffer each for all segments' bucket keys and payloads, on the
  same kind of ladder;
* one ``alive`` buffer of ``[table_cap]``.

``fill`` lays the segments out at their cumulative offsets (the engine's
``seg_bounds``) and returns views of the buffers; the engine is built from
those views.  A refill writes in place, on the current stream (so replays
already queued finish first), and copies a segment's array only where that
region of the buffer does not already hold that very upload: an unchanged
segment at an unchanged offset costs nothing.  It copies from the segments'
memoized uploads, never from the arena itself (after a whole-run delete a
source and its target could overlap).

A program built over the views of one layout therefore reads whatever the
latest refill put there.  When a buffer must grow, it is allocated anew and
``generation`` moves on: programs keyed on an older generation read freed
buffers and are dropped by the executor.
"""
from __future__ import annotations

import torch

from repro_torch.core.index import _ceil_pow2

POSTING = ("hash", "table", "col", "row", "sk_lo", "sk_hi", "quadrant",
           "rank_conv", "rank_rand")
NUMERIC = ("num_rowkey", "num_table", "num_col", "num_quadrant",
           "num_rank_conv", "num_rank_rand")


class Arena:
    """Device buffers of one executor's live engines (module docstring)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.generation = 0
        self._buf: dict = {}
        #: buffer -> {offset: source tensor} as the last fill left it
        self._held: dict = {}
        #: bytes the last fill copied (a refresh's device-side cost)
        self.copied_bytes = 0

    def _reserve(self, name: str, n: int, dtype, exact: bool = False) -> bool:
        """Make buffer ``name`` hold ``n`` elements (exactly ``n`` with
        ``exact``, else at least, on the power-of-two ladder).  Returns
        True when it had to be allocated."""
        buf = self._buf.get(name)
        if buf is not None and buf.dtype == dtype and \
                (buf.shape[0] == n if exact else buf.shape[0] >= n):
            return False
        size = n if exact else _ceil_pow2(max(n, 1))
        self._buf[name] = torch.empty(size, dtype=dtype, device=self.device)
        self._held[name] = {}
        return True

    def _place(self, name: str, parts):
        """Copy each (offset, source) into buffer ``name`` unless that region
        already holds that very source (regions of one fill are disjoint,
        so a region the last fill left holding a source still holds it)."""
        buf, held, now = self._buf[name], self._held[name], {}
        for start, src in parts:
            if held.get(start) is not src:
                buf[start:start + src.numel()].copy_(src.reshape(-1))
                self.copied_bytes += src.numel() * src.element_size()
            now[start] = src
        self._held[name] = now

    def fill(self, seg_devs, seg_starts, num_starts, n, n_num, tables,
             alive):
        """Lay out segments: ``seg_devs`` are their ``device_arrays``,
        ``seg_starts`` / ``num_starts`` their posting / numeric offsets,
        ``n`` / ``n_num`` the padded totals, ``tables`` their (bucket keys,
        payload) pairs or None (sorted backend), ``alive`` the store's bool
        mask.  Returns (dev dict, bucket keys tuple, bucket payload tuple,
        alive tensor), views of the arena."""
        self.copied_bytes = 0
        grew = False
        for keys, total in ((POSTING, n), (NUMERIC, n_num)):
            for k in keys:
                grew |= self._reserve(k, total, seg_devs[0][k].dtype)
        grew |= self._reserve("alive", len(alive), torch.bool, exact=True)
        if tables is not None:
            sizes = [bh.numel() for bh, _ in tables]
            flat_starts = [sum(sizes[:i]) for i in range(len(sizes))]
            for k in ("bucket_hash", "bucket_payload"):
                grew |= self._reserve(k, sum(sizes), torch.int32)
        if grew:
            self.generation += 1
        for keys, starts in ((POSTING, seg_starts), (NUMERIC, num_starts)):
            for k in keys:
                self._place(k, [(s, d[k]) for s, d in zip(starts, seg_devs)])
        self._buf["alive"].copy_(torch.from_numpy(alive))
        dev = {k: self._buf[k][:n] for k in POSTING}
        dev.update({k: self._buf[k][:n_num] for k in NUMERIC})
        bh = bp = None
        if tables is not None:
            views = []
            for i, k in enumerate(("bucket_hash", "bucket_payload")):
                self._place(k, [(s, t[i]) for s, t in zip(flat_starts,
                                                          tables)])
                views.append(tuple(
                    self._buf[k][s:s + t[i].numel()].view(t[i].shape)
                    for s, t in zip(flat_starts, tables)))
            bh, bp = views
        return dev, bh, bp, self._buf["alive"]
