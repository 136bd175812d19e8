"""MatchEngine: the unified probe layer every seeker routes through.

One object owns the device-resident index tensors, the padded radix-bucket
layouts and the low-level match primitives.  The engine is segment-aware:
the resident index is an ordered list of immutable sorted segments (one
static segment from ``from_index``; a LiveLake base plus L0 deltas from
``from_store``), and

* ``probe(q_hash, q_mask, m_cap)`` fans out over the segments — each has
  its own sorted run, padded-bucket layout and ladder entry — and
  concatenates the per-segment posting windows along the match axis, so
  seekers see one ``[nq, n_segments * m_cap]`` window and stay unchanged;
* tombstone masks (dropped tables) are applied to ``valid`` inside
  ``probe`` / ``probe_capped`` / ``rowjoin``, *before* any group-by stage,
  so mutation parity with a from-scratch rebuild holds bit for bit.

Two interchangeable probe backends: ``"sorted"`` (``torch.searchsorted``
over each segment's hash-sorted run) and ``"bucket"`` (the hand-written
``bucket_probe`` CUDA kernel over each segment's padded radix-bucket table;
its plain PyTorch version for CPU tensors).  On the bucket backend the MC
bloom stage and the correlation scoring epilogue also go through their
kernels (``superkey_filter_rows``, ``qcr_segments``); the sorted backend
runs their plain versions, so it stays a kernel-free check of the bucket
backend on any device.  Seeker outputs are bit-identical across backends,
across mutation histories and to the JAX package's engine.

* ``rowjoin(rowkeys, mask, row_cap)`` — the numeric-postings-by-row probe of
  the correlation seeker (same fan-out over per-segment ``num_rowkey``
  runs).
* ``bloom(...)`` — the MC seeker's XASH superkey containment stage.
* ``qcr(n_agree, n_all)`` — the correlation seeker's scoring epilogue.
* ``member(sorted_keys, queries)`` — batched sorted-membership (the MC
  validation join).
* ``probe_capped(...)`` — ``probe`` with per-row capacities and per-row
  overflow, for the fused path's batched seekers (core/fused.py).

Keys are int32 in the order-preserving form of ``core/index.py``.  Gather
indices (``pidx``) are int64.  ``EngineConfig`` is the static part — the
JAX package's jit key, and part of every fused program's key here.  A live
engine's tensors are views of its executor's device arena
(core/arena.py), so programs captured over them read the current epoch.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.bucket_probe import ops as bucket_ops
from repro_torch.kernels.qcr_score import ops as qcr_ops
from repro_torch.kernels.qcr_score.ref import qcr_segments_ref
from repro_torch.kernels.superkey_filter import ops as sk_ops
from repro_torch.kernels.superkey_filter.ref import superkey_filter_rows_ref
from repro_torch.core.arena import Arena
from repro_torch.core.index import hash_keys, resolve_device

BACKENDS = ("sorted", "bucket")
#: bucket-table widths are padded to a multiple of one warp
WIDTH_ALIGN = 32


def _window(lo, count, q_mask, cap: int, n: int, row_caps=None):
    """[nq, cap] gather window from per-query run starts and lengths.  With
    ``row_caps`` (per-row capacities <= ``cap``) row i holds at most
    ``row_caps[i]`` matches and the overflow comes back per row; without,
    every row holds ``cap`` and the overflow is summed."""
    lane = torch.arange(cap, device=lo.device)
    pidx = lo[:, None] + lane[None, :]
    limit = count if row_caps is None else torch.minimum(count, row_caps)
    valid = (lane[None, :] < limit[:, None]) & q_mask[:, None]
    pidx = pidx.clamp(0, n - 1)
    over = (count - (cap if row_caps is None else row_caps)).clamp(min=0)
    over = torch.where(q_mask, over, torch.zeros_like(over))
    return pidx, valid, over.sum() if row_caps is None else over


def probe_sorted(sorted_keys, queries, q_mask, cap):
    """Match range per query in a sorted key array, expanded to [nq, cap].

    Returns (pidx i64 [nq, cap] clipped gather indices, valid bool [nq, cap],
    overflow = matches beyond cap, summed)."""
    return probe_sorted_bounded(sorted_keys, sorted_keys.shape[0], queries,
                                q_mask, cap)


def probe_sorted_bounded(sorted_keys, n_real: int, queries, q_mask, cap,
                         row_caps=None):
    """``probe_sorted`` over a length-padded sorted run: only the first
    ``n_real`` keys are live postings; clamping lo/hi to ``n_real`` keeps even
    queries that equal the sentinel padding from touching it.  ``row_caps``
    as in ``_window``: with them this is the JAX package's
    ``probe_sorted_capped`` (per-row capacities, per-row overflow)."""
    lo = torch.searchsorted(sorted_keys, queries, side="left").clamp(max=n_real)
    hi = torch.searchsorted(sorted_keys, queries,
                            side="right").clamp(max=n_real)
    return _window(lo, hi - lo, q_mask, cap, sorted_keys.shape[0], row_caps)


def sorted_member(sorted_keys, queries):
    """Batched membership: sorted_keys [B, M] row-sorted, queries [B, C] ->
    bool [B, C] (the MC validation join primitive)."""
    loc = torch.searchsorted(sorted_keys, queries).clamp(
        0, sorted_keys.shape[1] - 1)
    return torch.gather(sorted_keys, 1, loc) == queries


@dataclass(frozen=True)
class EngineConfig:
    """Static (hashable) part of a MatchEngine.

    ``seg_bounds`` / ``num_bounds`` are per-segment ``(start, length,
    n_real)`` triples into the concatenated device arrays: ``start`` is the
    segment's offset, ``length`` its padded extent, ``n_real`` the live
    postings within it."""
    backend: str
    bucket_bits: int
    bucket_widths: tuple          # per segment; () on the sorted backend
    seg_bounds: tuple             # ((start, length, n_real), ...)
    num_bounds: tuple             # ((start, length, n_real), ...)
    n_tables: int
    max_cols: int
    row_stride: int


def _width(need: int) -> int:
    return -(-need // WIDTH_ALIGN) * WIDTH_ALIGN


class MatchEngine:
    """See module docstring.  Build with ``MatchEngine.from_index`` (one
    static segment) or ``MatchEngine.from_store`` (LiveLake segments)."""

    def __init__(self, dev: dict, bucket_hashes, bucket_payload,
                 config: EngineConfig, alive=None):
        self.dev = dev                      # concatenated per-segment arrays
        self.bucket_hashes = bucket_hashes  # tuple of int32 [2^bits, W_i]
        self.bucket_payload = bucket_payload
        self.alive = alive                  # bool [n_tables] tombstone mask
        self.config = config

    # ------------------------------------------------------------- building
    @classmethod
    def from_index(cls, index, *, backend: str = "sorted",
                   bucket_width: int | None = None, device=None):
        """``device=None`` means CUDA and raises when no card is present;
        pass ``device="cpu"`` for the plain PyTorch path."""
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        device = resolve_device(device)
        dev = index.device_arrays(device)
        bh = bp = None
        widths = ()
        if backend == "bucket":
            # the layout must be lossless: a truncated bucket would drop
            # matches without any overflow accounting
            need = max(index.max_bucket_count(), 1)
            if bucket_width is None:
                bucket_width = need
            elif bucket_width < need:
                raise ValueError(
                    f"bucket_width={bucket_width} is smaller than the "
                    f"fullest bucket ({need}): probing would silently drop "
                    f"matches; raise bucket_width or bucket_bits")
            widths = (_width(bucket_width),)
            bh_np, bp_np, layout_overflow = index.padded_buckets(widths[0])
            if layout_overflow:
                raise AssertionError("lossless bucket layout overflowed")
            bh = (torch.from_numpy(hash_keys(bh_np)).to(device),)
            bp = (torch.from_numpy(bp_np).to(device),)
        n = index.n_postings
        m = len(index.num_rowkey)
        return cls(dev, bh, bp, EngineConfig(
            backend=backend, bucket_bits=index.bucket_bits,
            bucket_widths=widths, seg_bounds=((0, n, n),),
            num_bounds=((0, m, m),), n_tables=index.n_tables,
            max_cols=index.max_cols, row_stride=index.row_stride))

    @classmethod
    def from_store(cls, store, arena: Arena, *, backend: str = "sorted"):
        """Engine over a LiveLake ``SegmentStore`` on ``arena``'s device:
        the segments' memoized device uploads (the host only ever transfers
        a new segment) are laid out at their cumulative offsets in
        ``arena`` (the executor's own, see core/arena.py), and the
        per-segment bounds become the static config."""
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        device = arena.device
        segs = store.segments
        seg_bounds, num_bounds = [], []
        off = noff = 0
        for s in segs:
            seg_bounds.append((off, s.n_padded, s.n_real))
            num_bounds.append((noff, s.n_num_padded, s.n_num))
            off += s.n_padded
            noff += s.n_num_padded
        widths, tables = (), None
        if backend == "bucket":
            # each segment sizes its own lossless layout
            widths = tuple(_width(max(s.max_bucket_count(), 1))
                           for s in segs)
            tables = [s.device_buckets(w, start, device) for s, w, (
                start, _, _) in zip(segs, widths, seg_bounds)]
        dev, bh, bp, alive = arena.fill(
            [s.device_arrays(device) for s in segs],
            [b[0] for b in seg_bounds], [b[0] for b in num_bounds], off,
            noff, tables, store.alive)
        return cls(dev, bh, bp, EngineConfig(
            backend=backend, bucket_bits=store.bucket_bits,
            bucket_widths=widths, seg_bounds=tuple(seg_bounds),
            num_bounds=tuple(num_bounds), n_tables=store.n_tables,
            max_cols=store.max_cols, row_stride=store.row_stride),
            alive=alive)

    @property
    def backend(self) -> str:
        return self.config.backend

    # ------------------------------------------------------------ primitives
    def _probe_segment(self, i: int, q_hash, q_mask, m_cap: int, row_caps):
        """One segment's (pidx, valid, overflow) window, globally indexed;
        with ``row_caps`` per-row capacities and per-row overflow."""
        start, length, n_real = self.config.seg_bounds[i]
        if self.config.backend == "sorted":
            keys = self.dev["hash"][start:start + length]
            pidx, valid, ovf = probe_sorted_bounded(keys, n_real, q_hash,
                                                    q_mask, m_cap, row_caps)
            return pidx + start, valid, ovf
        n = self.dev["hash"].shape[0]
        hits = bucket_ops.probe(self.bucket_hashes[i], self.bucket_payload[i],
                                q_hash, self.config.bucket_bits)  # payload|-1
        hit = hits >= 0
        count = hit.sum(dim=1)
        # postings are bucket-contiguous and hash-sorted within the segment,
        # so the matched (globally offset) payloads form the run
        # [base, base + count): recover the window from the min payload
        # instead of compacting the hit matrix
        base = torch.where(hit, hits, torch.full_like(hits, n)).amin(dim=1)
        return _window(base.to(torch.int64), count, q_mask, m_cap, n,
                       row_caps)

    def _fan_out(self, q_hash, q_mask, m_cap: int, row_caps):
        parts = [self._probe_segment(i, q_hash, q_mask, m_cap, row_caps)
                 for i in range(len(self.config.seg_bounds))]
        if len(parts) == 1:
            pidx, valid, ovf = parts[0]
        else:
            pidx = torch.cat([p for p, _, _ in parts], dim=1)
            valid = torch.cat([v for _, v, _ in parts], dim=1)
            ovf = sum(o for _, _, o in parts)
        if self.alive is not None:
            valid = valid & self.alive[self.dev["table"][pidx]]
        return pidx, valid, ovf

    def probe(self, q_hash, q_mask, m_cap: int):
        """Postings window per query key: (pidx, valid, overflow), fanned
        out over the segments ([nq, n_segments * m_cap]) with tombstoned
        tables masked out of ``valid`` before any group-by stage.

        One uniform ``m_cap`` (sized from cross-segment total counts) is
        deliberate: per-segment caps would shrink the window when matches
        spread across segments, but each data-dependent cap combination
        would be its own program key.  Compaction, not cap tuning, bounds
        the fan-out cost."""
        return self._fan_out(q_hash, q_mask, m_cap, None)

    def probe_capped(self, q_hash, q_mask, m_cap: int, row_caps):
        """``probe`` with per-row match capacities ``row_caps`` (int32
        [nq], each <= ``m_cap``): the fused path concatenates several
        seekers' queries into one batch, and each row sees exactly the
        window its own seeker's launch would.  Returns per-row overflow
        instead of a batch total."""
        return self._fan_out(q_hash, q_mask, m_cap, row_caps)

    def rowjoin(self, rowkeys, mask, row_cap: int):
        """Numeric-postings window per candidate rowkey: (nidx, nvalid),
        fanned out over the per-segment (table, row)-sorted runs."""
        parts = []
        for start, length, n_real in self.config.num_bounds:
            keys = self.dev["num_rowkey"][start:start + length]
            nidx, nvalid, _ = probe_sorted_bounded(keys, n_real, rowkeys,
                                                   mask, row_cap)
            parts.append((nidx + start, nvalid))
        if len(parts) == 1:
            nidx, nvalid = parts[0]
        else:
            nidx = torch.cat([p for p, _ in parts], dim=1)
            nvalid = torch.cat([v for _, v in parts], dim=1)
        if self.alive is not None:
            nvalid = nvalid & self.alive[self.dev["num_table"][nidx]]
        return nidx, nvalid
    def bloom(self, pidx, qk_lo, qk_hi):
        """XASH superkey containment of query digests in the candidate rows
        at ``pidx`` [nt, cap]: (row_sk & q_sk) == q_sk."""
        cand_lo = self.dev["sk_lo"][pidx]
        cand_hi = self.dev["sk_hi"][pidx]
        if self.config.backend == "bucket":
            return sk_ops.filter_candidates(cand_lo, cand_hi, qk_lo, qk_hi)
        return superkey_filter_rows_ref(cand_lo, cand_hi, qk_lo, qk_hi)

    def qcr(self, n_agree, n_all, min_support: int = 3):
        """QCR epilogue |2a - n| / n with the support floor."""
        if self.config.backend == "bucket":
            return qcr_ops.score_segments(n_agree, n_all,
                                          min_support=min_support)
        return qcr_segments_ref(n_agree, n_all, min_support)

    def member(self, sorted_keys, queries):
        return sorted_member(sorted_keys, queries)
