"""MatchEngine: the unified probe layer every seeker routes through.

One object owns the device-resident index tensors, the padded radix-bucket
layout and the low-level match primitives.  Two interchangeable probe
backends: ``"sorted"`` (``torch.searchsorted`` over the hash-sorted run) and
``"bucket"`` (the hand-written ``bucket_probe`` CUDA kernel over the padded
radix-bucket table; its plain PyTorch version for CPU tensors).  On the
bucket backend the MC bloom stage and the correlation scoring epilogue also
go through their kernels (``superkey_filter_rows``, ``qcr_segments``); the
sorted backend runs their plain versions, so it stays a kernel-free check of
the bucket backend on any device.  Seeker outputs are bit-identical across
backends and to the JAX package's engine.

* ``rowjoin(rowkeys, mask, row_cap)`` — the numeric-postings-by-row probe of
  the correlation seeker.
* ``bloom(...)`` — the MC seeker's XASH superkey containment stage.
* ``qcr(n_agree, n_all)`` — the correlation seeker's scoring epilogue.
* ``member(sorted_keys, queries)`` — batched sorted-membership (the MC
  validation join).

Keys are int32 in the order-preserving form of ``core/index.py``.  Gather
indices (``pidx``) are int64.  The engine holds one static segment; the
LiveLake segment fan-out and the per-row capped probe of fused execution
come with those slices.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.bucket_probe import ops as bucket_ops
from repro_torch.kernels.qcr_score import ops as qcr_ops
from repro_torch.kernels.qcr_score.ref import qcr_segments_ref
from repro_torch.kernels.superkey_filter import ops as sk_ops
from repro_torch.kernels.superkey_filter.ref import superkey_filter_rows_ref
from repro_torch.core.index import hash_keys, resolve_device

BACKENDS = ("sorted", "bucket")
#: bucket-table widths are padded to a multiple of one warp
WIDTH_ALIGN = 32


def _window(lo, count, q_mask, cap: int, n: int):
    """[nq, cap] gather window from per-query run starts and lengths."""
    lane = torch.arange(cap, device=lo.device)
    pidx = lo[:, None] + lane[None, :]
    valid = (lane[None, :] < count[:, None]) & q_mask[:, None]
    pidx = pidx.clamp(0, n - 1)
    overflow = torch.where(q_mask, (count - cap).clamp(min=0),
                           torch.zeros_like(count)).sum()
    return pidx, valid, overflow


def probe_sorted(sorted_keys, queries, q_mask, cap):
    """Match range per query in a sorted key array, expanded to [nq, cap].

    Returns (pidx i64 [nq, cap] clipped gather indices, valid bool [nq, cap],
    overflow = matches beyond cap, summed)."""
    return probe_sorted_bounded(sorted_keys, sorted_keys.shape[0], queries,
                                q_mask, cap)


def probe_sorted_bounded(sorted_keys, n_real: int, queries, q_mask, cap):
    """``probe_sorted`` over a length-padded sorted run: only the first
    ``n_real`` keys are live postings; clamping lo/hi to ``n_real`` keeps even
    queries that equal the sentinel padding from touching it."""
    lo = torch.searchsorted(sorted_keys, queries, side="left").clamp(max=n_real)
    hi = torch.searchsorted(sorted_keys, queries,
                            side="right").clamp(max=n_real)
    return _window(lo, hi - lo, q_mask, cap, sorted_keys.shape[0])


def sorted_member(sorted_keys, queries):
    """Batched membership: sorted_keys [B, M] row-sorted, queries [B, C] ->
    bool [B, C] (the MC validation join primitive)."""
    loc = torch.searchsorted(sorted_keys, queries).clamp(
        0, sorted_keys.shape[1] - 1)
    return torch.gather(sorted_keys, 1, loc) == queries


@dataclass(frozen=True)
class EngineConfig:
    """Static part of a MatchEngine."""
    backend: str
    bucket_bits: int
    bucket_width: int             # 0 on the sorted backend


class MatchEngine:
    """See module docstring.  Build with ``MatchEngine.from_index``."""

    def __init__(self, dev: dict, bucket_hashes, bucket_payload,
                 config: EngineConfig):
        self.dev = dev                      # device_arrays() tensors
        self.bucket_hashes = bucket_hashes  # int32 [2^bits, W] or None
        self.bucket_payload = bucket_payload
        self.config = config

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
        width = 0
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
            width = -(-bucket_width // WIDTH_ALIGN) * WIDTH_ALIGN
            bh_np, bp_np, layout_overflow = index.padded_buckets(width)
            if layout_overflow:
                raise AssertionError("lossless bucket layout overflowed")
            bh = torch.from_numpy(hash_keys(bh_np)).to(device)
            bp = torch.from_numpy(bp_np).to(device)
        return cls(dev, bh, bp, EngineConfig(
            backend=backend, bucket_bits=index.bucket_bits,
            bucket_width=width))

    @property
    def backend(self) -> str:
        return self.config.backend

    # ------------------------------------------------------------ primitives
    def probe(self, q_hash, q_mask, m_cap: int):
        """Postings window per query key: (pidx, valid, overflow)."""
        n = self.dev["hash"].shape[0]
        if self.config.backend == "sorted":
            return probe_sorted(self.dev["hash"], q_hash, q_mask, m_cap)
        hits = bucket_ops.probe(self.bucket_hashes, self.bucket_payload,
                                q_hash, self.config.bucket_bits)  # payload|-1
        hit = hits >= 0
        count = hit.sum(dim=1)
        # postings are bucket-contiguous and hash-sorted, so the matched
        # payloads form the run [base, base + count): recover the window
        # from the min payload instead of compacting the hit matrix
        base = torch.where(hit, hits, torch.full_like(hits, n)).amin(dim=1)
        return _window(base.to(torch.int64), count, q_mask, m_cap, n)

    def rowjoin(self, rowkeys, mask, row_cap: int):
        """Numeric-postings window per candidate rowkey: (nidx, nvalid)."""
        nidx, nvalid, _ = probe_sorted(self.dev["num_rowkey"], rowkeys, mask,
                                       row_cap)
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
