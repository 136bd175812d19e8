"""Size-tiered compaction: merge L0 deltas into larger segments off the
hot path.

Probe cost grows linearly with the segment count (each query window fans out
over every segment), so mutations are cheap but queries slowly degrade as
deltas accumulate.  Compaction restores the single-run fast path:

* tiers are powers of two of the live-posting count; when a tier collects
  ``tier_fanout`` runs they merge into one (which lands in a higher tier) —
  the classic size-tiered LSM policy, so each posting is rewritten
  O(log(total) / log(fanout)) times over its lifetime;
* merging drops tombstoned postings (garbage collection) and rebuilds the
  merged segment's bucket offsets and numeric view; freed table slots become
  reusable;
* ``compact_store(store, full=True)`` merges everything into one base
  segment — the state snapshots persist (store/snapshot.py);
* ``maybe_compact`` is the auto-trigger ``LiveLake`` runs after each
  mutation once the segment count crosses ``CompactionPolicy.max_segments``.

Merged segments keep *global* table ids — results and tombstone masks stay
valid across compactions.  ``compact_store(..., reclaim_ids=True)``
additionally remaps table ids onto the dense range [0, n_live), rewriting
the posting arrays' table-id columns; it returns the old->new mapping so
callers can translate previously returned ids.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.store.segments import (Segment, SegmentStore,
                                       segment_from_arrays)


@dataclass(frozen=True)
class CompactionPolicy:
    """Knobs for the auto-trigger (see module docstring)."""
    max_segments: int = 8        # auto-compact when len(segments) exceeds
    tier_fanout: int = 4         # runs per size tier before they merge
    pad_min: int = 256           # padded-length floor for merged segments


def merge_segments(store: SegmentStore, segs: list,
                   pad_min: int = 256) -> Segment | None:
    """Merge ``segs`` into one segment, dropping tombstoned postings.
    Returns None when nothing live remains."""
    parts = store.live_postings(segments=segs)
    if not len(parts["cell_hash"]):
        return None
    return segment_from_arrays(parts, bucket_bits=store.bucket_bits,
                               row_stride=store.row_stride, pad_min=pad_min,
                               seed=store.seed,
                               sketch_config=store.sketch_config)


def _tier(seg: Segment) -> int:
    return max(int(np.log2(max(seg.n_real, 1))), 0)


def maybe_compact(store: SegmentStore,
                  policy: CompactionPolicy | None = None) -> bool:
    """Auto-trigger: while the segment count exceeds the policy threshold,
    merge the fullest size tier (falling back to the smallest runs when no
    tier has collected ``tier_fanout`` members).  Returns True if any merge
    ran."""
    policy = policy or CompactionPolicy()
    ran = False
    while len(store.segments) > policy.max_segments:
        tiers: dict[int, list] = {}
        for s in store.segments:
            tiers.setdefault(_tier(s), []).append(s)
        full = [runs for runs in tiers.values()
                if len(runs) >= policy.tier_fanout]
        if full:
            victims = max(full, key=len)[: policy.tier_fanout]
        else:
            by_size = sorted(store.segments, key=lambda s: s.n_real)
            victims = by_size[: max(policy.tier_fanout, 2)]
        if len(victims) < 2:
            break
        store.replace_segments(victims,
                               merge_segments(store, victims,
                                              policy.pad_min))
        ran = True
    return ran


def compact_store(store: SegmentStore, policy: CompactionPolicy | None = None,
                  full: bool = False, reclaim_ids: bool = False):
    """Explicit compaction.  ``full=True`` merges every segment into one
    base (always garbage-collecting tombstones); otherwise runs the tiered
    policy.  With ``reclaim_ids=True`` (implies full) table ids are remapped
    onto [0, n_live); returns the {old_id: new_id} mapping, else None."""
    if reclaim_ids:
        full = True
    if full:
        victims = list(store.segments)
        merged = merge_segments(store, victims,
                                (policy or CompactionPolicy()).pad_min)
        store.replace_segments(victims, merged)
    else:
        maybe_compact(store, policy or
                      CompactionPolicy(max_segments=1, tier_fanout=2))
    if not reclaim_ids:
        return None
    live = store.live_ids()
    remap = {old: new for new, old in enumerate(live)}
    lut = np.zeros(store.n_tables, np.int32)
    for old, new in remap.items():
        lut[old] = new
    for i, seg in enumerate(store.segments):
        tid = lut[seg.table_id]          # pad rows map to slot 0: masked out
        store.segments[i] = Segment(
            cell_hash=seg.cell_hash, table_id=tid, col_id=seg.col_id,
            row_id=seg.row_id, superkey_lo=seg.superkey_lo,
            superkey_hi=seg.superkey_hi, quadrant=seg.quadrant,
            rank_conv=seg.rank_conv, rank_rand=seg.rank_rand,
            num_perm=seg.num_perm, num_rowkey=seg.num_rowkey,
            bucket_bits=seg.bucket_bits, bucket_offsets=seg.bucket_offsets,
            n_real=seg.n_real, n_num=seg.n_num,
            tables=tuple(sorted(remap[t] for t in seg.tables)),
            # sketches are id-free summaries: remapping is a pure re-keying
            sketches={remap[t]: sk for t, sk in seg.sketches.items()
                      if t in remap},
        ).with_row_stride(store.row_stride)
    names = [store.table_names[old] for old in live]
    rows = np.zeros_like(store.table_rows)
    alive = np.zeros_like(store.alive)
    rows[: len(live)] = store.table_rows[live]
    alive[: len(live)] = True
    store.table_names = names
    store.table_rows = rows
    store.alive = alive
    store.free_ids = []
    store.pending_dead = set()
    store.bump_epoch()
    return remap
