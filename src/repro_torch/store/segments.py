"""LSM segments: the resident index as an ordered list of immutable runs.

A ``Segment`` is one hash-sorted posting run — exactly the arrays
``build_index`` produces, but (a) table ids are *global* (stable across
mutations, never renumbered by a merge), (b) every array is length-padded
onto a power-of-two ladder so segments of similar size share device shapes
(the program key), and (c) each segment carries its own bucket offsets,
padded-bucket layout and numeric (table, row) view.

Device uploads are torch tensors on an explicit device, memoized per device
on the immutable segment, with keys in the port's int32 form
(core/index.py: ``hash_keys``, ``h ^ 2^31``; superkeys as int32 bit-views).
The executor's engine is a view of one device arena into which these
uploads are copied (core/arena.py).

Invariant: a table's postings live wholly inside exactly one segment.  That
keeps per-query match runs contiguous per segment (the seekers' adjacent-
dedupe stays exact) and lets ``drop_table`` of a single-table delta remove
the whole run instead of tombstoning it.

``SegmentStore`` is the mutable collection the executor talks to: it exposes
the same planner/statistics surface as ``UnifiedIndex`` (``host_counts``,
``row_stride``, ``n_tables``, ``storage_bytes``) plus the mutation API.
``n_tables`` is a padded *capacity* (slots), so adding a table within the
headroom keeps every seeker's static shape — and its programs — intact.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import torch

from repro_torch.core import hashing
from repro_torch.core.index import (POSTING_KEYS, UnifiedIndex, _ceil_pow2,
                                    bucket_offsets_for, concat_postings,
                                    hash_keys, numeric_view, sort_postings,
                                    table_postings, validate_row_stride)
from repro_torch.core.sketch import SketchConfig, sketch_tables

SEG_PAD_MIN = 256          # smallest padded segment length (postings)
PAD_RANK = np.int32(2 ** 31 - 1)   # pad rank: never < any h_sample


def _pad_len(n: int, lo: int = SEG_PAD_MIN) -> int:
    return _ceil_pow2(max(n, lo))


def _pad_to(a: np.ndarray, n: int, fill) -> np.ndarray:
    out = np.full(n, fill, a.dtype)
    out[: len(a)] = a
    return out


def _put(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclass(eq=False)            # identity semantics: runs are unique objects
class Segment:
    """One immutable sorted posting run (see module docstring).

    Arrays are padded to ``n_padded`` / ``n_num_padded``; only the first
    ``n_real`` / ``n_num`` entries are live postings.  The hash pad sentinel
    (``hashing.MISSING``) sorts last, and probing clamps to ``n_real`` so a
    padded tail can never match (core/match.py ``probe_sorted_bounded``)."""
    cell_hash: np.ndarray        # u32 [n_padded] sorted; MISSING tail
    table_id: np.ndarray         # i32 [n_padded] global table ids
    col_id: np.ndarray
    row_id: np.ndarray
    superkey_lo: np.ndarray
    superkey_hi: np.ndarray
    quadrant: np.ndarray
    rank_conv: np.ndarray
    rank_rand: np.ndarray
    num_perm: np.ndarray         # i32 [n_num_padded] segment-local indices
    num_rowkey: np.ndarray       # i32 [n_num_padded] sorted; int32-max tail
    bucket_bits: int
    bucket_offsets: np.ndarray   # i64 [2^bits + 1] over the real prefix
    n_real: int
    n_num: int
    tables: tuple                # global table ids wholly contained here
    #: approximate tier: {global_table_id: core.sketch.TableSketch}, a pure
    #: function of the live posting arrays + store seed + SketchConfig — so
    #: deltas, merges, snapshot reloads and rebuilds carry identical sketches
    sketches: dict = field(default_factory=dict, repr=False, compare=False)
    #: memoized device uploads, keyed by target device
    _dev: dict = field(default_factory=dict, repr=False, compare=False)
    _dev_buckets: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_padded(self) -> int:
        return len(self.cell_hash)

    @property
    def n_num_padded(self) -> int:
        return len(self.num_rowkey)

    def storage_bytes(self) -> int:
        core = sum(getattr(self, k).nbytes for k in POSTING_KEYS)
        return core + self.num_perm.nbytes + self.num_rowkey.nbytes + \
            self.bucket_offsets.nbytes

    # ---------------------------------------------------------------- device
    def device_arrays(self, device) -> dict:
        """The 15 tensors this segment contributes to the engine, on
        ``device`` (int32 key forms of core/index.py).  Memoized per device:
        a segment is immutable, so it is uploaded to each device at most
        once no matter how many engine refreshes it survives."""
        if device not in self._dev:
            p = self.num_perm
            live = np.arange(len(p)) < self.n_num
            self._dev[device] = {k: _put(a, device) for k, a in {
                "hash": hash_keys(self.cell_hash),
                "table": self.table_id,
                "col": self.col_id,
                "row": self.row_id,
                "sk_lo": self.superkey_lo.view(np.int32),
                "sk_hi": self.superkey_hi.view(np.int32),
                "quadrant": self.quadrant,
                "rank_conv": self.rank_conv,
                "rank_rand": self.rank_rand,
                "num_rowkey": self.num_rowkey,
                "num_table": self.table_id[p],
                "num_col": self.col_id[p],
                "num_quadrant": self.quadrant[p],
                "num_rank_conv": np.where(live, self.rank_conv[p], PAD_RANK),
                "num_rank_rand": np.where(live, self.rank_rand[p], PAD_RANK),
            }.items()}
        return self._dev[device]

    def max_bucket_count(self) -> int:
        return int(np.diff(self.bucket_offsets).max(initial=0))

    def padded_buckets(self, width: int):
        """Padded radix-bucket layout over the *real* prefix (pad postings
        are invisible to the bucket kernel: their payload stays -1)."""
        nb = 1 << self.bucket_bits
        bh = np.full((nb, width), hashing.MISSING, np.uint32)
        bp = np.full((nb, width), -1, np.int32)
        n = self.n_real
        shift = 32 - self.bucket_bits
        buckets = (self.cell_hash[:n] >> shift).astype(np.int64)
        starts = self.bucket_offsets[:-1]
        pos = np.arange(n, dtype=np.int64) - starts[buckets]
        keep = pos < width
        counts = np.diff(self.bucket_offsets)
        overflow = int(np.maximum(counts - width, 0).sum())
        bh[buckets[keep], pos[keep]] = self.cell_hash[:n][keep]
        bp[buckets[keep], pos[keep]] = np.nonzero(keep)[0].astype(np.int32)
        return bh, bp, overflow

    def device_buckets(self, width: int, payload_offset: int, device):
        """Device-side (bucket keys, bucket payload), int32 ``[2^bits,
        width]``, with payloads offset into the engine's concatenated
        arrays; memoized per (width, offset, device)."""
        key = (width, payload_offset, device)
        if key not in self._dev_buckets:
            bh, bp, overflow = self.padded_buckets(width)
            if overflow:
                raise AssertionError("segment bucket layout must be lossless")
            bp = np.where(bp >= 0, bp + payload_offset, -1).astype(np.int32)
            self._dev_buckets[key] = (_put(hash_keys(bh), device),
                                      _put(bp, device))
        return self._dev_buckets[key]

    # ------------------------------------------------------------- rekeying
    def with_row_stride(self, row_stride: int) -> "Segment":
        """Re-key the numeric view for a widened stride.  The (table, row)
        permutation is stride-invariant, so only ``num_rowkey`` values are
        recomputed — no re-sort, no re-upload of the posting arrays."""
        p = self.num_perm[: self.n_num]
        rk = self.table_id[p].astype(np.int64) * row_stride + \
            self.row_id[p].astype(np.int64)
        num_rowkey = _pad_to(rk.astype(np.int32), self.n_num_padded,
                             np.int32(2 ** 31 - 1))
        seg = Segment(
            cell_hash=self.cell_hash, table_id=self.table_id,
            col_id=self.col_id, row_id=self.row_id,
            superkey_lo=self.superkey_lo, superkey_hi=self.superkey_hi,
            quadrant=self.quadrant, rank_conv=self.rank_conv,
            rank_rand=self.rank_rand, num_perm=self.num_perm,
            num_rowkey=num_rowkey, bucket_bits=self.bucket_bits,
            bucket_offsets=self.bucket_offsets, n_real=self.n_real,
            n_num=self.n_num, tables=self.tables,
            sketches=self.sketches)    # stride doesn't touch cell content
        # only num_rowkey changed: carry the memoized uploads over so
        # widening never re-transfers the posting arrays
        for device, dev in self._dev.items():
            seg._dev[device] = dict(dev, num_rowkey=_put(num_rowkey, device))
        seg._dev_buckets = self._dev_buckets    # hash layout is unchanged
        return seg


def segment_from_arrays(parts: dict, *, bucket_bits: int, row_stride: int,
                        pad_min: int = SEG_PAD_MIN, seed: int = 0,
                        sketch_config: SketchConfig | None = None) -> Segment:
    """Sort + pad concatenated posting arrays into a Segment.

    Every segment-construction path (fresh build, L0 delta, compaction
    merge, snapshot reload) funnels through here, so the per-table sketches
    are computed in exactly one place — from the same posting arrays — and
    stay bit-identical across all of them."""
    parts = sort_postings(parts)
    sketches = sketch_tables(parts, seed=seed,
                             config=sketch_config or SketchConfig())
    n = len(parts["cell_hash"])
    bucket_offsets = bucket_offsets_for(parts["cell_hash"], bucket_bits)
    num_perm, num_rowkey = numeric_view(parts, row_stride)
    n_num = len(num_perm)
    np_ = _pad_len(n, pad_min)
    nnp = _pad_len(n_num, pad_min)
    tables = tuple(np.unique(parts["table_id"]).tolist())
    return Segment(
        cell_hash=_pad_to(parts["cell_hash"], np_, hashing.MISSING),
        table_id=_pad_to(parts["table_id"], np_, 0),
        col_id=_pad_to(parts["col_id"], np_, 0),
        row_id=_pad_to(parts["row_id"], np_, 0),
        superkey_lo=_pad_to(parts["superkey_lo"], np_, 0),
        superkey_hi=_pad_to(parts["superkey_hi"], np_, 0),
        quadrant=_pad_to(parts["quadrant"], np_, -1),
        rank_conv=_pad_to(parts["rank_conv"], np_, PAD_RANK),
        rank_rand=_pad_to(parts["rank_rand"], np_, PAD_RANK),
        num_perm=_pad_to(num_perm, nnp, 0),
        num_rowkey=_pad_to(num_rowkey, nnp, np.int32(2 ** 31 - 1)),
        bucket_bits=bucket_bits, bucket_offsets=bucket_offsets,
        n_real=n, n_num=n_num, tables=tables, sketches=sketches)


def build_segment(entries, *, bucket_bits: int, row_stride: int,
                  seed: int = 0, with_quadrants: bool = True,
                  pad_min: int = SEG_PAD_MIN,
                  sketch_config: SketchConfig | None = None) -> Segment:
    """Build one segment from ``entries`` = [(global_table_id, Table), ...].

    Uses the same per-table posting builder as ``build_index``
    (core/index.py ``table_postings``), so the arrays are bit-identical to
    the slice a from-scratch rebuild would hold for these tables."""
    parts = concat_postings([
        table_postings(tab, tid, seed=seed, with_quadrants=with_quadrants)
        for tid, tab in entries])
    return segment_from_arrays(parts, bucket_bits=bucket_bits,
                               row_stride=row_stride, pad_min=pad_min,
                               seed=seed, sketch_config=sketch_config)


class SegmentStore:
    """Mutable segmented index: base + L0 deltas + tombstones + epoch.

    Executor-facing surface (duck-typed with ``UnifiedIndex``):
    ``n_tables`` (slot capacity), ``max_cols`` (padded), ``row_stride``,
    ``host_counts``, ``n_postings``, ``storage_bytes``, ``epoch``.
    """

    #: slot-capacity headroom: adding this many tables never grows the
    #: score-vector shape (and therefore never builds new seeker programs)
    MIN_HEADROOM = 8

    def __init__(self, lake=None, *, bucket_bits: int = 12, seed: int = 0,
                 with_quadrants: bool = True, entries=None,
                 table_names=None, table_cap: int | None = None,
                 row_stride: int | None = None,
                 max_cols: int | None = None,
                 sketch_config: SketchConfig | None = None):
        """Default path: index every table of ``lake`` under global ids
        ``0..n-1``.  Shard path (sharding, ROADMAP A6): ``entries`` is an explicit
        ``[(global_id, Table), ...]`` subset and ``table_cap`` /
        ``row_stride`` / ``max_cols`` impose the *global* geometry, so every
        shard builds seekers against identical static shapes and the
        per-shard score vectors sum into the global one slot-for-slot."""
        self.bucket_bits = bucket_bits
        self.seed = seed
        self.with_quadrants = with_quadrants
        self.sketch_config = sketch_config or SketchConfig()
        if entries is None:
            tables = list(lake.tables) if lake is not None else []
            entries = list(enumerate(tables))
            table_names = [t.name for t in tables]
        else:
            entries = list(entries)
            table_names = list(table_names or [])
        owned = [t for _, t in entries]
        n_slots = max(len(table_names),
                      max([g for g, _ in entries], default=-1) + 1)
        table_names += [None] * (n_slots - len(table_names))
        self.table_names = table_names
        self._max_cols_real = max([t.n_cols for t in owned], default=1)
        if max_cols is not None:
            self._max_cols_real = max(self._max_cols_real, max_cols)
        max_rows = max([t.n_rows for t in owned], default=1)
        self.row_stride = row_stride if row_stride is not None else \
            _ceil_pow2(max(max_rows, 1))
        self._table_cap = table_cap if table_cap is not None else \
            _ceil_pow2(max(n_slots + self.MIN_HEADROOM, 16))
        validate_row_stride(self._table_cap, self.row_stride, max_rows)
        self.alive = np.zeros(self._table_cap, bool)
        self.table_rows = np.zeros(self._table_cap, np.int32)
        for gid, tab in entries:
            self.alive[gid] = True
            self.table_rows[gid] = tab.n_rows
        #: ids whose postings are fully gone (safe to hand out again)
        self.free_ids: list = []
        #: dropped ids whose postings still sit tombstoned in some segment
        self.pending_dead: set = set()
        self.epoch = 0
        self.segments: list[Segment] = [build_segment(
            entries, bucket_bits=bucket_bits,
            row_stride=self.row_stride, seed=seed,
            with_quadrants=with_quadrants,
            sketch_config=self.sketch_config)]

    # -------------------------------------------------------------- geometry
    @property
    def n_tables(self) -> int:
        """Slot capacity — the static score-vector length seekers are built
        for (live tables + tombstoned slots + headroom)."""
        return self._table_cap

    @property
    def n_slots(self) -> int:
        return len(self.table_names)

    @property
    def max_cols(self) -> int:
        return _ceil_pow2(max(self._max_cols_real, 4))

    @property
    def n_postings(self) -> int:
        return sum(s.n_real for s in self.segments)

    @property
    def quadrant(self):
        # cost_model only truth-tests this attribute (UnifiedIndex duck type)
        return self.segments[0].quadrant if self.segments else None

    def live_ids(self) -> list:
        return [t for t in range(self.n_slots) if self.alive[t]]

    def storage_bytes(self) -> int:
        return sum(s.storage_bytes() for s in self.segments)

    def bump_epoch(self):
        self.epoch += 1

    def _ensure_nonempty(self):
        # the engine fans out over segments; keep at least one (possibly
        # empty) run so an emptied-out lake still serves (zero-score) queries
        if not self.segments:
            self.segments.append(build_segment(
                [], bucket_bits=self.bucket_bits,
                row_stride=self.row_stride, seed=self.seed,
                with_quadrants=self.with_quadrants,
                sketch_config=self.sketch_config))

    # ------------------------------------------------------------ statistics
    def host_counts(self, q_hashes: np.ndarray,
                    live_only: bool = False) -> np.ndarray:
        """Match counts per query hash summed over segments (planner
        statistics).  ``live_only=False`` (the default) includes tombstoned
        postings — they still occupy probe-window slots, so match capacities
        must cover them; ``live_only=True`` subtracts them for cost
        estimates (core/optimizer.py seeker ranking)."""
        q = np.asarray(q_hashes)
        total = np.zeros(len(q), np.int64)
        for seg in self.segments:
            keys = seg.cell_hash[: seg.n_real]
            lo = np.searchsorted(keys, q, side="left")
            hi = np.searchsorted(keys, q, side="right")
            total += hi - lo
            if live_only:
                dead = ~self.alive[seg.table_id[: seg.n_real]]
                if dead.any():
                    csum = np.concatenate([[0], np.cumsum(dead)])
                    total -= csum[hi] - csum[lo]
        return total

    def shape(self) -> dict:
        """Observable index shape (Session.explain): segment/posting layout,
        tombstones and epoch."""
        return {
            "mode": "live",
            "epoch": self.epoch,
            "segments": len(self.segments),
            "postings_per_segment": [s.n_real for s in self.segments],
            "tables_per_segment": [len(s.tables) for s in self.segments],
            "live_tables": int(self.alive.sum()),
            "tombstoned": sorted(
                self.table_names[t] for t in self.pending_dead),
            "table_slots": self._table_cap,
            "row_stride": self.row_stride,
            "postings": self.n_postings,
        }

    # ------------------------------------------------------------- mutations
    def _alloc_id(self, name: str) -> int:
        if self.free_ids:
            tid = self.free_ids.pop()
            self.table_names[tid] = name
            return tid
        tid = self.n_slots
        if tid >= self._table_cap:
            # validate the grown capacity before mutating any state, so a
            # rejected add leaves the store untouched
            validate_row_stride(self._table_cap * 2, self.row_stride)
            self._table_cap *= 2
            self.alive = _pad_to(self.alive, self._table_cap, False)
            self.table_rows = _pad_to(self.table_rows, self._table_cap, 0)
        self.table_names.append(name)
        return tid

    def grow_capacity(self, new_cap: int):
        """Grow the table-slot capacity to ``new_cap`` (a power of two).
        Changes the static score-vector length every seeker is built
        for, so the epoch is bumped — a sharded lake must apply the
        same growth (and bump) on *every* shard to keep shapes aligned."""
        if new_cap <= self._table_cap:
            return
        validate_row_stride(new_cap, self.row_stride)
        self._table_cap = new_cap
        self.alive = _pad_to(self.alive, new_cap, False)
        self.table_rows = _pad_to(self.table_rows, new_cap, 0)
        self.bump_epoch()

    def _widen_stride(self, max_rows: int):
        stride = _ceil_pow2(max_rows)
        validate_row_stride(self._table_cap, stride, max_rows)
        self.segments = [s.with_row_stride(stride) for s in self.segments]
        self.row_stride = stride

    def resolve(self, ref) -> int:
        """Table reference (global id or name) -> live global id."""
        if isinstance(ref, str):
            matches = [t for t, n in enumerate(self.table_names)
                       if n == ref and self.alive[t]]
            if not matches:
                raise KeyError(f"no live table named {ref!r}")
            return matches[-1]
        tid = int(ref)
        if not (0 <= tid < self.n_slots and self.alive[tid]):
            raise KeyError(f"table id {tid} is not live")
        return tid

    def add_table(self, table, name: str | None = None,
                  tid: int | None = None) -> int:
        """Index one new table as an L0 delta segment; returns its global
        id.  No existing segment is touched (auto-widening the rowkey stride
        for an unusually long table re-keys, but never re-sorts, the
        numeric views).  ``tid`` pins the global id (sharded lakes allocate
        ids at the coordinator and route the table to one shard)."""
        name = table.name if name is None else name
        if table.n_rows > self.row_stride:
            self._widen_stride(table.n_rows)   # validates before allocating
        if tid is None:
            tid = self._alloc_id(name)
        else:
            if tid in self.free_ids:
                self.free_ids.remove(tid)
            if tid >= self._table_cap:
                cap = self._table_cap
                while tid >= cap:
                    cap *= 2
                self.grow_capacity(cap)
            if tid >= len(self.table_names):
                self.table_names += [None] * (tid + 1 -
                                              len(self.table_names))
            self.table_names[tid] = name
        self.alive[tid] = True
        self.table_rows[tid] = table.n_rows
        self._max_cols_real = max(self._max_cols_real, table.n_cols)
        self.segments.append(build_segment(
            [(tid, table)], bucket_bits=self.bucket_bits,
            row_stride=self.row_stride, seed=self.seed,
            with_quadrants=self.with_quadrants,
            sketch_config=self.sketch_config))
        self.bump_epoch()
        return tid

    def drop_table(self, ref) -> int:
        """Tombstone a table.  If it is the only live table of its segment,
        the whole run is removed (an LSM delete of the run) and the id is
        immediately reusable; otherwise its postings stay masked until the
        next compaction garbage-collects them."""
        tid = self.resolve(ref)
        self.alive[tid] = False
        self.table_rows[tid] = 0
        owner = next((s for s in self.segments if tid in s.tables), None)
        if owner is not None and not any(self.alive[t] for t in owner.tables):
            # every table of the run is dead: drop the run, free the slots
            self.segments.remove(owner)
            for t in owner.tables:
                self.pending_dead.discard(t)
                self.free_ids.append(t)
            self._ensure_nonempty()
        else:
            self.pending_dead.add(tid)
        self.bump_epoch()
        return tid

    def replace_segments(self, old: list, new: Segment | None):
        """Swap ``old`` segments for one merged segment (compaction commit).
        Tombstoned tables whose postings were dropped by the merge become
        free slots."""
        gone = {t for s in old for t in s.tables}
        if new is not None:
            gone -= set(new.tables)
        pos = min(self.segments.index(s) for s in old)
        self.segments = [s for s in self.segments if s not in old]
        if new is not None and new.n_real > 0:
            self.segments.insert(pos, new)
        for t in sorted(gone):
            if t in self.pending_dead:
                self.pending_dead.discard(t)
                self.free_ids.append(t)
        self._ensure_nonempty()
        self.bump_epoch()

    # ---------------------------------------------------------------- export
    def sketch_map(self) -> dict:
        """Live tables' sketches, unioned over segments.  A table's postings
        live wholly inside one segment (module invariant), so the union has
        no conflicts; tombstoned slots are dropped here."""
        out: dict = {}
        for seg in self.segments:
            for t, sk in seg.sketches.items():
                if self.alive[t]:
                    out[t] = sk
        return out

    def live_postings(self, segments=None) -> dict:
        """Concatenated live posting arrays (tombstones dropped, unsorted)
        of ``segments`` (default: all) — the one tombstone-GC collection
        path, shared by compaction merges and snapshots."""
        cols = {k: [] for k in POSTING_KEYS}
        for seg in (self.segments if segments is None else segments):
            keep = self.alive[seg.table_id[: seg.n_real]]
            for k in POSTING_KEYS:
                cols[k].append(getattr(seg, k)[: seg.n_real][keep])
        return {k: np.concatenate(v) if v else
                np.zeros(0, getattr(self.segments[0], k).dtype)
                for k, v in cols.items()}

    def merged_index(self) -> UnifiedIndex:
        """A compacted, tombstone-free ``UnifiedIndex`` view of the live
        postings (snapshot persistence consumes this; the store itself is
        not mutated)."""
        parts = sort_postings(self.live_postings())
        num_perm, num_rowkey = numeric_view(parts, self.row_stride)
        return UnifiedIndex(
            cell_hash=parts["cell_hash"], table_id=parts["table_id"],
            col_id=parts["col_id"], row_id=parts["row_id"],
            superkey_lo=parts["superkey_lo"],
            superkey_hi=parts["superkey_hi"], quadrant=parts["quadrant"],
            rank_conv=parts["rank_conv"], rank_rand=parts["rank_rand"],
            num_perm=num_perm, num_rowkey=num_rowkey,
            n_tables=self.n_tables, max_cols=self.max_cols,
            bucket_bits=self.bucket_bits,
            bucket_offsets=bucket_offsets_for(parts["cell_hash"],
                                              self.bucket_bits),
            table_rows=self.table_rows.copy(), row_stride=self.row_stride)
