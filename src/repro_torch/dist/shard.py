"""Sharded lakes: the segment store partitioned along the table axis, with
per-shard fused probes and a single cross-shard merge.

Layout.  A ``ShardedStore`` is a coordinator over ``n_shards`` ordinary
per-shard ``SegmentStore``s, each holding a *subset of whole tables* under
the store's global geometry (table-slot capacity, row stride, padded
max-cols are imposed identically on every shard, and table ids are
global).  Because a table's postings live wholly inside exactly one segment
— the LiveLake invariant — table-axis partitioning makes **every** seeker
fully shard-local: SC/KW distinct counts, MC superkey validation and the
correlation row-join all group by table, so a shard computes exact scores
for its own tables and literal zeros everywhere else.  The only cross-shard
operation left is summing the per-shard ``[n_seekers, n_tables]`` score
matrices — exact in f32 (one nonzero contributor per slot) and fused into
the single whole-DAG program (core/fused.py), so a whole plan still costs
``n_kinds + 1`` logical launches and results are bit-identical to a 1-shard
run on the same data (as long as no probe window overflows).

Mutations stay shard-local: ``add_table`` allocates a global id at the
coordinator and routes the new L0 delta to the least-loaded shard;
``drop_table`` tombstones in place on the owner.  Global geometry changes
(slot-capacity growth, row-stride widening, max-cols growth) are the one
coordinated path: they change the static shapes every shard's programs are
built for, so they land on *every* shard and bump its epoch.  The store's
``epoch`` is the tuple of shard epochs; it flows through the ordinary
``index_epoch_key`` fingerprint, so the query cache never serves results
staled by any shard's mutation.

Placement.  Shard ``i`` of ``N`` lives on ``cuda:(i % device_count)``
(``shard_devices``): one card holds every shard, four cards one shard
each.  On the CPU every shard is on the CPU.  The store itself is host
NumPy; ``ShardedExecutor`` places it and records the placement in
``store.devices`` (reported by ``shape()``).

``ShardedExecutor`` gives each shard its own engine, device arena
(core/arena.py) and program cache (core/programs.py) on the shard's device,
rebuilds only the shards whose epoch moved, and executes exclusively on the
fused path: core/fused.py dispatches each seeker group once per shard with
*per-shard* capacity windows (a shard only holds its own postings, so its
window can be a lower rung than the global one) and sums the per-shard
score matrices on the merge device (the executor's own, shard 0's) inside
the DAG program.
"""
from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from repro_torch.core.arena import Arena
from repro_torch.core.executor import Executor, keep_recent_programs
from repro_torch.core.index import _ceil_pow2, resolve_device, \
    validate_row_stride
from repro_torch.core.match import MatchEngine
from repro_torch.core.programs import Programs
from repro_torch.store.compact import (CompactionPolicy, compact_store,
                                       maybe_compact as _maybe_compact)
from repro_torch.store.segments import SegmentStore


def shard_devices(n_shards: int, device) -> list:
    """The device of each of ``n_shards`` shards served from ``device``:
    ``cuda:(i % device_count)`` on the card, so one card holds every shard
    and N cards one shard each; ``device`` itself for every shard
    elsewhere.  ``device=None`` means CUDA and raises without a card."""
    device = resolve_device(device)
    if device.type != "cuda":
        return [device] * n_shards
    n_dev = torch.cuda.device_count()
    return [torch.device("cuda", i % n_dev) for i in range(n_shards)]


class ShardedStore:
    """Coordinator over per-shard ``SegmentStore``s (see module docstring).

    Duck-types the executor/planner surface of a single ``SegmentStore``
    (``n_tables`` / ``max_cols`` / ``row_stride`` / ``host_counts`` /
    ``segments`` / ``epoch`` / ``shape`` / mutation API), so sessions,
    caches and cost models treat a sharded lake like any live store."""

    def __init__(self, lake=None, *, n_shards: int = 2, bucket_bits: int = 12,
                 seed: int = 0, with_quadrants: bool = True):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        tables = list(lake.tables) if lake is not None else []
        n = len(tables)
        # global geometry, imposed identically on every shard
        max_rows = max([t.n_rows for t in tables], default=1)
        row_stride = _ceil_pow2(max(max_rows, 1))
        table_cap = _ceil_pow2(max(n + SegmentStore.MIN_HEADROOM, 16))
        max_cols = max([t.n_cols for t in tables], default=1)
        validate_row_stride(table_cap, row_stride, max_rows)
        self.n_shards = n_shards
        #: each shard's device, once an executor placed the store (None
        #: while unplaced)
        self.devices = None
        # round-robin initial placement: global id g -> shard g % n_shards
        # (matches enumerate order, so LiveLake's id bookkeeping is exact)
        self.shards = []
        for s in range(n_shards):
            entries = [(g, t) for g, t in enumerate(tables)
                       if g % n_shards == s]
            names = [t.name if g % n_shards == s else None
                     for g, t in enumerate(tables)]
            self.shards.append(SegmentStore(
                bucket_bits=bucket_bits, seed=seed,
                with_quadrants=with_quadrants, entries=entries,
                table_names=names, table_cap=table_cap,
                row_stride=row_stride, max_cols=max_cols))

    # -------------------------------------------------------------- geometry
    @property
    def n_tables(self) -> int:
        return self.shards[0].n_tables

    @property
    def n_slots(self) -> int:
        return max(s.n_slots for s in self.shards)

    @property
    def max_cols(self) -> int:
        return max(s.max_cols for s in self.shards)

    @property
    def row_stride(self) -> int:
        return self.shards[0].row_stride

    @property
    def bucket_bits(self) -> int:
        return self.shards[0].bucket_bits

    @property
    def n_postings(self) -> int:
        return sum(s.n_postings for s in self.shards)

    @property
    def epoch(self) -> tuple:
        """Global epoch vector: one counter per shard.  Hashable, compares
        by value: the query-cache fingerprint and ``Executor.refresh`` use
        it exactly like the scalar epoch of a single store."""
        return tuple(s.epoch for s in self.shards)

    @property
    def segments(self) -> list:
        """All shards' segments (read-only concatenation: statistics and
        duck-type checks; mutations go through the shard owning a run)."""
        return [seg for s in self.shards for seg in s.segments]

    @property
    def alive(self) -> np.ndarray:
        out = self.shards[0].alive.copy()
        for s in self.shards[1:]:
            out |= s.alive
        return out

    @property
    def table_names(self) -> list:
        names = [None] * self.n_slots
        for s in self.shards:
            for i in range(s.n_slots):
                if s.alive[i] and s.table_names[i] is not None:
                    names[i] = s.table_names[i]
        return names

    @property
    def pending_dead(self) -> set:
        return set().union(*(s.pending_dead for s in self.shards))

    @property
    def quadrant(self):
        # cost_model only truth-tests this attribute (store duck type)
        return self.shards[0].quadrant

    @property
    def sketch_config(self):
        return self.shards[0].sketch_config

    def live_ids(self) -> list:
        return sorted(t for s in self.shards for t in s.live_ids())

    def storage_bytes(self) -> int:
        return sum(s.storage_bytes() for s in self.shards)

    # ------------------------------------------------------------ statistics
    def host_counts(self, q_hashes, live_only: bool = False,
                    per_shard: bool = False) -> np.ndarray:
        """Match counts per query hash.  ``per_shard=True`` returns the
        ``[n_shards, nq]`` matrix the fused dispatcher sizes per-shard probe
        windows from; the default sums it, identical to a 1-shard store's
        counts on the same data."""
        per = np.stack([s.host_counts(q_hashes, live_only=live_only)
                        for s in self.shards])
        return per if per_shard else per.sum(axis=0)

    def shape(self) -> dict:
        """Observable index shape (Session.explain): mesh layout plus
        per-shard segment/posting/tombstone counts."""
        tomb = sorted(str(s.table_names[t])
                      for s in self.shards for t in s.pending_dead)
        devices = self.devices or [None] * self.n_shards
        per = [{"shard": i, "device": str(d), "epoch": s.epoch,
                "segments": len(s.segments), "postings": s.n_postings,
                "live_tables": int(s.alive.sum()),
                "tombstones": len(s.pending_dead)}
               for i, (s, d) in enumerate(zip(self.shards, devices))]
        return {
            "mode": "sharded",
            "shards": self.n_shards,
            "mesh_shape": (self.n_shards,),
            "mesh_axes": ("shard",),
            "epoch": self.epoch,
            "segments": sum(len(s.segments) for s in self.shards),
            "postings": self.n_postings,
            "live_tables": int(self.alive.sum()),
            "tombstoned": tomb,
            "table_slots": self.n_tables,
            "row_stride": self.row_stride,
            "per_shard": per,
        }

    # ------------------------------------------------------------- mutations
    def resolve(self, ref) -> int:
        for s in self.shards:
            try:
                return s.resolve(ref)
            except KeyError:
                pass
        raise KeyError(f"no live table matching {ref!r}")

    def owner_of(self, ref) -> int:
        """Shard index owning a live table reference."""
        for i, s in enumerate(self.shards):
            try:
                s.resolve(ref)
                return i
            except KeyError:
                pass
        raise KeyError(f"no live table matching {ref!r}")

    def least_loaded(self) -> int:
        return min(range(self.n_shards),
                   key=lambda i: self.shards[i].n_postings)

    def _alloc_gid(self) -> int:
        # reuse a freed global id if any shard relinquished one; the new
        # owner may be a different shard: the old owner's slot is dead
        # everywhere, so ownership transfers cleanly
        for s in self.shards:
            if s.free_ids:
                return s.free_ids.pop()
        return self.n_slots

    def _sync_max_cols(self):
        """Propagate padded max-cols growth to every shard: it is a static
        seeker shape, so a grown shard and a stale shard must never serve
        the same query with different paddings."""
        mc = max(s._max_cols_real for s in self.shards)
        for s in self.shards:
            if s._max_cols_real != mc:
                before = s.max_cols
                s._max_cols_real = mc
                if s.max_cols != before:
                    s.bump_epoch()

    def add_table(self, table, name: str | None = None,
                  tid: int | None = None, shard: int | None = None) -> int:
        """Route one new table to the least-loaded shard under a
        coordinator-allocated global id.  Only that shard re-indexes (one L0
        delta); global geometry changes (stride widening, capacity growth,
        max-cols growth) are the exception and land on every shard.

        ``tid`` / ``shard`` pin the global id and destination shard: WAL
        replay (store/wal.py) uses both so a recovered lake reproduces the
        uninterrupted run's placement (and therefore its per-shard epochs,
        probe windows and future least-loaded routing) exactly."""
        name = table.name if name is None else name
        if table.n_rows > self.row_stride:
            for s in self.shards:
                s._widen_stride(table.n_rows)
                s.bump_epoch()
        if tid is None:
            gid = self._alloc_gid()
        else:
            gid = int(tid)
            for s in self.shards:
                if gid in s.free_ids:
                    s.free_ids.remove(gid)
        if gid >= self.n_tables:
            cap = self.n_tables
            while gid >= cap:
                cap *= 2
            for s in self.shards:
                s.grow_capacity(cap)      # bumps every shard's epoch
        dest = self.least_loaded() if shard is None else int(shard)
        self.shards[dest].add_table(table, name, tid=gid)
        self._sync_max_cols()
        return gid

    def drop_table(self, ref) -> int:
        """Tombstone on the owner shard (single-table L0 runs are removed
        outright, exactly like the single-store path)."""
        for s in self.shards:
            try:
                gid = s.resolve(ref)
            except KeyError:
                continue
            return s.drop_table(gid)
        raise KeyError(f"no live table matching {ref!r}")

    # ------------------------------------------------------------ compaction
    def maybe_compact(self, policy: CompactionPolicy | None = None) -> bool:
        ran = False
        for s in self.shards:
            ran |= _maybe_compact(s, policy)
        return ran

    def compact(self, policy: CompactionPolicy | None = None,
                full: bool = False, reclaim_ids: bool = False):
        if reclaim_ids:
            raise ValueError(
                "reclaim_ids is unsupported on a sharded lake: table ids "
                "are global across shards and results would be renumbered "
                "per shard")
        for s in self.shards:
            compact_store(s, policy, full=full)
        return None


class _Shard:
    """One shard's device state: its engine, the arena the engine views,
    the programs that read it, and the recent-config list that bounds
    them (``keep_recent_programs``).  An arena is tied to one device and
    its generation moves with this shard's epoch alone; the programs own
    one graph memory pool on that device."""

    def __init__(self, device: torch.device):
        self.arena = Arena(device)
        self.programs = Programs(device)
        self.engine = None
        self.epoch = None
        self.recent: list = []

    def program_key(self, *parts) -> tuple:
        """As ``Executor.program_key``, for a program reading this shard's
        engine."""
        return ("engine", self.arena.generation, self.engine.config) + parts


class ShardedExecutor(Executor):
    """Executor over a ``ShardedStore``: one engine, arena and program cache
    per shard on the shard's device (``shard_devices``), fused-path-only
    execution, per-shard epoch tracking (a shard-local mutation rebuilds
    exactly one engine).  The executor's own device is shard 0's: the DAG
    programs, which merge the shards, run there (``self.programs``)."""

    def __init__(self, store, m_cap_max: int = 1024, row_cap: int = 8,
                 backend: str = "sorted", bucket_width: int | None = None,
                 device=None):
        if not hasattr(store, "shards"):
            raise TypeError("ShardedExecutor needs a ShardedStore; use "
                            "Executor for single-device lakes")
        self.n_shards = store.n_shards
        self.devices = shard_devices(store.n_shards, device)
        store.devices = list(self.devices)
        self.shards = [_Shard(d) for d in self.devices]
        super().__init__(store, m_cap_max=m_cap_max, row_cap=row_cap,
                         backend=backend, bucket_width=bucket_width,
                         device=self.devices[0])
        self.arena = None             # each shard views its own arena

    @property
    def engines(self) -> list:
        return [sh.engine for sh in self.shards]

    def _build_engine(self):
        store = self.index
        if self.bucket_width is not None:
            raise ValueError(
                "bucket_width is not configurable on a live store: "
                "each segment sizes its own lossless bucket layout")
        for sh, shard in zip(self.shards, store.shards):
            if sh.epoch != shard.epoch:
                sh.engine = MatchEngine.from_store(shard, sh.arena,
                                                   backend=self.backend)
                sh.epoch = shard.epoch
                sh.recent = keep_recent_programs(
                    sh.programs, sh.recent, sh.arena.generation,
                    sh.engine.config)
        self.engine = self.shards[0].engine     # stats surface
        self._engine_epoch = store.epoch
        self.n_tables = store.n_tables
        self.max_cols = store.max_cols

    def reset_shard(self, s: int):
        """Throw away shard ``s``'s engine, arena and captured programs and
        rebuild them from the store: the recovery lever for a failed shard
        probe (core/fused.py retries exactly once on the rebuilt engine
        before dropping the shard from the merge).  A captured program
        holds pointers into the old arena, so it must not outlive it; the
        shard's queued work is waited for before they go.  Returns the
        fresh engine."""
        self._sync(self.devices[s])
        self.shards[s] = _Shard(self.devices[s])
        self._build_engine()
        return self.shards[s].engine

    def device_scope(self, s: int):
        """Shard ``s``'s device made current for the calling thread (its
        programs replay on that device's current stream)."""
        dev = self.devices[s]
        return torch.cuda.device(dev) if dev.type == "cuda" \
            else nullcontext()

    @staticmethod
    def _sync(device):
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()

    def synchronize(self):
        """Wait for the executor's queued work on every shard's device (the
        caller's current stream there), merge device included."""
        for d in dict.fromkeys(self.devices):
            self._sync(d)

    def run(self, plan, optimize: bool = True, cost_model=None,
            sync: bool = True, cache=None, fused: bool = True):
        # sharded plans execute on the fused path only: the per-shard
        # dispatch + merge epilogue IS the execution model (the unfused
        # node-at-a-time walk has no cross-shard merge)
        return super().run(plan, optimize=optimize, cost_model=cost_model,
                           sync=sync, cache=cache, fused=True)

    def run_seeker(self, spec, allowed=None, sync: bool = True):
        raise NotImplementedError(
            "single-seeker dispatch is not defined on a sharded lake; "
            "run a plan (fused path) instead")

    def _sketch_sources(self):
        # one host view per shard; table-axis partitioning makes the probe
        # shard-local (a shard's view is all-zero outside its own tables),
        # so the merge in sketch_probe is an exact elementwise sum
        return [shard.sketch_map() for shard in self.index.shards]
