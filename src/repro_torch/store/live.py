"""LiveLake: the mutable-lake facade over the segment store.

``repro_torch.connect(lake, live=True)`` builds one of these and wires it
into the Session, so discovery queries keep flowing while the lake
evolves::

    session = repro_torch.connect(lake, live=True)
    tid = session.add_table(table)        # L0 delta, no rebuild
    session.query(repro_torch.sc(values)) # observes the new table
    session.drop_table(tid)               # tombstone (or whole-run delete)
    session.compact()                     # merge deltas off the hot path
    session.snapshot("lake.snap")         # .npz + manifest for fast restart

Every mutation bumps the store epoch; executors notice on their next query
and refresh their MatchEngine (the memoized per-segment uploads are copied
into the executor's device arena where they changed; the host only ever
transfers the new delta).  Queries therefore always observe a consistent
epoch: a mutation never changes the index under a dispatched plan.

``auto_compact`` runs the size-tiered policy (store/compact.py) after each
``add_table`` once the segment count crosses the policy threshold.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

from repro_torch import faults, obs
from repro_torch.core.lake import Table
from repro_torch.errors import WalReplayError
from repro_torch.query.fingerprint import index_epoch_key
from repro_torch.store import snapshot as snap
from repro_torch.store import wal as walmod
from repro_torch.store.compact import (CompactionPolicy, compact_store,
                                       maybe_compact)
from repro_torch.store.segments import SegmentStore


def _pack_table(t: Table) -> dict:
    """WAL-record form of a Table.  Columns go in raw: the WAL encoder's
    ``default=`` hook (store/wal.py ``_json_default``) normalizes exotic
    cell values lazily so they hash identically after the round trip —
    keeping the append hot path free of per-cell Python work."""
    return {"name": t.name,
            "columns": [list(col) for col in t.columns],
            "col_names": list(t.col_names)}


def _unpack_table(d: dict) -> Table:
    return Table(d["name"], d["columns"], list(d["col_names"]))


class LiveLake:
    """Mutable lake handle: tables in, tables out, index stays resident.

    Mutations are serialized under an internal reentrant barrier lock:
    concurrent ``add_table`` / ``drop_table`` / ``compact`` calls never
    interleave inside the store, and a reader holding :meth:`barrier` pins
    the epoch, so a whole batch of queries observes exactly one consistent
    index epoch."""

    def __init__(self, lake=None, *, bucket_bits: int = 12, seed: int = 0,
                 policy: CompactionPolicy | None = None,
                 auto_compact: bool = True, store: SegmentStore | None = None,
                 wal=None):
        self.store = store if store is not None else SegmentStore(
            lake, bucket_bits=bucket_bits, seed=seed)
        self.policy = policy or CompactionPolicy()
        self.auto_compact = auto_compact
        self._barrier = threading.RLock()
        #: tid -> Table registry for live tables (empty after ``restore``:
        #: snapshots persist arrays, not cells)
        self.tables = {t: tab for t, tab in
                       enumerate(lake.tables)} if lake is not None else {}
        #: write-ahead log (path or WriteAheadLog): when set, every
        #: acknowledged mutation is durably logged; the WAL only covers
        #: *mutations*, so a lake opened non-empty needs one snapshot before
        #: its initial tables are recoverable
        if wal is not None and not hasattr(wal, "append"):
            wal = walmod.WriteAheadLog(wal)
        self.wal = wal

    # ------------------------------------------------------------- mutations
    @property
    def epoch(self) -> int:
        return self.store.epoch

    @contextmanager
    def barrier(self):
        """Hold the mutation barrier: while the context is open the store
        epoch cannot move (mutations block), so a whole batch of queries
        dispatches against one consistent index.  Reentrant: a mutation
        running under the barrier does not deadlock itself."""
        with self._barrier:
            yield self

    def add_table(self, table, name: str | None = None, *,
                  tid: int | None = None, shard: int | None = None) -> int:
        """Add one table (L0 delta).  ``tid`` / ``shard`` pin the allocated
        id and destination shard — used by WAL replay so recovery
        reproduces the uninterrupted run's placement exactly."""
        with self._barrier, obs.registry().timer("store.add_table_seconds"):
            faults.checkpoint("store.add.pre")
            sharded = hasattr(self.store, "shards")
            if sharded:
                tid = self.store.add_table(table, name=name, tid=tid,
                                           shard=shard)
            else:
                tid = self.store.add_table(table, name=name, tid=tid)
            self.tables[tid] = table
            if self.auto_compact:
                if sharded:                         # sharded: per-shard tiers
                    self.store.maybe_compact(self.policy)
                else:
                    maybe_compact(self.store, self.policy)
            self._note_shape()
            self._log("add_table", {
                "table": _pack_table(table), "name": name, "tid": tid,
                "shard": self.store.owner_of(tid) if sharded else None})
            faults.checkpoint("store.add.post")
            return tid

    def add_tables(self, tables, names=None) -> list:
        """Bulk ingest with WAL group commit: every table is applied and
        logged like :meth:`add_table`, but the durability barrier runs once
        for the whole batch (the ack — this returning — waits for it).  The
        redo records are identical to N single adds, so recovery replays a
        grouped batch exactly like an ungrouped one."""
        names = list(names) if names is not None else [None] * len(tables)
        with self._barrier:
            if self.wal is not None:
                with self.wal.group():
                    return [self.add_table(t, name=n)
                            for t, n in zip(tables, names)]
            return [self.add_table(t, name=n) for t, n in zip(tables, names)]

    def drop_table(self, ref) -> int:
        with self._barrier, obs.registry().timer("store.drop_table_seconds"):
            faults.checkpoint("store.drop.pre")
            tid = self.store.drop_table(ref)
            self.tables.pop(tid, None)
            self._note_shape()
            self._log("drop_table", {"tid": tid})
            faults.checkpoint("store.drop.post")
            return tid

    def compact(self, full: bool = True, reclaim_ids: bool = False):
        """Explicit compaction; with ``reclaim_ids`` returns the old->new
        table-id mapping (and re-keys the Table registry)."""
        with self._barrier, obs.registry().timer("store.compact_seconds"):
            faults.checkpoint("store.compact.pre")
            if hasattr(self.store, "shards"):    # sharded: shard-local merges
                remap = self.store.compact(self.policy, full=full,
                                           reclaim_ids=reclaim_ids)
            else:
                remap = compact_store(self.store, self.policy, full=full,
                                      reclaim_ids=reclaim_ids)
                if remap is not None:
                    self.tables = {remap[t]: tab for t, tab in
                                   self.tables.items() if t in remap}
            self._note_shape()
            self._log("compact", {"full": bool(full),
                                  "reclaim_ids": bool(reclaim_ids)})
            faults.checkpoint("store.compact.post")
            return remap

    # -------------------------------------------------------------- WAL redo
    def _log(self, op: str, payload: dict):
        """Append one redo record *after* the in-memory apply, *before* the
        mutation call returns (see store/wal.py for the recovery contract).
        ``epoch`` is the post-mutation epoch — replay forces it, because the
        recovered segment layout (one merged base from the snapshot) makes
        auto-compaction trigger at different times than the uninterrupted
        run even though scores are layout-independent."""
        if self.wal is None:
            return
        epoch = self.store.epoch
        self.wal.append({"op": op, **payload, "epoch": list(epoch)
                         if isinstance(epoch, tuple) else epoch})

    def _apply_record(self, rec: dict):
        op = rec.get("op")
        if op == "add_table":
            self.add_table(_unpack_table(rec["table"]), name=rec.get("name"),
                           tid=rec["tid"], shard=rec.get("shard"))
        elif op == "drop_table":
            self.drop_table(rec["tid"])
        elif op == "compact":
            self.compact(full=rec.get("full", True),
                         reclaim_ids=rec.get("reclaim_ids", False))
        else:
            raise WalReplayError(f"unknown WAL op {op!r}")
        self._force_epoch(rec["epoch"])

    def _force_epoch(self, epoch):
        if hasattr(self.store, "shards"):
            for s, e in zip(self.store.shards, epoch):
                s.epoch = int(e)
        else:
            self.store.epoch = int(epoch)

    @classmethod
    def recover(cls, path=None, *, wal=None,
                policy: CompactionPolicy | None = None,
                auto_compact: bool = True, shards: int | None = None,
                fsync: bool = True) -> "LiveLake":
        """Rebuild a live lake from durable state: the latest good snapshot
        generation (if ``path`` is given and exists) plus a replay of every
        WAL record past the snapshot's ``wal_seq`` watermark.  Torn WAL
        tails are truncated before replay; the returned lake keeps logging
        to ``wal`` with the seq counter continued, so its next snapshot's
        watermark stays comparable.  The recovered lake answers queries with
        ids, scores and epoch bit-identical to the uninterrupted run.
        ``shards`` only matters on a cold start, which builds a sharded
        store (a snapshot already knows its shard layout)."""
        reg = obs.registry()
        with reg.timer("store.recover_seconds"):
            store = None
            watermark = 0
            if path is not None:
                try:
                    store = snap.load(path)
                except FileNotFoundError:
                    store = None            # cold start: WAL-only recovery
                else:
                    watermark = getattr(store, "recovered_wal_seq", 0)
            if store is None and shards:
                from repro_torch.dist.shard import ShardedStore
                store = ShardedStore(None, n_shards=shards)
            lake = cls(None, policy=policy, auto_compact=auto_compact,
                       store=store)
            replayed = 0
            if wal is not None:
                records, last = walmod.recover_records(wal)
                for r in records:
                    if int(r.get("seq", 0)) <= watermark:
                        continue
                    lake._apply_record(r)
                    replayed += 1
                lake.wal = walmod.WriteAheadLog(
                    wal, fsync=fsync, start_seq=max(last, watermark))
            reg.counter("wal.records_replayed").inc(replayed)
            return lake

    def _note_shape(self):
        """Post-mutation store-shape gauges.  ``compaction_debt`` is how far
        the segment count sits past the policy threshold — a growing debt
        means mutations are outrunning (or auto-compaction is not keeping up
        with) the size-tiered merge."""
        reg = obs.registry()
        if not reg.enabled:
            return
        s = self.store
        n_seg = len(s.segments)
        n_shards = len(s.shards) if hasattr(s, "shards") else 1
        reg.gauge("store.segments").set(n_seg)
        reg.gauge("store.postings").set(s.n_postings)
        reg.gauge("store.tombstones").set(len(s.pending_dead))
        reg.gauge("store.live_tables").set(len(s.live_ids()))
        reg.gauge("store.compaction_debt").set(
            max(0, n_seg - self.policy.max_segments * n_shards))

    # ----------------------------------------------------------- persistence
    def snapshot(self, path):
        """Save the compacted live index; returns the manifest path."""
        with self._barrier:
            seq = self.wal.seq if self.wal is not None else 0
            out = snap.save(self.store, path, wal_seq=seq)
            if self.wal is not None:
                # records up to ``seq`` are covered by the snapshot; clear()
                # keeps the seq counter running so the watermark stays valid
                # even if we crash between the rename and this truncate
                self.wal.clear()
            return out

    @classmethod
    def restore(cls, path, *, policy: CompactionPolicy | None = None,
                auto_compact: bool = True, wal=None) -> "LiveLake":
        return cls(store=snap.load(path), policy=policy,
                   auto_compact=auto_compact, wal=wal)

    # ------------------------------------------------------------ inspection
    def cache_key(self) -> tuple:
        """``(epoch, store fingerprint)``: the query-cache invalidation key
        (query/fingerprint.py).  Every mutation above bumps the epoch, so a
        QueryCache validated against this key drops its result and seeker
        levels before the next query can observe the mutated index."""
        return index_epoch_key(self.store)

    def live_ids(self) -> list:
        return self.store.live_ids()

    def shape(self) -> dict:
        return self.store.shape()

    def __repr__(self):
        s = self.store
        return (f"LiveLake(tables={int(s.alive.sum())}, "
                f"segments={len(s.segments)}, postings={s.n_postings}, "
                f"epoch={s.epoch})")
