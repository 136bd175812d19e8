"""Snapshot persistence: a compacted index as ``.npz`` + JSON manifest.

``save`` writes the store's live postings (tombstones garbage-collected, one
merged run) to ``<path>.npz`` and a versioned JSON manifest to
``<path>.json`` holding everything array-free: format version, epoch, lake
stats, table slots/names and the index geometry.  ``load`` restores a fully
queryable ``SegmentStore`` — a server restart skips indexing entirely and
goes straight to device upload (benchmarks/run_all.py records the
load-vs-rebuild speedup in BENCH_3.json).

Durability hardening (format version 2):

* **per-array checksums** — the manifest carries a crc32 per saved array;
  ``load`` verifies them, so a truncated or bit-flipped ``.npz`` raises a
  typed :class:`~repro_torch.errors.CorruptSnapshot` instead of serving garbage;
* **atomic commit** — arrays and manifest are written to ``.tmp`` files and
  ``os.replace``d into place (manifest last: it is the commit point), so a
  crash mid-save never clobbers the previous good snapshot;
* **generation retention** — each save rotates the previous snapshot to
  ``<path>.npz.g1`` / ``.json.g1`` (up to ``retain`` generations);
  ``load`` falls back through generations on corruption and only raises
  when none validates;
* **WAL watermark** — ``wal_seq`` records the write-ahead-log position the
  snapshot covers, so ``LiveLake.recover`` replays exactly the suffix
  (store/wal.py);
* **sharded lakes** — a ``ShardedStore`` saves every shard's merged run
  into the *same* npz under ``s{i}:`` key prefixes plus one coordinator
  manifest (global geometry, per-shard epochs/names), keeping the
  two-rename commit atomic for the whole store.

Version-1 snapshots (no checksums, no ``wal_seq``, no pinned ``table_cap``)
still load; unsupported versions raise ``CorruptSnapshot`` (a
``ValueError``, preserving the old contract).

The snapshot holds array data only; it does not carry the original Table
objects, so a restored store serves queries and accepts new mutations but
cannot re-derive raw cell values.
"""
from __future__ import annotations

import json
import os
import zlib
from pathlib import Path

import numpy as np

from repro_torch import faults, obs
from repro_torch.core.index import POSTING_KEYS, _ceil_pow2
from repro_torch.core.sketch import SketchConfig
from repro_torch.errors import CorruptSnapshot
from repro_torch.store.segments import SegmentStore, segment_from_arrays

SNAPSHOT_FORMAT = "blend-livelake-snapshot"
SNAPSHOT_VERSION = 2
SUPPORTED_VERSIONS = (1, 2)
#: previous generations kept beside the current snapshot
RETAIN_GENERATIONS = 2


def _paths(path) -> tuple[Path, Path]:
    base = Path(path)
    if base.suffix in (".npz", ".json"):
        base = base.with_suffix("")
    return base.with_suffix(".npz"), base.with_suffix(".json")


def _gen_paths(path, g: int) -> tuple[Path, Path]:
    npz, man = _paths(path)
    if g == 0:
        return npz, man
    return Path(f"{npz}.g{g}"), Path(f"{man}.g{g}")


def _rotate(path, retain: int):
    """Shift generations one step: current -> .g1 -> .g2 ... (oldest
    dropped).  ``os.replace`` is atomic per file; a crash between renames
    leaves every touched generation intact under *some* name, which the
    fallback loader tolerates."""
    if retain <= 0:
        return
    oldest = _gen_paths(path, retain)
    for p in oldest:
        if p.exists():
            p.unlink()
    for g in range(retain - 1, -1, -1):
        for src, dst in zip(_gen_paths(path, g), _gen_paths(path, g + 1)):
            if src.exists():
                os.replace(src, dst)


def _checksums(arrays: dict) -> dict:
    return {k: zlib.crc32(np.ascontiguousarray(v).tobytes())
            for k, v in arrays.items()}


def _store_arrays(store: SegmentStore, prefix: str = "") -> dict:
    merged = store.merged_index()
    arrays = {prefix + k: getattr(merged, k) for k in POSTING_KEYS}
    n_slots = store.n_slots
    arrays[prefix + "table_rows"] = store.table_rows[:n_slots]
    arrays[prefix + "alive"] = store.alive[:n_slots]
    return arrays


def _commit(path, arrays: dict, manifest: dict, retain: int) -> Path:
    """Write-temp-then-rename commit of one snapshot generation."""
    npz_path, man_path = _paths(path)
    tmp_npz = Path(f"{npz_path}.tmp")
    tmp_man = Path(f"{man_path}.tmp")
    manifest = dict(manifest, checksums=_checksums(arrays))
    faults.checkpoint("snapshot.write.pre")
    with open(tmp_npz, "wb") as f:
        np.savez_compressed(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(tmp_man, "w") as f:
        f.write(json.dumps(manifest, indent=2, sort_keys=True) + "\n")
        f.flush()
        os.fsync(f.fileno())
    faults.checkpoint("snapshot.rename.pre")
    _rotate(path, retain)
    os.replace(tmp_npz, npz_path)
    os.replace(tmp_man, man_path)         # the commit point
    faults.checkpoint("snapshot.post")
    return man_path


def save(store, path, *, wal_seq: int = 0,
         retain: int = RETAIN_GENERATIONS) -> Path:
    """Write the compacted live index; returns the manifest path.  Accepts
    a single ``SegmentStore`` or a sharded coordinator (``.shards``)."""
    with obs.registry().timer("snapshot.save_seconds"):
        if hasattr(store, "shards"):
            return _save_sharded(store, path, wal_seq=wal_seq,
                                 retain=retain)
        arrays = _store_arrays(store)
        manifest = {
            "format": SNAPSHOT_FORMAT,
            "version": SNAPSHOT_VERSION,
            "epoch": store.epoch,
            "bucket_bits": store.bucket_bits,
            "row_stride": store.row_stride,
            "seed": store.seed,
            "with_quadrants": store.with_quadrants,
            "sketch": store.sketch_config.as_dict(),
            "max_cols": store._max_cols_real,
            "table_cap": store.n_tables,
            "table_names": list(store.table_names),
            "wal_seq": int(wal_seq),
            "lake_stats": {
                "tables": int(store.alive.sum()),
                "slots": store.n_slots,
                "postings": int(len(arrays["cell_hash"])),
            },
        }
        return _commit(path, arrays, manifest, retain)


def _save_sharded(store, path, *, wal_seq: int, retain: int) -> Path:
    arrays: dict = {}
    per_shard: list = []
    for i, s in enumerate(store.shards):
        arrays.update(_store_arrays(s, prefix=f"s{i}:"))
        per_shard.append({"epoch": s.epoch,
                          "table_names": list(s.table_names)})
    manifest = {
        "format": SNAPSHOT_FORMAT,
        "version": SNAPSHOT_VERSION,
        "shards": store.n_shards,
        "per_shard": per_shard,
        "epoch": list(store.epoch),
        "bucket_bits": store.bucket_bits,
        "row_stride": store.row_stride,
        "seed": store.shards[0].seed,
        "with_quadrants": store.shards[0].with_quadrants,
        "sketch": store.sketch_config.as_dict(),
        "max_cols": max(s._max_cols_real for s in store.shards),
        "table_cap": store.n_tables,
        "wal_seq": int(wal_seq),
        "lake_stats": {
            "tables": int(store.alive.sum()),
            "slots": store.n_slots,
            "postings": int(store.n_postings),
        },
    }
    return _commit(path, arrays, manifest, retain)


def _read_arrays(npz_path: Path, manifest: dict, keys: list) -> dict:
    """Load + checksum-verify the named arrays (v1 manifests carry no
    checksums and skip verification)."""
    try:
        with np.load(npz_path) as data:
            out = {k: data[k] for k in keys}
    except FileNotFoundError:
        raise
    except Exception as e:                       # truncated/bit-flipped zip
        raise CorruptSnapshot(f"{npz_path}: unreadable snapshot arrays "
                              f"({e})") from e
    sums = manifest.get("checksums")
    if sums is not None:
        for k, v in out.items():
            want = sums.get(k)
            got = zlib.crc32(np.ascontiguousarray(v).tobytes())
            if want is None or got != want:
                obs.registry().counter("snapshot.checksum_failures").inc()
                raise CorruptSnapshot(
                    f"{npz_path}: checksum mismatch on array {k!r} "
                    f"(expected {want}, got {got})")
    return out


def _new_store(manifest: dict, parts: dict, table_rows, alive,
               table_names: list, epoch: int) -> SegmentStore:
    """Rebuild one queryable ``SegmentStore`` from saved arrays (no
    re-indexing: no hashing, no superkeys — the saved arrays are re-padded
    into a single base segment; the stable re-sort of an already-sorted run
    is the only array pass)."""
    store = SegmentStore.__new__(SegmentStore)
    store.bucket_bits = int(manifest["bucket_bits"])
    store.seed = int(manifest["seed"])
    store.with_quadrants = bool(manifest["with_quadrants"])
    # additive manifest key: pre-sketch snapshots load under the default
    # config (sketches are recomputed from the arrays, not persisted)
    store.sketch_config = (SketchConfig.from_dict(manifest["sketch"])
                           if "sketch" in manifest else SketchConfig())
    store.table_names = list(table_names)
    store._max_cols_real = int(manifest["max_cols"])
    store.row_stride = int(manifest["row_stride"])
    n_slots = len(store.table_names)
    # v2 pins the padded slot capacity — the static score-vector length —
    # so recovery is shape-identical to the uninterrupted run; v1 recomputes
    store._table_cap = int(manifest["table_cap"]) if "table_cap" in manifest \
        else _ceil_pow2(max(n_slots + SegmentStore.MIN_HEADROOM, 16))
    store.alive = np.zeros(store._table_cap, bool)
    store.alive[:n_slots] = alive
    store.table_rows = np.zeros(store._table_cap, np.int32)
    store.table_rows[:n_slots] = table_rows
    store.free_ids = [t for t in range(n_slots) if not alive[t]]
    store.pending_dead = set()
    store.epoch = int(epoch)
    if len(parts["cell_hash"]):
        store.segments = [segment_from_arrays(
            parts, bucket_bits=store.bucket_bits,
            row_stride=store.row_stride, seed=store.seed,
            sketch_config=store.sketch_config)]
    else:
        store.segments = []
        store._ensure_nonempty()
    return store


def _load_one(path, g: int):
    npz_path, man_path = _gen_paths(path, g)
    try:
        manifest = json.loads(man_path.read_text())
    except FileNotFoundError:
        raise
    except Exception as e:
        raise CorruptSnapshot(f"{man_path}: unreadable manifest "
                              f"({e})") from e
    if manifest.get("format") != SNAPSHOT_FORMAT:
        raise CorruptSnapshot(
            f"{man_path} is not a {SNAPSHOT_FORMAT} manifest")
    if manifest.get("version") not in SUPPORTED_VERSIONS:
        raise CorruptSnapshot(
            f"snapshot version {manifest.get('version')} unsupported "
            f"(this build reads versions {SUPPORTED_VERSIONS})")
    if manifest.get("shards"):
        store = _load_sharded(npz_path, manifest)
    else:
        keys = list(POSTING_KEYS) + ["table_rows", "alive"]
        data = _read_arrays(npz_path, manifest, keys)
        parts = {k: data[k] for k in POSTING_KEYS}
        store = _new_store(manifest, parts, data["table_rows"],
                           data["alive"], manifest["table_names"],
                           manifest["epoch"])
    #: the WAL watermark this snapshot covers (LiveLake.recover reads it)
    store.recovered_wal_seq = int(manifest.get("wal_seq", 0))
    return store


def _load_sharded(npz_path: Path, manifest: dict):
    from repro_torch.dist.shard import ShardedStore
    n = int(manifest["shards"])
    keys = [f"s{i}:{k}" for i in range(n)
            for k in list(POSTING_KEYS) + ["table_rows", "alive"]]
    data = _read_arrays(npz_path, manifest, keys)
    store = ShardedStore.__new__(ShardedStore)
    store.n_shards = n
    store.devices = None              # placed by the executor built over it
    store.shards = []
    for i, sec in enumerate(manifest["per_shard"]):
        parts = {k: data[f"s{i}:{k}"] for k in POSTING_KEYS}
        store.shards.append(_new_store(
            manifest, parts, data[f"s{i}:table_rows"], data[f"s{i}:alive"],
            sec["table_names"], sec["epoch"]))
    # per-shard loaders mark every not-owned slot free; recompute globally
    # (a slot is free only if no shard holds it live) and park the free
    # list on shard 0: the coordinator's _alloc_gid scans all shards
    n_slots = max((len(s.table_names) for s in store.shards), default=0)
    alive_any = np.zeros(n_slots, bool)
    for s in store.shards:
        alive_any[:s.n_slots] |= s.alive[:s.n_slots]
        s.free_ids = []
    store.shards[0].free_ids = [t for t in range(n_slots) if not alive_any[t]]
    return store


def load(path, *, fallback: bool = True):
    """Restore a queryable store from ``save`` output.  On a corrupt
    current snapshot, falls back through retained generations
    (``<path>.npz.g1`` ...) and raises the *first* error only when no
    generation validates.  Missing snapshot -> ``FileNotFoundError``."""
    with obs.registry().timer("snapshot.load_seconds"):
        first_err = None
        g = 0
        while True:
            try:
                store = _load_one(path, g)
                if g:
                    obs.registry().counter(
                        "snapshot.generation_fallbacks").inc()
                return store
            except FileNotFoundError as e:
                if g == 0 and _gen_paths(path, 1)[1].exists():
                    # crash mid-rotation: current gone, older ones remain
                    first_err = CorruptSnapshot(
                        f"current snapshot missing ({e})")
                elif first_err is not None:
                    raise first_err
                else:
                    raise
            except CorruptSnapshot as e:
                if first_err is None:
                    first_err = e
                if not fallback:
                    raise
            g += 1
