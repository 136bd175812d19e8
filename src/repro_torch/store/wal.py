"""Write-ahead log for LiveLake mutations: checksummed, append-only,
torn-tail-truncating.

Recovery contract (store/live.py ``LiveLake.recover``): the durable state
of a live lake is *latest snapshot + WAL suffix*.  Every acknowledged
mutation (``add_table`` / ``drop_table`` / ``compact``) appends one record
**after** the in-memory apply and **before** the call returns, so

* a crash before the append loses only an *unacknowledged* mutation —
  the caller never saw it succeed, so snapshot+WAL replay is consistent;
* a crash mid-append leaves a **torn tail**: the record fails its CRC (or
  is short) and nothing valid follows it, so replay truncates it — the
  half-written mutation was likewise never acknowledged;
* a CRC failure with valid records *after* it is real corruption, not a
  torn write, and raises :class:`~repro_torch.errors.WalReplayError` — silently
  truncating there would drop acknowledged mutations.

Record layout (little-endian)::

    u32 magic | u32 payload_len | u32 crc32(payload) | payload (JSON)

Each payload carries a monotone ``seq``; snapshot manifests store the
``wal_seq`` watermark at save time, so replay skips records the snapshot
already contains (the WAL is cleared after a successful snapshot, but the
watermark makes the crash-between-snapshot-and-clear window safe too).

Bit-identity: records log the *allocated* table id (and owning shard, for
sharded lakes) plus the post-mutation epoch, and replay pins all three —
recovered lakes answer queries with ids, scores AND epoch identical to the
uninterrupted run even though the recovered segment layout differs (segment
builds are bit-identical by construction; layout never changes scores).
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from contextlib import contextmanager
from pathlib import Path

import numpy as np

from repro_torch import faults, obs
from repro_torch.errors import WalReplayError

MAGIC = 0x424C5741                      # "BLWA"
_HEADER = struct.Struct("<III")         # magic, payload_len, crc32
#: sanity bound on one record's payload (a Table serialization is ~KBs;
#: anything past this is a corrupt length field, not a real record)
MAX_RECORD_BYTES = 1 << 28


def _json_default(v):
    """Normalize the rare non-JSON cell values exactly as core/hashing.py
    does before hashing (np scalars via bool/int/float, ``str`` fallback),
    so a logged Table *hashes identically* after the WAL round trip.
    Invoked lazily by ``json.dumps`` — plain str/float columns (the common
    case) serialize at C speed with no per-cell Python call."""
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return str(v)


def _encode(record: dict) -> bytes:
    payload = json.dumps(record, sort_keys=True, separators=(",", ":"),
                         default=_json_default).encode()
    return _HEADER.pack(MAGIC, len(payload), zlib.crc32(payload)) + payload


def _valid_record_at(data: bytes, off: int) -> bool:
    if len(data) - off < _HEADER.size:
        return False
    magic, length, crc = _HEADER.unpack_from(data, off)
    if magic != MAGIC or length > MAX_RECORD_BYTES:
        return False
    start = off + _HEADER.size
    if len(data) - start < length:
        return False
    return zlib.crc32(data[start:start + length]) == crc


def _valid_record_after(data: bytes, start: int) -> bool:
    """Any fully valid record beginning at or after ``start``?  Scans for
    the magic byte pattern — distinguishes a torn tail (nothing valid
    follows) from mid-log corruption (something does)."""
    needle = struct.pack("<I", MAGIC)
    pos = data.find(needle, start)
    while pos != -1:
        if _valid_record_at(data, pos):
            return True
        pos = data.find(needle, pos + 1)
    return False


def scan(path) -> tuple[list, int, bool]:
    """Parse a WAL file.  Returns ``(records, good_bytes, torn)`` where
    ``good_bytes`` is the offset of the first bad byte (== file size when
    clean) and ``torn`` flags a truncatable tail.  Raises
    :class:`WalReplayError` on mid-log corruption."""
    path = Path(path)
    if not path.exists():
        return [], 0, False
    data = path.read_bytes()
    records: list = []
    off = 0
    while off < len(data):
        if not _valid_record_at(data, off):
            # bad header/body at off: torn tail unless a later record is
            # intact (then truncating would drop acknowledged mutations)
            if _valid_record_after(data, off + 1):
                raise WalReplayError(
                    f"{path}: corrupt WAL record at byte {off} with valid "
                    f"records after it — refusing to truncate mid-log")
            return records, off, True
        _, length, _ = _HEADER.unpack_from(data, off)
        start = off + _HEADER.size
        records.append(json.loads(data[start:start + length]))
        off = start + length
    return records, off, False


def recover_records(path) -> tuple[list, int]:
    """Scan + physically truncate a torn tail, so post-recovery appends
    never interleave with garbage.  Returns ``(records, next_seq_floor)``
    — the max seq seen (0 for an empty/missing log)."""
    records, good, torn = scan(path)
    if torn:
        obs.registry().counter("wal.torn_truncated").inc()
        with open(path, "r+b") as f:
            f.truncate(good)
    last = max((int(r.get("seq", 0)) for r in records), default=0)
    return records, last


class WriteAheadLog:
    """Append-only redo log (see module docstring).

    ``fsync=True`` (the default) makes every append durable before the
    mutation is acknowledged; ``fsync=False`` trades the crash-durability
    of the last few records for mutation throughput (data still survives a
    *process* crash — the OS holds the page cache — just not a host crash).

    ``preallocate=N`` allocates the file in N-byte extents up front (the
    etcd/InnoDB redo-log technique): the per-append durability barrier is
    then ``fdatasync`` on a file whose size and extent map never change, so
    no metadata journal commit rides on every acknowledged mutation.  Same
    guarantee, much cheaper — the extent map itself is fsynced once per
    chunk.  Replay treats the zero-filled tail beyond the last record like
    any torn tail: truncated, never replayed."""

    def __init__(self, path, *, fsync: bool = True, start_seq: int = 0,
                 preallocate: int = 0):
        self.path = Path(path)
        self.fsync = fsync
        self.preallocate = int(preallocate)
        self._fd: int | None = None
        self._off = 0                 # logical tail: next append lands here
        self._alloc = 0               # allocated bytes (>= _off)
        scanned = 0
        if self.path.exists() and self.path.stat().st_size:
            # recover_records truncates any torn tail, so after it the file
            # ends exactly at the last durable record
            _, scanned = recover_records(self.path)
            self._off = self.path.stat().st_size
        self._seq = max(int(start_seq), scanned)
        reg = obs.registry()
        self._m_appends = reg.counter("wal.appends")
        self._m_bytes = reg.counter("wal.bytes")
        self._m_fsyncs = reg.counter("wal.fsyncs")

    @property
    def seq(self) -> int:
        """Seq of the last appended (or scanned) record."""
        return self._seq

    def _file(self) -> int:
        if self._fd is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
            self._alloc = os.fstat(self._fd).st_size
        return self._fd

    def _ensure_capacity(self, fd: int, need: int):
        """Preallocate the next extent chunk (and durably commit the new
        extent map once) so per-append barriers are metadata-free."""
        if self._off + need <= self._alloc:
            return
        new = self._off + max(need, self.preallocate)
        try:
            os.posix_fallocate(fd, self._alloc, new - self._alloc)
        except OSError:                 # fs without fallocate: plain appends
            self.preallocate = 0
            return
        os.fsync(fd)
        self._alloc = new

    def append(self, record: dict) -> int:
        """Durably append one record; returns its seq.  The caller applies
        the mutation in memory *first* — a crash in here loses only the
        not-yet-acknowledged mutation."""
        faults.checkpoint("wal.append.pre")
        seq = self._seq + 1
        buf = _encode(dict(record, seq=seq))
        fd = self._file()
        if self.preallocate:
            self._ensure_capacity(fd, len(buf))
        frac = faults.torn_fraction("wal.append.torn")
        if frac is not None:
            # torn write: a seeded strict prefix of the record lands on
            # disk, then the "process" dies — replay must truncate it
            cut = min(len(buf) - 1, max(1, int(len(buf) * frac)))
            os.pwrite(fd, buf[:cut], self._off)
            os.fsync(fd)
            faults.crash_now("wal.append.torn")
        os.pwrite(fd, buf, self._off)
        self._off += len(buf)
        if self.fsync:
            # inside a preallocated extent the size/extent metadata never
            # changes, so fdatasync is a full durability barrier
            (os.fdatasync if self.preallocate else os.fsync)(fd)
            self._m_fsyncs.inc()
        self._seq = seq
        self._m_appends.inc()
        self._m_bytes.inc(len(buf))
        faults.checkpoint("wal.append.post")
        return seq

    def sync(self):
        """Durability barrier: make every appended record durable now."""
        fd = self._file()
        (os.fdatasync if self.preallocate else os.fsync)(fd)
        self._m_fsyncs.inc()

    @contextmanager
    def group(self):
        """Group commit: appends inside the block skip their per-record
        barrier; one :meth:`sync` at exit makes the whole group durable
        (amortizing the device flush across the batch).  The caller must
        not acknowledge any grouped mutation before the block exits — a
        crash inside it loses the unacknowledged suffix, exactly like a
        crash inside a single append."""
        if not self.fsync:
            yield self
            return
        self.fsync = False
        try:
            yield self
        finally:
            self.fsync = True
            self.sync()

    def clear(self):
        """Drop every record (a snapshot now covers them).  The seq counter
        keeps counting — snapshot watermarks stay comparable across
        clears."""
        fd = self._file()
        os.ftruncate(fd, 0)
        self._off = self._alloc = 0
        if self.fsync:
            os.fsync(fd)

    def close(self):
        if self._fd is not None:
            # drop any preallocated zero tail so the file ends at the last
            # record (replay would truncate it anyway)
            os.ftruncate(self._fd, self._off)
            os.close(self._fd)
            self._fd = None

    def __del__(self):
        # release the raw fd on GC (os.open fds are not auto-closed), but
        # WITHOUT close()'s tidy truncation: an abandoned log must look
        # exactly like a crashed process's — recovery handles the tail
        fd, self._fd = self._fd, None
        if fd is not None:
            try:
                os.close(fd)
            except (OSError, TypeError):
                pass

    def __repr__(self):
        return f"WriteAheadLog({str(self.path)!r}, seq={self._seq})"
