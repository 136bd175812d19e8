"""LiveLake: incremental index maintenance for evolving lakes.

The resident unified index becomes an ordered list of immutable sorted
segments — one large base plus small L0 deltas — in the LSM style:

* :mod:`repro_torch.store.segments` — ``Segment`` (an immutable sorted
  posting run with its own bucket layout and padded ladder entry) and
  ``SegmentStore`` (the mutable, engine-facing collection: ``add_table`` /
  ``drop_table`` produce deltas and tombstones, never array rewrites).
* :mod:`repro_torch.store.compact` — size-tiered compaction merging deltas
  into larger segments off the hot path.
* :mod:`repro_torch.store.live` — the ``LiveLake`` facade wired into
  ``repro_torch.connect(lake, live=True)``.
* :mod:`repro_torch.store.snapshot` — versioned ``.npz`` + JSON-manifest
  persistence (checksummed, atomically committed, generation-retained).
* :mod:`repro_torch.store.wal` — checksummed write-ahead log; snapshot +
  WAL replay (``LiveLake.recover``) survives a crash at any fault point
  with bit-identical query results.

Every mutation bumps the store epoch; executors refresh their MatchEngine
lazily on the next query, and seeker outputs stay bit-identical to a
from-scratch rebuild of the mutated lake and to the JAX package's live
session (tests/test_torch_live.py).
"""
from repro_torch.store.compact import (CompactionPolicy, compact_store,
                                       maybe_compact)
from repro_torch.store.live import LiveLake
from repro_torch.store.segments import Segment, SegmentStore, build_segment
from repro_torch.store.wal import WriteAheadLog

__all__ = ["CompactionPolicy", "LiveLake", "Segment", "SegmentStore",
           "WriteAheadLog", "build_segment", "compact_store",
           "maybe_compact"]
