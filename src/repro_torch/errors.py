"""Typed fault hierarchy for the serving and durability layers.

One catchable base — :class:`BlendFault` — under every typed failure the
system can hand back instead of crashing or serving garbage:

* :class:`Overloaded` — admission control shed the request (rate limit or
  bounded-queue backpressure); carries ``retry_after_s`` for clients.
* :class:`DeadlineExceeded` — the request's deadline passed while it was
  still queued; it was never executed (the serving tier enforces deadlines
  at dispatch admission, so stale work is dropped, not computed).
* :class:`CorruptSnapshot` — a snapshot failed its format / version /
  checksum validation; ``store/snapshot.py`` falls back to the previous
  good generation instead of serving a torn or bit-flipped index.
* :class:`WalReplayError` — mid-log corruption in the write-ahead log
  (valid records exist *after* the bad one, so this is damage, not a torn
  tail; torn tails are silently truncated — see ``store/wal.py``).
* :class:`CaptureFailed` — a device program's CUDA-graph capture was
  invalidated twice in a row by another thread's device-wide call
  (``core/programs.py``); the request it served fails, the server goes on.

``Overloaded`` and ``DeadlineExceeded`` double as *response values*: the
server resolves futures with them rather than raising (shedding is policy,
not an error), and their ``ok=False`` field lets call sites branch without
isinstance checks.  Being exceptions too, a client that prefers raising can
``raise resp``.  ``CorruptSnapshot`` and ``WalReplayError`` additionally
subclass ``ValueError`` so pre-existing ``except ValueError`` callers (and
the version-check contract of older snapshots) keep working.
"""
from __future__ import annotations

from dataclasses import dataclass


class BlendFault(Exception):
    """Common base for every typed serving/durability fault."""


@dataclass
class Overloaded(BlendFault):
    """Typed rejection: the admission controller shed this request instead
    of queueing it unboundedly.  ``reason`` is ``'rate_limit'`` (tenant
    bucket empty; retry after ``retry_after_s``) or ``'queue_full'`` (lane
    backpressure).  ``ok`` distinguishes it from DiscoveryResponse without
    isinstance checks at call sites that only care about success."""
    reason: str
    lane: str
    tenant: str
    retry_after_s: float | None = None
    ok: bool = False


@dataclass
class DeadlineExceeded(BlendFault):
    """Typed rejection: the request's deadline passed while it was queued.
    It never reached the engine — deadline enforcement happens when a batch
    forms, so expired work is dropped before any device dispatch.
    ``waited_s`` is how long it sat queued before expiring."""
    lane: str
    tenant: str
    deadline_s: float | None = None
    waited_s: float = 0.0
    ok: bool = False


class CorruptSnapshot(BlendFault, ValueError):
    """A snapshot failed validation: wrong format, unsupported version,
    missing/truncated arrays, or a per-array checksum mismatch.  The loader
    falls back to the previous retained generation; this propagates only
    when no good generation remains."""


class WalReplayError(BlendFault, ValueError):
    """Mid-log WAL corruption: a record failed its magic/CRC check but
    valid records follow it, so truncating would silently drop acknowledged
    mutations.  (A bad *tail* with nothing valid after it is a torn write
    and is truncated without error.)"""


class CaptureFailed(BlendFault, RuntimeError):
    """A device program's CUDA-graph capture was invalidated, and so was
    the one retry (``core/programs.py``, "Threads"): another thread made a
    call that a capture in progress forbids, such as
    ``torch.cuda.synchronize()`` (a device-wide sync).  Nothing was cached
    for the program's key, so the next request with that key captures
    afresh.  The CUDA error is chained as ``__cause__``."""
