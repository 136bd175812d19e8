"""Client-side retry policy for the serving front tier.

The server answers admission pressure with *typed values*, not exceptions:
``Overloaded(reason='rate_limit')`` carries ``retry_after_s`` (when the
tenant's token bucket will have refilled) and ``'queue_full'`` means lane
backpressure.  A well-behaved client therefore retries with **capped
exponential backoff seeded from the server's own hint** — never a tight
resubmit loop that amplifies the overload it is reacting to.

:class:`RetryingClient` wraps a ``DiscoveryServer`` (or anything with its
``submit`` signature) and encodes that policy::

    client = RetryingClient(server, max_retries=4)
    resp = client.serve(expr, tenant="alice")     # retries Overloaded
    client.stats()["retries"]                     # resubmission accounting

Only :class:`~repro_torch.errors.Overloaded` is retried.  A
:class:`~repro_torch.errors.DeadlineExceeded` is final by definition — the
caller's latency budget already passed, so a retry could only return an
answer nobody is waiting for; callers that still want one resubmit with a
fresh ``deadline_s``.  Backoff is seeded-deterministic: delays derive from
the client's own RNG, so trace replays reproduce.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.errors import Overloaded


class RetryingClient:
    """Submit-with-backoff wrapper (see module docstring).

    ``base_backoff_s * 2**attempt`` doubling, floored by the server's
    ``retry_after_s`` hint, capped at ``max_backoff_s``, then stretched by
    up to ``jitter`` (proportional, seeded) so synchronized clients don't
    retry in lockstep.  ``sleep``/``now`` are injectable for tests."""

    def __init__(self, server, *, max_retries: int = 4,
                 base_backoff_s: float = 0.01, max_backoff_s: float = 1.0,
                 jitter: float = 0.5, seed: int = 0,
                 sleep=time.sleep, now=time.monotonic):
        self.server = server
        self.max_retries = int(max_retries)
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self._rng = np.random.default_rng(seed)
        self._sleep = sleep
        self._now = now
        self.retries = 0              # resubmissions performed
        self.gave_up = 0              # still Overloaded after max_retries
        self.backoff_total_s = 0.0

    def backoff_s(self, resp, attempt: int) -> float:
        """Delay before retry number ``attempt + 1`` (0-based attempts)."""
        base = self.base_backoff_s * (2.0 ** attempt)
        if isinstance(resp, Overloaded) and resp.retry_after_s:
            base = max(base, float(resp.retry_after_s))
        delay = min(base, self.max_backoff_s)
        if self.jitter:
            delay *= 1.0 + self.jitter * float(self._rng.uniform(0.0, 1.0))
        return delay

    def submit_and_wait(self, query, **kw):
        """``submit().result()`` with the retry loop around it.  Returns
        the final response — a ``DiscoveryResponse``, a ``DeadlineExceeded``
        (never retried), or the last ``Overloaded`` when retries ran out."""
        for attempt in range(self.max_retries + 1):
            resp = self.server.submit(query, **kw).result()
            if not isinstance(resp, Overloaded):
                return resp
            if attempt >= self.max_retries:
                self.gave_up += 1
                return resp
            self.retries += 1
            delay = self.backoff_s(resp, attempt)
            self.backoff_total_s += delay
            self._sleep(delay)
        return resp                   # unreachable; loop always returns

    # DiscoveryServer-compatible alias so call sites can swap the wrapper in
    serve = submit_and_wait

    def stats(self) -> dict:
        return {"retries": self.retries, "gave_up": self.gave_up,
                "backoff_total_s": round(self.backoff_total_s, 4),
                "max_retries": self.max_retries}
