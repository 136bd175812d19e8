"""Batched serving engines: LM decode and discovery-query serving.

``LMEngine`` does prefill + greedy decode over a fixed batch of prompts
(the dense family, ``models/lm.py``); it captures no CUDA graph, so the
dispatcher rules of ``serve/server.py`` do not touch it.

``DiscoveryEngine`` serves discovery requests through one ``Session`` (the
paper's deployment mode: the index is resident, queries stream in).
``serve`` answers one request; ``serve_many`` dispatches a batch without
synchronizing, drains the device once and fetches every response's
(scores, mask) in one device-to-host copy.  The batching front tier over
this engine is ``serve/server.py``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.executor import ExecInfo
from repro_torch.core.index import resolve_device
from repro_torch.models.registry import leaves
from repro_torch.obs import trace as otrace
from repro_torch.query.session import connect
from repro_torch.train.step import make_prefill_step, make_serve_step

_NUMPY = {torch.float32: np.float32, torch.bool: np.bool_,
          torch.int64: np.int64}


def to_host(tensors) -> list:
    """numpy copies of ``tensors`` (flattened, one device), made with ONE
    device-to-host copy: their bytes are concatenated on the device, the
    widest elements first so that every piece is aligned, and copied into
    pinned host memory."""
    if not tensors:
        return []
    order = sorted(range(len(tensors)),
                   key=lambda i: -tensors[i].element_size())
    parts = [tensors[i].reshape(-1).view(torch.uint8) for i in order]
    flat = torch.cat(parts)
    if flat.is_cuda:
        host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(flat)
        flat = host
    flat = flat.numpy()
    out: list = [None] * len(tensors)
    off = 0
    for i, p in zip(order, parts):
        n = p.numel()
        out[i] = flat[off:off + n].view(_NUMPY[tensors[i].dtype]).copy()
        off += n
    return out


class LMEngine:
    """Prefill, then greedy decode, over one batch of prompts on ``device``
    (the card unless ``device="cpu"``).  ``params`` must lie on that device
    already (``registry.init_params`` / ``params_from_numpy`` with the same
    ``device``): nothing is moved, and nothing runs elsewhere."""

    def __init__(self, cfg, params, max_len: int, device=None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = resolve_device(device)
        strays = [str(t.device) for t in leaves(params).values()
                  if t.device.type != self.device.type
                  or self.device.index not in (None, t.device.index)]
        if strays:
            raise ValueError(f"LMEngine on {self.device}: parameters lie on "
                             f"{sorted(set(strays))}")
        self._prefill = make_prefill_step(cfg, max_len)
        self._decode = make_serve_step(cfg)

    @torch.inference_mode()
    def generate(self, batch: dict, n_tokens: int) -> np.ndarray:
        """``batch["tokens"]`` [B, S] (numpy or a tensor) -> the greedy
        tokens [B, n_tokens], the first from the prefill; one copy to the
        host at the end."""
        tokens = torch.as_tensor(batch["tokens"]).to(self.device, torch.int32)
        cache, tok = self._prefill(self.params, {"tokens": tokens})
        out = [tok]
        for _ in range(n_tokens - 1):
            cache, tok, _ = self._decode(self.params, cache, tok)
            out.append(tok)
        return torch.stack(out, dim=1).cpu().numpy()        # [B, n_tokens]


@dataclass
class DiscoveryResponse:
    table_ids: list
    seconds: float
    plan_nodes: int
    # the request's ExecInfo: what executed, in what order, how long each
    # node took, and the match-buffer overflow.  On a cache hit
    # (cache['status'] == 'hit') these describe the PRODUCING run stored
    # with the entry: this request executed nothing, and ``seconds`` is its
    # real cost.  Consumers aggregating executed work filter on the status.
    node_seconds: dict = field(default_factory=dict)
    order: list = field(default_factory=list)
    overflow: int = 0
    # device-program dispatches this request cost (ExecInfo.launches): the
    # fused path's ~n_kinds + 1 per plan against one per node
    launches: int = 0
    applied_rules: list = field(default_factory=list)
    # query-cache telemetry (serve/cache.py CacheInfo.as_dict()): hit /
    # partial / miss, seekers served against run, resident entries and
    # bytes, evictions, epoch invalidations.  None with the cache off.
    cache: dict | None = None
    # front-tier telemetry (serve/server.py): time spent queued before the
    # batch dispatched, and how many requests were coalesced into that
    # batch.  Direct serve / serve_many calls keep the defaults (no queue,
    # batch of one).
    queue_seconds: float = 0.0
    batch_size: int = 1
    # dense f32 [n_tables] score vector (host copy): the full ranking
    # evidence behind table_ids
    scores: object = None
    # per-request flight-recorder span tree (obs/trace.py Span), set by
    # DiscoveryServer(trace=True): queue wait, batch, epoch pin, per-kind
    # probes, the DAG merge, drain, host transfer.  None unless the server
    # is tracing.
    trace: object = None
    # sketch-tier report for ``serve(query, approx=...)`` requests
    # (core/sketch.py ApproxInfo.as_dict): epsilon / confidence, estimator,
    # escalation accounting, and per-hit (estimate, ci_lo, ci_hi) intervals
    # under ``"estimates"``, all plain Python numbers.  None on the exact
    # path.
    approx: dict | None = None
    # graceful degradation (dist/shard.py + core/fused.py): shards whose
    # probe failed twice (initial + one retry on a rebuilt shard) are
    # excluded from the merge instead of failing the request; their tables
    # are simply absent from the ranking.  ``degraded=True`` flags the
    # partial result; ``failed_shards`` names the shard indices dropped.
    degraded: bool = False
    failed_shards: list = field(default_factory=list)

    @property
    def total_node_seconds(self) -> float:
        return sum(self.node_seconds.values())


class DiscoveryEngine:
    """Serves discovery requests (BlendQL expressions, SQL strings, or
    legacy ``Plan`` objects) over a resident lake via one ``Session``.

    With ``live=True`` (or a live session) the engine serves an evolving
    lake: ``add_table`` / ``drop_table`` / ``compact`` / ``snapshot``
    forward to the Session's LiveLake, and every ``serve`` observes one
    consistent index epoch (the executor refreshes between requests,
    never inside one).

    With ``cache=True`` (or a byte budget) the Session serves repeats from
    the semantic query cache (serve/cache.py): ``DiscoveryResponse.cache``
    reports hit / partial / miss and the resident entries and bytes, and
    mutations invalidate by epoch so cached ids are never stale.

    With ``shards=N`` the lake is partitioned along the table axis
    (dist/shard.py): every request runs as fused per-shard probes plus one
    cross-shard merge, bit-identical to the unsharded engine.

    ``device=None`` means CUDA and raises without a card; pass
    ``device="cpu"`` for the plain PyTorch path."""

    def __init__(self, lake, cost_model=None, backend: str = "sorted",
                 session=None, live: bool = False, cache=False,
                 shards: int | None = None, device=None):
        if session is not None:
            if backend != "sorted" or live or cache or shards or \
                    device is not None:
                raise ValueError("backend/live/cache/shards/device are "
                                 "fixed by the given session; pass them to "
                                 "connect() instead")
            if cost_model is not None:
                session.cost_model = cost_model
            self.session = session
        else:
            self.session = connect(lake, cost_model=cost_model,
                                   backend=backend, live=live, cache=cache,
                                   shards=shards, device=device)
        self.lake = lake

    # -------------------------------------------------- live-lake mutations
    @property
    def live(self):
        return self.session.live

    def add_table(self, table, name=None) -> int:
        return self.session.add_table(table, name=name)

    def drop_table(self, ref) -> int:
        return self.session.drop_table(ref)

    def compact(self, **kw):
        return self.session.compact(**kw)

    def snapshot(self, path):
        return self.session.snapshot(path)

    # the Session owns the index, executor and cost model
    @property
    def index(self):
        return self.session.index

    @property
    def executor(self):
        return self.session.executor

    @property
    def cost_model(self):
        return self.session.cost_model

    @cost_model.setter
    def cost_model(self, model):
        self.session.cost_model = model

    @staticmethod
    def _fetch(results) -> list:
        """Every result's (scores, mask) on the host, and every overflow
        total of their infos resolved, in ONE device-to-host copy."""
        infos = [res.info for res in results]
        vecs = ExecInfo.overflow_vectors(infos)
        pairs = [t for res in results for t in (res.scores, res.result.mask)]
        host = to_host(list(vecs.values()) + pairs)
        ExecInfo.resolve_overflow(infos, dict(zip(vecs, host)))
        got = host[len(vecs):]
        return [(got[2 * i], got[2 * i + 1]) for i in range(len(results))]

    @staticmethod
    def _response(res, seconds: float, scores_np=None) -> DiscoveryResponse:
        if scores_np is None:
            ((scores_np, mask_np),) = DiscoveryEngine._fetch([res])
            res.materialize(scores_np, mask_np)
        return DiscoveryResponse(table_ids=res.ids, seconds=seconds,
                                 plan_nodes=len(res.compiled.plan.nodes),
                                 node_seconds=dict(res.info.node_seconds),
                                 order=list(res.info.order),
                                 overflow=res.info.overflow,
                                 launches=res.info.launches,
                                 applied_rules=list(res.applied_rules),
                                 cache=res.cache.as_dict()
                                 if res.cache is not None else None,
                                 scores=scores_np,
                                 approx=res.approx.as_dict(ids=res.ids)
                                 if res.approx is not None else None,
                                 degraded=bool(res.info.failed_shards),
                                 failed_shards=list(res.info.failed_shards))

    def serve(self, query, optimize: bool = True, fused: bool = False,
              approx=False) -> DiscoveryResponse:
        """One request.  ``approx=`` forwards to ``Session.query``: the
        response then answers from the sketch tier (estimates and intervals
        in ``DiscoveryResponse.approx``) with only the contended top-k
        boundary escalated to the exact path."""
        res = self.session.query(query, optimize=optimize, fused=fused,
                                 approx=approx)
        return self._response(res, res.seconds)

    @staticmethod
    def _dispatched(res) -> bool:
        """Did this request enqueue any device work?  Only an exact
        result-cache hit enqueues nothing: a 'partial' request still
        dispatches its combiners even when every seeker came from the
        subplan cache, so it keeps its drain share."""
        return res.cache is None or res.cache.status != "hit"

    def serve_many(self, queries, optimize: bool = True,
                   fused: bool = False):
        """Batched serving: every seeker of every request is dispatched
        without host synchronization (no data-dependent compaction stage),
        value hashing is shared across requests through the executor's
        hash cache, the device is synchronized once over the requests that
        dispatched, and every response's (scores, mask) comes back in one
        device-to-host copy before the responses are materialized.

        With ``fused=True`` the batch goes through ``Session.query_many``:
        same-kind seekers *across all requests* form one device program
        per kind and each request's combiner DAG runs as one more.
        ``DiscoveryResponse.launches`` is each request's own program count
        (~n_kinds + 1); a shared group launch counts once per request
        using it, so it is a per-request bound, not an additive share.

        ``seconds`` is that request's own compile and dispatch time plus
        an equal share of the one drain, split over the requests that
        dispatched device work: an exact cache hit enqueued nothing and
        pays no share."""
        session = self.session
        rec = otrace.current()
        with rec.span("execute", requests=len(queries), fused=fused):
            if fused:
                pending = [(res, res.seconds) for res in
                           session.query_many(queries, optimize=optimize,
                                              sync=False, fused=True)]
            else:
                pending = []
                for q in queries:
                    t0 = time.perf_counter()
                    res = session.query(q, optimize=optimize, sync=False)
                    pending.append((res, time.perf_counter() - t0))
        hot = [res for res, _ in pending if self._dispatched(res)]
        t0 = time.perf_counter()
        with rec.span("drain", dispatched=len(hot)):
            if hot:
                session.executor.synchronize()
        drain_share = (time.perf_counter() - t0) / max(len(hot), 1)
        with rec.span("transfer"):
            fetched = self._fetch([res for res, _ in pending])
        out = []
        for (res, dispatch_s), (s, m) in zip(pending, fetched):
            res.materialize(s, m)
            out.append(self._response(
                res, dispatch_s + (drain_share if self._dispatched(res)
                                   else 0.0), scores_np=s))
        return out
