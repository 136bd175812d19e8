"""The serving tier: the query cache (``cache.py``), the engines
(``engine.py``: ``LMEngine.generate``, ``DiscoveryEngine.serve`` /
``serve_many``), and the batching front tier over the discovery engine:
the batch former and admission control (``batching.py``), the threaded
``DiscoveryServer`` and its asyncio façade (``server.py``), the retrying
client (``client.py``) and the trace-driven load generator
(``loadgen.py``).

Nothing is imported here, so ``import repro_torch.serve.cache`` loads no
engine.
"""
