"""The serving tier: the query cache (``cache.py``), the discovery engine
(``engine.py``: ``DiscoveryEngine.serve`` / ``serve_many``), and the
batching front tier over it: the batch former and admission control
(``batching.py``), the threaded ``DiscoveryServer`` and its asyncio façade
(``server.py``), the retrying client (``client.py``) and the trace-driven
load generator (``loadgen.py``).

``LMEngine`` comes with ROADMAP queue A, item A8.  Nothing is imported
here, so ``import repro_torch.serve.cache`` loads no engine.
"""
