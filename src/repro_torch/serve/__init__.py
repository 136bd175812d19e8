"""The serving tier: the query cache (``cache.py``) and the discovery
engine (``engine.py``: ``DiscoveryEngine.serve`` / ``serve_many``).

The batch former, the threaded server, its client and the load generator
come with ROADMAP queue A, item A5b; ``LMEngine`` with item A8.  Nothing
is imported here, so ``import repro_torch.serve.cache`` loads no engine.
"""
