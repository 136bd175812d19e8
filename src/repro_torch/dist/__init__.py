"""Sharded lakes: the segment store partitioned along the table axis, one
engine per shard (``dist/shard.py``)."""
from repro_torch.dist.shard import ShardedExecutor, ShardedStore, \
    shard_devices

__all__ = ["ShardedExecutor", "ShardedStore", "shard_devices"]
