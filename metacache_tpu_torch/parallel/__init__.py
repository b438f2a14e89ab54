"""Sharded query and multi-process launch (counterpart of
metacache_tpu/parallel)."""
from .distributed import place_shards  # noqa: F401
from .sharding import ShardedQueryEngine  # noqa: F401
