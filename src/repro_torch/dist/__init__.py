"""Distributed-execution support: sharding rules for params, batches, caches, as DTensor placements."""
