"""H-sharded rendering of the port: slabs on one device or one a rank
(parallel/shard_render.py) and the torch.distributed helpers
(parallel/sharding.py)."""
