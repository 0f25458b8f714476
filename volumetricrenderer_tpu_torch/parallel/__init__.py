"""H-sharded rendering of the port (parallel/shard_render.py)."""
