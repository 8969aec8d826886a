"""The mesh-sharded engines: one process holds one shard pair a device of a
list (parallel/mesh.py), the dense engine (parallel/sharded.py) and the
segmented prefetch engine (parallel/sharded_prefetch.py)."""
