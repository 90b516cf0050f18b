from .sharding import Mesh, make_mesh, node_sharding, shard_ranges

__all__ = ["Mesh", "make_mesh", "node_sharding", "shard_ranges"]
