"""Multi-device execution: a single-process mesh of torch devices,
row-sharded values, the range-partitioned lookup join whose key shuffle
is an all-to-all exchange (:mod:`.pjoin`, BASELINE.json config 5) and
the distributed sample sort (:mod:`.dsort`).

One process drives every shard, as in the reference: a mesh is an
ordered list of devices, and several shards may share one card
(``make_mesh(8, devices=["cuda:0"] * 8)``).  Sharded tables behind the
public API (``on_device(shards=N)`` / ``mesh=``) hold
:class:`~.mesh.ShardedRows` storage and run every stage per shard.
"""

from .mesh import make_mesh, replicate, shard_rows

__all__ = ["make_mesh", "shard_rows", "replicate"]
