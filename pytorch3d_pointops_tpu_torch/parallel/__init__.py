"""The scale-out layer of the port: meshes, ring-parallel KNN, gather and
chamfer, and multi-process helpers; the port of
``pytorch3d_pointops_tpu/parallel``.

One process drives a mesh of devices (several cards, or several shards on
one card) and runs the ring's hops itself, moving shards between devices
with peer copies. A ring that spans processes (one process a card, hops as
NCCL send/recv, as a multi-host config needs) is not here: it cannot run or
be checked on one card, and the single-process ring is what the port's
checks drive. ``multihost`` joins processes and moves slabs between them.
"""

from . import multihost
from .mesh import (
    batch_sharding,
    make_mesh,
    point_sharding,
    shard_pointclouds,
)
from .ring import ring_chamfer_distance, ring_knn_gather, ring_knn_points

__all__ = [
    "make_mesh",
    "batch_sharding",
    "point_sharding",
    "shard_pointclouds",
    "ring_knn_points",
    "ring_knn_gather",
    "ring_chamfer_distance",
    "multihost",
]
