"""The scale-out layer of the port: meshes, ring-parallel KNN, gather and
chamfer, and multi-process helpers; the port of
``pytorch3d_pointops_tpu/parallel``.

The ring runs on either of two meshes:

* ``make_mesh``: one process drives a mesh of its devices (several cards,
  or several shards on one card) and runs every position's hops itself,
  moving shards between devices with peer copies;
* ``multihost.process_mesh``: one process a card (``torchrun``), each
  holding only its own blocks and driving its own position, every hop a
  ``torch.distributed`` send to the next rank and receive from the previous
  one (NCCL, or gloo staged through the host), the chamfer's sums taken
  across ranks.

``multihost`` joins the processes and moves blocks and slabs between them.
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
