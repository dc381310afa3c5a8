"""Models built on the port's ops and ``torch.nn``: PointNet++ SSG
classification (``pointnet2.py``)."""

from .pointnet2 import PointNet2ClsSSG, SetAbstraction

__all__ = ["PointNet2ClsSSG", "SetAbstraction"]
