"""Models built on the port's ops and ``torch.nn``: PointNet++ SSG
classification (``pointnet2.py``) and Point Transformer semantic
segmentation (``point_transformer.py``)."""

from .pointnet2 import PointNet2ClsSSG, SetAbstraction
from .point_transformer import (
    PointTransformerBlock,
    PointTransformerLayer,
    PointTransformerSeg,
    TransitionDown,
    TransitionUp,
)

__all__ = ["PointNet2ClsSSG", "SetAbstraction", "PointTransformerSeg", "PointTransformerBlock",
           "PointTransformerLayer", "TransitionDown", "TransitionUp"]
