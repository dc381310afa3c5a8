"""Models built on the port's ops and ``torch.nn``: PointNet++ SSG
classification (``pointnet2.py``), Point Transformer semantic segmentation
(``point_transformer.py``) and Point Transformer V2 semantic segmentation
(``point_transformer_v2.py``)."""

from .pointnet2 import PointNet2ClsSSG, SetAbstraction
from .point_transformer import (
    PointTransformerBlock,
    PointTransformerLayer,
    PointTransformerSeg,
    TransitionDown,
    TransitionUp,
)
from .point_transformer_v2 import (
    GroupedVectorAttention,
    GridPoolLayer,
    PointTransformerV2Seg,
    UnpoolWithSkip,
)

__all__ = ["PointNet2ClsSSG", "SetAbstraction", "PointTransformerSeg", "PointTransformerBlock",
           "PointTransformerLayer", "TransitionDown", "TransitionUp", "PointTransformerV2Seg",
           "GroupedVectorAttention", "GridPoolLayer", "UnpoolWithSkip"]
