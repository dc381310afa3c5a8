"""pytorch3d_pointops_tpu_torch: the PyTorch and CUDA port of
``pytorch3d_pointops_tpu``.

Plain functions on torch tensors under the JAX package's names. An op runs
where its input tensors are: on CUDA tensors through hand-written Hopper
kernels (``csrc/``, built with ``nvcc`` at first use), on CPU tensors through
their plain PyTorch twins. This package exports what is ported so far: KNN,
the chamfer loss and the ragged ``Pointclouds`` container.
"""

__version__ = "0.1.0"

from .convert import pointclouds_from_numpy, tensors_from_numpy
from .ops import chamfer_distance, knn_check_version, knn_gather, knn_points
from .structures import (
    Pointclouds,
    all_close,
    get_bounding_boxes,
    join_pointclouds_as_batch,
    make_device,
    join_pointclouds_as_scene,
    offset,
    scale,
    subsample,
)

__all__ = [
    "__version__",
    "chamfer_distance",
    "knn_check_version",
    "knn_gather",
    "knn_points",
    "Pointclouds",
    "all_close",
    "get_bounding_boxes",
    "join_pointclouds_as_batch",
    "make_device",
    "join_pointclouds_as_scene",
    "offset",
    "scale",
    "subsample",
    "pointclouds_from_numpy",
    "tensors_from_numpy",
]
