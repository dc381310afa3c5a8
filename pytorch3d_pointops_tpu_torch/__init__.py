"""pytorch3d_pointops_tpu_torch: the PyTorch and CUDA port of
``pytorch3d_pointops_tpu``.

Plain functions on torch tensors under the JAX package's names. An op runs
where its input tensors are: on CUDA tensors through hand-written Hopper
kernels (``csrc/``, built with ``nvcc`` at first use), on CPU tensors through
their plain PyTorch twins. It exports every public name of the JAX package:
KNN, the chamfer loss, ball query, farthest point sampling, packed/padded
conversions, PDF sampling, the gather and covariance helpers, and the
ragged ``Pointclouds`` container.
"""

__version__ = "0.1.0"

from .convert import pointclouds_from_numpy, tensors_from_numpy
from .ops import (
    ball_query,
    chamfer_distance,
    get_point_covariances,
    knn_check_version,
    knn_gather,
    knn_points,
    masked_gather,
    packed_to_padded,
    padded_to_packed,
    sample_farthest_points,
    sample_farthest_points_naive,
    sample_pdf,
    sample_pdf_python,
    wmean,
)
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
    "ball_query",
    "chamfer_distance",
    "get_point_covariances",
    "knn_check_version",
    "knn_gather",
    "knn_points",
    "masked_gather",
    "packed_to_padded",
    "padded_to_packed",
    "sample_farthest_points",
    "sample_farthest_points_naive",
    "sample_pdf",
    "sample_pdf_python",
    "wmean",
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
