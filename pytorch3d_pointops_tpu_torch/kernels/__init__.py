"""Hand-written Hopper kernels (``csrc/*.cu``), each beside its plain
PyTorch twin: KNN top-K, bidirectional chamfer NN, the deterministic
scatter, ball query, farthest point sampling and the segment reductions
of grid pooling. A wrapper launches its kernel on CUDA tensors and counts
each launch in ``tracing``'s ``launch.<wrapper>`` counter; on CPU tensors
it runs the twin."""

from .ball_query import ball_query_cuda, ball_query_plain, ball_query_points
from .chamfer import chamfer_nn_bidirectional, chamfer_nn_cuda, chamfer_nn_plain
from .fps import (cluster_limit, fps_batched, fps_clustered, fps_limits, fps_plain,
                  fps_resident, fps_streaming)
from .knn import knn_topk, knn_topk_cuda, knn_topk_plain
from .scatter import scatter_add_k1, scatter_add_plain, scatter_add_rows

__all__ = [
    "ball_query_cuda",
    "ball_query_plain",
    "ball_query_points",
    "chamfer_nn_bidirectional",
    "chamfer_nn_cuda",
    "chamfer_nn_plain",
    "cluster_limit",
    "fps_batched",
    "fps_clustered",
    "fps_limits",
    "fps_plain",
    "fps_resident",
    "fps_streaming",
    "knn_topk",
    "knn_topk_cuda",
    "knn_topk_plain",
    "scatter_add_k1",
    "scatter_add_plain",
    "scatter_add_rows",
]
