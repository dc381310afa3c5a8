"""Hand-written Hopper kernels (``csrc/*.cu``), each beside its plain
PyTorch twin. A wrapper launches its kernel on CUDA tensors and counts the
launch in its ``launches`` attribute; on CPU tensors it runs the twin."""

from .chamfer import chamfer_nn_bidirectional, chamfer_nn_cuda, chamfer_nn_plain
from .knn import knn_topk, knn_topk_cuda, knn_topk_plain
from .scatter import scatter_add_k1, scatter_add_plain, scatter_add_rows

__all__ = [
    "chamfer_nn_bidirectional",
    "chamfer_nn_cuda",
    "chamfer_nn_plain",
    "knn_topk",
    "knn_topk_cuda",
    "knn_topk_plain",
    "scatter_add_k1",
    "scatter_add_plain",
    "scatter_add_rows",
]
