from .chamfer import chamfer_distance
from .knn import knn_check_version, knn_gather, knn_points

__all__ = [
    "chamfer_distance",
    "knn_check_version",
    "knn_gather",
    "knn_points",
]
