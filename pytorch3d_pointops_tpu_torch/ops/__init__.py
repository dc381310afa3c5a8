from .ball_query import ball_query
from .chamfer import chamfer_distance
from .fps import sample_farthest_points, sample_farthest_points_naive
from .knn import knn_check_version, knn_gather, knn_points
from .utils import get_point_covariances, masked_gather, wmean

__all__ = [
    "ball_query",
    "chamfer_distance",
    "get_point_covariances",
    "knn_check_version",
    "knn_gather",
    "knn_points",
    "masked_gather",
    "sample_farthest_points",
    "sample_farthest_points_naive",
    "wmean",
]
