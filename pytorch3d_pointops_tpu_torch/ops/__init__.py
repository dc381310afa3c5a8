from .ball_query import ball_query
from .chamfer import chamfer_distance
from .fps import sample_farthest_points, sample_farthest_points_naive
from .knn import knn_check_version, knn_gather, knn_points
from .packed_padded import packed_to_padded, padded_to_packed
from .sample_pdf import sample_pdf, sample_pdf_python
from .utils import get_point_covariances, masked_gather, wmean

__all__ = [
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
]
