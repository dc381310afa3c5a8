from .pointclouds import (
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
from . import utils

__all__ = [
    "Pointclouds",
    "all_close",
    "get_bounding_boxes",
    "join_pointclouds_as_batch",
    "make_device",
    "join_pointclouds_as_scene",
    "offset",
    "scale",
    "subsample",
    "utils",
]
