from .conversions import depth_to_relative_disparity, relative_disparity_to_depth
from .epipolar_lines import get_depth, lift_to_3d, project_rays
from .projection import (
    get_world_rays,
    homogenize_points,
    homogenize_vectors,
    intersect_rays,
    invert_se3,
    project_camera_space,
    sample_image_grid,
    transform_rigid,
    unproject,
)

__all__ = [
    "depth_to_relative_disparity",
    "get_depth",
    "get_world_rays",
    "homogenize_points",
    "homogenize_vectors",
    "intersect_rays",
    "invert_se3",
    "lift_to_3d",
    "project_camera_space",
    "project_rays",
    "relative_disparity_to_depth",
    "sample_image_grid",
    "transform_rigid",
    "unproject",
]
