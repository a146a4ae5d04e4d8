from .triangulation import (
    project_points,
    projection_matrices,
    triangulate_multiview,
    triangulate_tracks,
)
