from .estimators import (
    to_homogeneous,
    normalize_points,
    sampson_distance,
    run_8point,
    run_7point,
    run_homography_dlt,
    homography_transfer_error,
    essential_from_fundamental,
    decompose_essential,
    motion_from_essential,
    triangulate_point,
    triangulate_points,
    cheirality_count,
    estimate_fundamental_ransac,
    estimate_homography_ransac,
    estimate_essential_ransac,
    RansacResult,
)
from .triangulation import (
    triangulate_multiview,
    triangulate_tracks,
    triangulate_tracks_ransac,
    projection_matrices,
    project_points,
    bundle_adjust,
    global_bundle_adjust,
    triangulate_and_refine,
    BAState,
)
from .solvers import (
    run_5point,
    estimate_essential_5point_ransac,
    efficient_pnp,
    PnPSolution,
    decompose_homography,
    select_homography_motion,
)
from .preliminary import default_kmat, estimate_preliminary_cameras
from .align import (
    SimilarityTransform,
    corresponding_points_alignment,
    align_camera_extrinsics,
    rotation_average,
    average_batch_rotations,
    average_query_predictions,
    relative_to_first,
    farthest_point_sample,
    calculate_index_mappings,
    switch_tensor_order,
    generate_rank_by_midpoint,
    generate_rank_by_interval,
    rank_by_feature_similarity,
)
from .pnp import PnPResult, solve_pnp, solve_pnp_batched, solve_pnp_focal_sweep
from .robust_estimators import (
    BaseEstimator,
    register_estimator,
    load_estimator,
    get_estimator,
    list_estimators,
)
from .scene_ba import (
    triangulate_by_pair,
    triangulation_angles_deg,
    camera_centers,
    init_ba,
    refine_poses,
    filter_points3d,
    reconstruct_scene,
    InitBAResult,
    SceneReconstruction,
)
