"""The matching stack: extractors, matchers, training, the benchmarks.

Counterpart of ``comet_tpu/matching`` for point features: the registry and
pipeline; SuperPoint, SIFT, ALIKED, DISK, KeyNet, the dense and mixed
extractors and the DINOv2 backbone; mutual nearest neighbour, LightGlue and
SuperGlue with their losses; ground-truth generation, photometric
augmentation and the matcher train steps; the metrics, the synthetic
homography benchmark, the named experiments and their checkpoints; line
detection (the LSD and DeepLSD stand-ins), wireframes and GlueStick; depth
ground truth for points and lines; the cached-prediction evaluation
pipelines (homography and relative pose), the feature cache and the viz
drawing. The glue-factory tools, misc, image, inspect-frame and patch
helpers are not ported yet (ROADMAP Queue 1 item 7f).
"""

from .registry import TwoViewPipeline, get_model, list_models, register_model
from .matchers import mutual_nearest_neighbor, rotary_encode
from .lightglue import (
    LearnableFourierPosEnc,
    LightGlueMatcher,
    confidence_threshold,
    filter_matches,
    lightglue_loss,
    normalize_keypoints,
    sigmoid_log_double_softmax,
)
from .sift import dog_keypoints, extract_sift, gaussian_blur, sift_descriptors
from .extractors import (
    make_aliked,
    make_dense_disk,
    make_disk,
    make_grid_extractor,
    make_keynet,
    make_mixed_extractor,
    make_superpoint,
)
from .backbones import make_dinov2_backbone
from .gt_generation import (
    IGNORE,
    UNMATCHED,
    gt_matches_from_homography,
    gt_matches_from_pose,
    warp_homography,
)
from .eval import (
    aggregate_pr_results,
    average_precision,
    eval_matches_homography,
    get_tp_fp_pts,
    matcher_metrics,
)
from .superglue import SuperGlueMatcher, log_sinkhorn, superglue_nll_loss
from .benchmarks import (
    homography_corner_error,
    make_synthetic_pairs,
    random_homography,
    run_homography_benchmark,
    synthetic_texture,
    warp_image,
)
from .depth_gt import (
    dense_warp_consistency,
    essential_to_fundamental,
    gt_line_matches_from_homography,
    gt_line_matches_from_pose_depth,
    gt_matches_from_pose_depth,
    pose_to_essential,
    project_points_with_depth,
    sample_depth,
    sym_epipolar_distance_all,
)
from .eval_pipeline import (
    AUCMetric,
    EvalPipeline,
    HomographyEvalPipeline,
    cal_error_auc,
    eval_poses,
    exists_eval,
    export_predictions,
    load_eval,
    load_predictions,
    save_eval,
)
from .gluestick import GlueStickMatcher, gluestick_nll_loss
from .lines import (
    LineSegments,
    detect_line_segments,
    make_wireframe,
    match_lines_nn,
    sample_line_descriptors,
    sample_line_points,
)
from .deeplsd import DeepLSDDetector, DeepLSDNet, deeplsd_field_loss, extract_lines_from_fields
from .cache_loader import CacheLoader, TripletPipeline, pad_local_features, pad_to_length
from .viz import (
    cm_RdGn,
    draw_epipolar_lines,
    draw_keypoints,
    draw_line_matches,
    draw_lines,
    draw_matches,
    heatmap_overlay,
    plot_cumulative_errors,
    side_by_side,
)
from .configs import EXPERIMENTS, MatcherWrapper, build_pipeline, get_experiment, list_experiments
from .experiments import (
    adam_state_from_jax,
    adam_state_to_jax,
    delete_old_checkpoints,
    get_best_checkpoint,
    get_last_checkpoint,
    list_checkpoints,
    load_checkpoint,
    load_experiment_into_pipeline,
    save_experiment,
)
from .augmentations import (
    LG_PRESET,
    PhotometricConfig,
    apply_photometric,
    draw_photometric,
    photometric_augment,
    sample_homography_difficulty,
)
from .train import (
    build_matcher_train_step,
    build_superglue_train_step,
    make_homography_training_batch,
    matcher_nll_loss,
)
