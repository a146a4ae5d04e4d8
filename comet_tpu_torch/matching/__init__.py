"""The point-matching stack: extractors, matchers, the homography benchmark.

Counterpart of ``comet_tpu/matching`` for the point-feature inference path:
the registry and pipeline, SuperPoint and SIFT, mutual nearest neighbour,
LightGlue and SuperGlue, ground-truth generation, the metrics, the synthetic
homography benchmark, the named experiments and the checkpoint readers.
Training, the cached-prediction pipelines, the other extractors, lines and
GlueStick, the DINO backbone and the viz and inspect tools are not ported
yet (ROADMAP Queue 1 items 7a-7f).
"""

from .registry import TwoViewPipeline, get_model, list_models, register_model
from .matchers import mutual_nearest_neighbor, rotary_encode
from .lightglue import (
    LearnableFourierPosEnc,
    LightGlueMatcher,
    confidence_threshold,
    filter_matches,
    normalize_keypoints,
    sigmoid_log_double_softmax,
)
from .sift import dog_keypoints, extract_sift, gaussian_blur, sift_descriptors
from .extractors import make_grid_extractor, make_superpoint
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
from .superglue import SuperGlueMatcher, log_sinkhorn
from .benchmarks import (
    homography_corner_error,
    make_synthetic_pairs,
    random_homography,
    run_homography_benchmark,
    synthetic_texture,
    warp_image,
)
from .configs import EXPERIMENTS, MatcherWrapper, build_pipeline, get_experiment, list_experiments
from .experiments import (
    get_best_checkpoint,
    get_last_checkpoint,
    list_checkpoints,
    load_checkpoint,
    load_experiment_into_pipeline,
)
