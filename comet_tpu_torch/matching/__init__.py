"""The point-matching stack: extractors, matchers, training, the benchmark.

Counterpart of ``comet_tpu/matching`` for point features: the registry and
pipeline; SuperPoint, SIFT, ALIKED, DISK, KeyNet, the dense and mixed
extractors and the DINOv2 backbone; mutual nearest neighbour, LightGlue and
SuperGlue with their losses; ground-truth generation, photometric
augmentation and the matcher train steps; the metrics, the synthetic
homography benchmark, the named experiments and their checkpoints. The
cached-prediction pipelines, lines and GlueStick and the viz and inspect
tools are not ported yet (ROADMAP Queue 1 items 7b, 7d and 7f).
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
