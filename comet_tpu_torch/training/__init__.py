from .checkpoints import auto_resume, find_last_checkpoint, restore_checkpoint, save_checkpoint
from .data_parallel import (
    batch_metrics, build_batch, fit_epoch, process_local_order, stack_camera_sets,
    start_metric_fetch,
)
from .loop import (
    METRIC_FETCH_KEYS, build_eval_step, build_train_step, build_windowed_train_step, eval_step, evaluate,
    make_gt_cameras, metric_block,
)
from .optim import (
    ClippedAdamW, build_optimizer, camera_only_mask, trainable_labels, warmup_cosine_restarts,
)
from .stats import TO_PLOT_METRICS, CsvLogger, RunningStats, TrainingMonitor
