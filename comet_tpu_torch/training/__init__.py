from .data_parallel import batch_metrics, build_batch, stack_camera_sets, start_metric_fetch
from .loop import METRIC_FETCH_KEYS, eval_step, evaluate, make_gt_cameras, metric_block
from .stats import RunningStats
