"""Train and eval steps on the card, and the host-side float64 metric block.

Counterpart of ``comet_tpu/training/loop.py`` (``make_gt_cameras``,
``build_eval_step``, ``build_train_step``, ``METRIC_FETCH_KEYS``,
``metric_block``, ``evaluate``), itself the reference's train_or_eval_fn
(comet/models/train_eval_func_new_cp5.py:514-823) split into a device step
and a host loop that computes the float64 metric block (the reference's
autocast-double section :632-675) and accumulates per-scene AUC, and
``build_windowed_train_step``, the teacher-forced train step over a long
sequence in windows, and ``evaluate``'s mesh path with
``_merge_process_averages``. A train step built on
``data_parallel.replicate_train_state``'s model trains data-parallel.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..config import CometConfig
from ..data.datasets import SequenceSample
from ..data.keypoints import seed_query_points
from ..device import resolve_device
from ..geometry.cameras import CameraSet
from ..metrics import (
    auc_from_histogram_prefix,
    auc_histogram,
    pairwise_se3_errors,
    relative_frame_errors,
)
from ..models.comet import COMET, decode_predictions, encode_gt, pose_loss
from ..utils.profiling import span
from .stats import RunningStats


def make_gt_cameras(sample: SequenceSample) -> CameraSet:
    """Host-resident (numpy) gt CameraSet from a dataset sample.

    The leaves stay numpy on purpose: the host f64 metric block reads them,
    and the eval step moves them to the card itself (:func:`cameras_to`)."""
    n = sample.q_wxyz.shape[0]
    return CameraSet(
        q=np.asarray(sample.q_wxyz, np.float32),
        t_xyz=np.asarray(sample.t_xyz, np.float32),
        t_uvz=np.asarray(sample.t_uvz, np.float32),
        focal=np.full((n, 2), 1745.0, np.float32),
        pp=np.zeros((n, 2), np.float32),
        ratio=np.float32(sample.ratio).reshape(()),
    )


def cameras_to(cams: CameraSet, device) -> CameraSet:
    """A CameraSet of numpy leaves or tensors as f32 tensors on ``device``."""
    return CameraSet(*(torch.as_tensor(np.asarray(f) if not isinstance(f, torch.Tensor) else f,
                                       dtype=torch.float32, device=device) for f in cams))


@torch.inference_mode()
def eval_step(model: COMET, cfg: CometConfig, images: torch.Tensor, queries: torch.Tensor,
              gt_cams: CameraSet) -> Dict[str, torch.Tensor]:
    """images + queries + gt cameras -> predictions, gt encoding and losses
    (``build_eval_step``'s step; PyTorch runs it as it is, so there is
    nothing to build or memoize). ``gt_cams`` per sequence or batched, numpy
    leaves or tensors."""
    gt_cams = cameras_to(gt_cams, images.device)
    out = model(images, queries)
    gt_enc = encode_gt(cfg, gt_cams)
    gt_enc_b = gt_enc if gt_enc.dim() == 3 else gt_enc[None]
    losses = pose_loss(cfg, out["pred_pose_enc"], gt_enc_b)
    q_abs, t_abs = decode_predictions(cfg, out["pred_pose_enc"], gt_cams)
    return {
        "pred_pose_enc": out["pred_pose_enc"],
        "gt_pose_enc": gt_enc,
        "pred_q": q_abs,
        "pred_t": t_abs,
        "pred_track": out.get("pred_track"),
        "track_score": out.get("track_score"),
        **losses,
    }


def build_eval_step(model: COMET, cfg: CometConfig) -> Callable:
    """:func:`eval_step` bound to ``model`` and ``cfg``, without autograd:
    ``step(images, queries, gt_cams)``. JAX's step also takes the
    parameters first; here the model holds them."""

    @torch.no_grad()
    def step(images: torch.Tensor, queries: torch.Tensor, gt_cams: CameraSet):
        return eval_step(model, cfg, images, queries, gt_cams)

    return step


def build_train_step(model: COMET, cfg: CometConfig, optimizer: torch.optim.Optimizer,
                     scheduler) -> Callable:
    """The train step (``build_train_step``'s): forward, ``encode_gt``,
    ``pose_loss``, backward, then the optimizer (``training.optim``: the
    global-norm clip and AdamW over the camera parameters) and the
    scheduler. ``model`` may be ``data_parallel.replicate_train_state``'s
    wrapped model: its ``backward()`` then averages the gradients over the
    data ranks before the clip; a model that ``parallel.shard_params_tp``
    sharded trains tensor-parallel (its collectives differentiate, and the
    clip takes the whole model's norm). The model's parameters are the f32 master copy and it
    computes in ``cfg.dtype`` (bf16 in every preset), as JAX's
    ``run_train_benchmark`` trains.

    ``step(images, queries, gt_cams)`` returns JAX's aux keys
    (``pred_pose_enc``, ``gt_pose_enc``, ``pred_q``, ``pred_t``, ``loss``,
    ``loss_trans``, ``loss_rot``), detached; it does not synchronize.
    ``step(..., mark=f)``, for measurement: ``f`` is called with "forward",
    "backward" and "optimizer" as each part of the step has been issued.
    Under ``utils.profiling.recording`` the step and its parts are the spans
    ``train.step``, ``train.forward``, ``train.backward``, ``train.optimizer``
    and ``train.decode``."""

    def step(images: torch.Tensor, queries: torch.Tensor, gt_cams: CameraSet,
             mark: Callable[[str], None] = lambda name: None) -> Dict[str, torch.Tensor]:
        with span("train.step"):
            gt_cams = cameras_to(gt_cams, images.device)
            optimizer.zero_grad(set_to_none=True)
            with span("train.forward"):
                out = model(images, queries)
                gt_enc = encode_gt(cfg, gt_cams)
                gt_enc_b = gt_enc if gt_enc.dim() == 3 else gt_enc[None]
                losses = pose_loss(cfg, out["pred_pose_enc"], gt_enc_b)
            mark("forward")
            with span("train.backward"):
                losses["loss"].backward()
            mark("backward")
            with span("train.optimizer"):
                optimizer.step()
                scheduler.step()
            mark("optimizer")
            pred = out["pred_pose_enc"].detach()
            with span("train.decode"), torch.no_grad():
                q_abs, t_abs = decode_predictions(cfg, pred, gt_cams)
            return {"pred_pose_enc": pred, "gt_pose_enc": gt_enc, "pred_q": q_abs,
                    "pred_t": t_abs, **{k: v.detach() for k, v in losses.items()}}

    return step


def build_windowed_train_step(model: COMET, cfg: CometConfig, optimizer: torch.optim.Optimizer,
                              scheduler, window_len: int) -> Callable:
    """The teacher-forced windowed train step (``build_windowed_train_step``'s;
    the reference's intent in the dead ``E2Epose2.forward_window`` and
    ``TeacherForcingScheduler``, E2Epose2.py:269-612, 40-56).

    The whole chain, :func:`~..models.windowed.windowed_forward_scan` over
    the sequence, the uvz composition and ``pose_loss`` over every stitched
    frame against ``encode_gt``, is one autograd graph, so a late window's
    loss reaches every earlier window's camera predictor through the
    chained anchors. With ``teacher_force=True`` the anchors are the ground
    truth's encodings instead of the model's own. The optimizer, the
    scheduler, the f32 masters and the bf16 compute are those of
    :func:`build_train_step`; the tracker and the ViT run under no_grad in
    every window, as in the forward.

    Batch 1: ``step(images [1, T, ...], queries [1, N, 2], gt_cams [T, ...],
    teacher_force=False)`` returns JAX's aux keys (``pred_pose_enc``,
    ``gt_pose_enc``, ``pred_q``, ``pred_t``, ``pred_track``, ``loss``,
    ``loss_trans``, ``loss_rot``), detached; ``mark`` as in
    :func:`build_train_step`."""
    from ..models.windowed import windowed_forward_scan

    def step(images: torch.Tensor, queries: torch.Tensor, gt_cams: CameraSet,
             teacher_force: bool = False,
             mark: Callable[[str], None] = lambda name: None) -> Dict[str, torch.Tensor]:
        gt_cams = cameras_to(gt_cams, images.device)
        optimizer.zero_grad(set_to_none=True)
        gt_enc = encode_gt(cfg, gt_cams)  # [T, 8]
        enc, trk = windowed_forward_scan(model, images, queries, window_len, gt_cams.ratio,
                                         gt_enc=gt_enc, teacher_force=teacher_force)
        losses = pose_loss(cfg, enc, gt_enc[None])
        mark("forward")
        losses["loss"].backward()
        mark("backward")
        optimizer.step()
        scheduler.step()
        mark("optimizer")
        enc = enc.detach()
        with torch.no_grad():
            q_abs, t_abs = decode_predictions(cfg, enc, gt_cams)
        return {"pred_pose_enc": enc, "gt_pose_enc": gt_enc, "pred_q": q_abs, "pred_t": t_abs,
                "pred_track": trk.detach(), **{k: v.detach() for k, v in losses.items()}}

    return step


# The only step-output keys metric_block reads: data_parallel's
# start_metric_fetch copies exactly these to the host (pred_track
# [B,S,N,2] would be wasted traffic).
METRIC_FETCH_KEYS = (
    "pred_pose_enc", "gt_pose_enc", "pred_q", "pred_t",
    "loss", "loss_trans", "loss_rot",
)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def metric_block(
    step_out: Dict[str, Any], gt_cams: CameraSet, seq_name: str = ""
) -> Dict[str, float]:
    """Host-side float64 metric block (train_eval_func_new_cp5.py:632-675).

    Key-name and axis-mapping parity with the reference:
    X_err = error_euler[2], acc@5deg_x = acc[2], etc.
    """
    pred_q = _host(step_out["pred_q"]).reshape(-1, 4)
    pred_t = _host(step_out["pred_t"]).reshape(-1, 3)
    gt_q = _host(gt_cams.q)
    gt_t = _host(gt_cams.t_xyz)

    pair = pairwise_se3_errors(pred_q, pred_t, gt_q, gt_t, batch_size=1)
    pred_enc = _host(step_out["pred_pose_enc"]).reshape(-1, 7)
    gt_enc = _host(step_out["gt_pose_enc"]).reshape(pred_enc.shape[0], -1)[:, :7]
    rel = relative_frame_errors(pred_enc, gt_enc)

    out: Dict[str, float] = {
        "loss": float(_host(step_out.get("loss", 0.0))),
        "loss_trans": float(_host(step_out.get("loss_trans", 0.0))),
        "loss_rot": float(_host(step_out.get("loss_rot", 0.0))),
        "R_avg": float(rel["avg_rangle_deg"]),
        "T_avg": float(pair["T_rmse_x1e3"]),
        "Tx_mse": float(pair["X_rmse_x1e3"]),
        "Ty_mse": float(pair["Y_rmse_x1e3"]),
        "Tz_mse": float(pair["Z_rmse_x1e3"]),
        # reference axis mapping (train_eval_func_new_cp5.py:644-655)
        "X_err": float(rel["error_euler_xyz"][2]),
        "Y_err": float(rel["error_euler_xyz"][1]),
        "Z_err": float(rel["error_euler_xyz"][0]),
        "acc@5deg_x": float(rel["acc_at_5deg_xyz"][2]),
        "acc@5deg_y": float(rel["acc_at_5deg_xyz"][1]),
        "acc@5deg_z": float(rel["acc_at_5deg_xyz"][0]),
    }
    for th in (5, 10, 15):
        out[f"Racc_him_{th}"] = float((pair["rel_rangle_deg"] < th).mean())
        out[f"Tacc_him_{th}"] = float((pair["rel_tangle_deg"] < th).mean())
    _, hist = auc_histogram(pair["rel_rangle_deg"], pair["rel_tangle_deg"], 30)
    for th in (30, 10, 5, 3):
        out[f"Auc_{th}"] = auc_from_histogram_prefix(hist, th)
    if seq_name:
        out[f"Auc_scene_{seq_name}"] = auc_from_histogram_prefix(hist, 10)
    return out


def _merge_process_averages(stats: RunningStats, mesh) -> Dict[str, float]:
    """Every data rank's partial (sum, count) pairs merged into global
    averages (the mesh eval): the metric-block keys are the same on every
    rank, in the same sorted order, so an all-gather of the aligned [2, K]
    float64 (sums, counts) matrix over the data group suffices. The
    per-scene AUC keys are disjoint across ranks and stay local (each rank
    keeps its own scenes, as the reference's per-rank scene dicts)."""
    from ..parallel.mesh import DATA, mesh_device

    global_keys = sorted(k for k in stats._sums if not k.startswith("Auc_scene"))
    vec = torch.tensor([[stats._sums[k] for k in global_keys],
                        [float(stats._counts[k]) for k in global_keys]],
                       dtype=torch.float64, device=mesh_device(mesh))
    parts = [torch.empty_like(vec) for _ in range(mesh.size(0))]
    torch.distributed.all_gather(parts, vec, group=mesh.get_group(DATA))
    total = torch.stack(parts).sum(0).cpu().numpy()  # [2, K]
    out = {k: float(total[0, i]) / max(float(total[1, i]), 1.0) for i, k in enumerate(global_keys)}
    for k in stats._sums:
        if k.startswith("Auc_scene"):
            out[k] = stats._sums[k] / max(stats._counts[k], 1)
    return out


def evaluate(
    model: COMET,
    dataset,
    cfg: CometConfig,
    keypoint_backend="corners",
    max_sequences: Optional[int] = None,
    print_fn=print,
    print_interval: int = 50,
    mesh=None,
    eval_batch: int = 1,
    device=None,
) -> Dict[str, float]:
    """Sequential eval over a dataset on one device; returns epoch-average
    metrics. The model holds its weights and must already be on ``device``
    (the card by default; ``device="cpu"`` runs on the CPU).

    ``keypoint_backend`` is a backend name ("corners"/"grid"/"superpoint",
    the last on ``device``) or a callable
    ``sample -> [track_num, 2]`` for externally-supplied query points. The
    query points are drawn from one ``np.random.default_rng(cfg.train.seed)``
    in dataset order, as the JAX package draws them.

    Loading and seeding of the next sequences run on a prefetch thread,
    and step i+1 is dispatched before step i's metrics are read, so the
    metric copies and the float64 metric block hide behind the card's work.
    ``eval_batch`` > 1 groups sequences into batches; the tail batch pads by
    repeating the last sequence, and the padded rows' metrics are dropped.

    With a ``mesh`` of more than one rank every chunk holds one row per
    rank (``eval_batch`` is not used), and each data rank evaluates its own
    rows of each chunk on its device (the ranks of a model group the same
    rows); each seeds the query points of its rows only, from its own
    generator, as the JAX package does under a mesh, so the points differ
    from one process's unless ``keypoint_backend`` is a callable. The ranks'
    partial averages merge at the end (:func:`_merge_process_averages`)."""
    from ..data.prefetch import prefetch
    from ..parallel.mesh import mesh_device
    from .data_parallel import batch_metrics, build_batch, shard_train_inputs, start_metric_fetch

    if eval_batch < 1:
        raise ValueError(f"evaluate: eval_batch must be >= 1, not {eval_batch}")
    meshed = mesh is not None and mesh.size() > 1
    if meshed:
        mine = mesh_device(mesh)
        if device is not None and torch.device(device) != mine:
            raise ValueError(f"evaluate: device {device}, and this rank's mesh device is {mine}")
        device = mine
    device = resolve_device(device, "evaluate")
    param = next(model.parameters())
    if param.device.type != device.type or (device.index is not None
                                            and param.device.index != device.index):
        raise ValueError(f"evaluate: the model is on {param.device}, not on {device}")
    stats = RunningStats()
    rng = np.random.default_rng(cfg.train.seed)
    n = len(dataset) if max_sequences is None else min(len(dataset), max_sequences)
    d = mesh.size() if meshed else int(eval_batch)
    # this rank's rows of each chunk: [p_lo, p_lo + d_local)
    d_local = d // mesh.size(0) if meshed else d
    p_lo = mesh.get_local_rank("data") * d_local if meshed else 0

    def seed(sample):
        if callable(keypoint_backend):
            return np.asarray(keypoint_backend(sample), np.float32)
        frame0 = sample.frame0_u8 if sample.frame0_u8 is not None else sample.images[0]
        return seed_query_points(
            frame0, sample.first_mask, cfg.track_num, cfg.min_track_num,
            backend=keypoint_backend, rng=rng, device=device,
        )

    n_chunks = -(-n // d)

    def produce_chunk(ci: int):
        chunk = list(range(ci * d, min(ci * d + d, n)))
        padded = chunk + [chunk[-1]] * (d - len(chunk))
        samples = [dataset[j] for j in padded[p_lo:p_lo + d_local]]
        return chunk, samples, [seed(s) for s in samples]

    def flush(pend):
        p_ci, p_chunk, p_fetch, p_gt, p_names = pend
        rows = batch_metrics(p_fetch, p_gt, seq_names=p_names)
        for r, row in enumerate(rows):
            if p_lo + r < len(p_chunk):  # a padded row is dropped
                stats.update(row)
        if p_ci % print_interval == 0:
            print_fn(stats.status_string(p_ci * d, n, "eval"))

    # chunk i+1 is dispatched before chunk i's metrics are read: the card
    # computes i+1 while the host waits for i's copies and runs the f64
    # metric block
    pending = None
    for ci, (chunk, samples, queries) in enumerate(prefetch(produce_chunk, n_chunks)):
        images, q, gt_b, gt_list = build_batch(samples, queries, device)
        if meshed:
            images, q, gt_b = shard_train_inputs(mesh, images, q, gt_b)
        out = eval_step(model, cfg, images, q, gt_b)
        fetch = start_metric_fetch(out)
        if pending is not None:
            flush(pending)
        pending = (ci, chunk, fetch, gt_list, [s.seq_name for s in samples])
    if pending is not None:
        flush(pending)
    if meshed and mesh.size(0) > 1:
        return _merge_process_averages(stats, mesh)
    return stats.averages()
