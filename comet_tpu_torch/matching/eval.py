"""Matching evaluation metrics.

Counterpart of ``comet_tpu/matching/eval.py`` (glue-factory's eval
utilities): match count, reprojection precision at a pixel threshold and
recall against the ground-truth assignment; the matcher training metrics
(the ranking sorts are stable, as ``jnp.argsort`` is); and the dataset-level
precision-recall aggregation, which runs on the host in numpy as the
reference's does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .gt_generation import gt_matches_from_homography, warp_homography


def eval_matches_homography(
    kpts0,  # [N0, 2]
    kpts1,  # [N1, 2]
    matches0,  # [N0] predicted (index into kpts1 or -1)
    h,  # [3, 3] true homography image0 -> image1
    threshold: float = 3.0,
) -> Dict[str, torch.Tensor]:
    """num_matches, prec@threshold and the recall against the GT labels,
    as 0-dim tensors on the inputs' device."""
    matched = matches0 >= 0
    idx = matches0.clamp(0, kpts1.shape[0] - 1)
    err = torch.linalg.vector_norm(warp_homography(kpts0, h) - kpts1[idx], dim=-1)
    correct = matched & (err < threshold)
    num = matched.sum()
    prec = torch.where(num > 0, correct.sum() / num.clamp_min(1), 0.0)
    gt = gt_matches_from_homography(kpts0, kpts1, h, pos_threshold=threshold)["matches0"]
    gt_pos = gt >= 0
    hit = gt_pos & (matches0 == gt)
    n_pos = gt_pos.sum()
    recall = torch.where(n_pos > 0, hit.sum() / n_pos.clamp_min(1), 0.0)
    return {"num_matches": num, f"prec@{threshold:g}px": prec, "recall": recall}


def matcher_metrics(
    matches0,  # [B, N] predicted (index into kpts1, -1 unmatched)
    gt_matches0,  # [B, N] GT labels (index, -1 unmatched, -2 ignore)
    matching_scores0,  # [B, N] predicted confidence
    prefix: str = "",
) -> Dict[str, torch.Tensor]:
    """Per-pair recall, precision, accuracy and the ranking AP of
    gluefactory/models/utils/metrics.py (its collapsed AP: the last
    precision times the recall span)."""
    m, gt, scores = matches0, gt_matches0, matching_scores0
    eps = 1e-8
    correct = (m == gt).float()
    r_mask = (gt > -1).float()
    recall = (correct * r_mask).sum(1) / (eps + r_mask.sum(1))
    a_mask = (gt >= -1).float()
    accuracy = (correct * a_mask).sum(1) / (eps + a_mask.sum(1))
    p_mask = ((m > -1) & (gt >= -1)).float()
    precision = (correct * p_mask).sum(1) / (eps + p_mask.sum(1))

    order = torch.argsort(-scores, dim=-1, stable=True)
    sp = p_mask.gather(-1, order)
    sr = r_mask.gather(-1, order)
    st = correct.gather(-1, order)
    p_pts = torch.cumsum(st * sp, -1) / (eps + torch.cumsum(sp, -1))
    r_pts = torch.cumsum(st * sr, -1) / (eps + sr.sum(-1, keepdim=True))
    ap = ((r_pts[:, 1:] - r_pts[:, :-1]) * p_pts[:, -1:]).sum(-1)
    return {
        f"{prefix}match_recall": recall,
        f"{prefix}match_precision": precision,
        f"{prefix}accuracy": accuracy,
        f"{prefix}average_precision": ap,
    }


IGNORE_FEATURE = -2


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def get_tp_fp_pts(pred_matches, gt_matches, pred_scores):
    """Per-pair TP / FP flags and scores for the dataset-level PR curve
    (gluefactory/eval/utils.py:227-244): IGNORE_FEATURE labels are left
    out; a prediction is a TP iff it equals the GT; num_pos counts the GT
    positives. On the host."""
    pred_matches, gt_matches, pred_scores = map(_host, (pred_matches, gt_matches, pred_scores))
    keep = gt_matches != IGNORE_FEATURE
    pred_matches, gt_matches, pred_scores = pred_matches[keep], gt_matches[keep], pred_scores[keep]
    num_pos = int(np.sum(gt_matches != -1))
    pos = pred_matches != -1
    tp = pred_matches[pos] == gt_matches[pos]
    fp = pred_matches[pos] != gt_matches[pos]
    return tp, fp, pred_scores[pos], num_pos


def average_precision(recall_curve, fp_curve):
    """Interpolated VOC-style AP over cumulative recall and FP curves
    (gluefactory/eval/utils.py:247-256, whose 'tp' is already the
    cumulative recall)."""
    recall = np.concatenate(([0.0], recall_curve, [1.0]))
    precision = recall_curve / np.maximum(recall_curve + fp_curve, 1e-9)
    precision = np.concatenate(([0.0], precision, [0.0]))
    for i in range(precision.size - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    i = np.where(recall[1:] != recall[:-1])[0]
    return float(np.sum((recall[i + 1] - recall[i]) * precision[i + 1]))


def aggregate_pr_results(results, suffix=""):
    """Dataset-level PR curves and AP from the accumulated per-pair TP / FP
    lists (gluefactory/eval/utils.py:259-272): every match ranked by score
    (numpy's sort, as the reference's), TP and FP cumulated over the
    ranking, normalized by the GT positives."""
    tp_list = np.concatenate(results["tp" + suffix], axis=0)
    fp_list = np.concatenate(results["fp" + suffix], axis=0)
    scores = np.concatenate(results["scores" + suffix], axis=0)
    n_gt = max(results["num_pos" + suffix], 1)
    idx = np.argsort(scores)[::-1]
    rec = np.cumsum(tp_list[idx]) / n_gt
    fpc = np.cumsum(fp_list[idx]) / n_gt
    return {
        "curve_recall" + suffix: rec,
        "curve_precision" + suffix: rec / np.maximum(rec + fpc, 1e-9),
        "AP" + suffix: average_precision(rec, fpc) * 100,
    }
