"""Evaluation metrics, computed host-side in float64 numpy.

A copy of ``comet_tpu/metrics/pose_metrics.py`` (it imports no JAX): the
port keeps its own, so that it imports nothing of ``comet_tpu``.

The reference computes its eval metrics under ``autocast(dtype=torch.double)``
(comet/models/train_eval_func_new_cp5.py:632-675); we match that precision by
running these small reductions on host in numpy float64. Parity targets:

- camera_to_rel_deg3 (metric.py:183-247): all-pairs relative SE(3) rotation /
  translation-direction errors + absolute-translation RMSE x 10^3 per axis.
- camera_to_rel_deg2 (second definition wins, metric.py:391-451): per-frame
  geodesic rotation error, per-axis Euler error of the error rotation, and
  acc@5deg per axis.
- calculate_auc (metric.py:524-558): cumulative histogram AUC of
  max(R_err, T_err).
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# quaternion / rotation helpers (float64 numpy mirrors of geometry.quaternions)
# ---------------------------------------------------------------------------

def quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.empty((*q.shape[:-1], 3, 3), dtype=np.float64)
    m[..., 0, 0] = 1 - 2 * (y * y + z * z)
    m[..., 0, 1] = 2 * (x * y - w * z)
    m[..., 0, 2] = 2 * (x * z + w * y)
    m[..., 1, 0] = 2 * (x * y + w * z)
    m[..., 1, 1] = 1 - 2 * (x * x + z * z)
    m[..., 1, 2] = 2 * (y * z - w * x)
    m[..., 2, 0] = 2 * (x * z - w * y)
    m[..., 2, 1] = 2 * (y * z + w * x)
    m[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return m


def matrix_to_quat_np(m: np.ndarray) -> np.ndarray:
    """Rotation matrix [..., 3, 3] -> wxyz quaternion, float64."""
    m = np.asarray(m, dtype=np.float64)
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    q_abs = np.sqrt(
        np.maximum(
            np.stack(
                [
                    1.0 + m00 + m11 + m22,
                    1.0 + m00 - m11 - m22,
                    1.0 - m00 + m11 - m22,
                    1.0 - m00 - m11 + m22,
                ],
                axis=-1,
            ),
            0.0,
        )
    )
    m01, m02, m10 = m[..., 0, 1], m[..., 0, 2], m[..., 1, 0]
    m12, m20, m21 = m[..., 1, 2], m[..., 2, 0], m[..., 2, 1]
    cand = np.stack(
        [
            np.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
            np.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
            np.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
            np.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
        ],
        axis=-2,
    )
    denom = 2.0 * np.maximum(0.1, q_abs)[..., None]
    cand = cand / denom
    best = np.argmax(q_abs, axis=-1)
    q = np.take_along_axis(cand, best[..., None, None], axis=-2)[..., 0, :]
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def se3_row_np(r: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Row-vector SE(3): M = [[R, 0], [T, 1]]."""
    n = r.shape[0]
    m = np.zeros((n, 4, 4), dtype=np.float64)
    m[:, :3, :3] = r
    m[:, 3, :3] = t
    m[:, 3, 3] = 1.0
    return m


def se3_inverse_row_np(m: np.ndarray) -> np.ndarray:
    r_t = np.swapaxes(m[:, :3, :3], -1, -2)
    out = np.zeros_like(m)
    out[:, :3, :3] = r_t
    out[:, 3, :3] = -np.einsum("nj,njk->nk", m[:, 3, :3], r_t)
    out[:, 3, 3] = 1.0
    return out


def euler_xyz_from_matrix_np(m: np.ndarray) -> np.ndarray:
    """[x, y, z] Euler decomposition used by metric.py:302-324."""
    sy = np.sqrt(m[..., 0, 0] ** 2 + m[..., 1, 0] ** 2)
    singular = sy < 1e-6
    z = np.where(
        singular,
        np.arctan2(-m[..., 1, 2], m[..., 1, 1]),
        np.arctan2(m[..., 2, 1], m[..., 2, 2]),
    )
    y = np.arctan2(-m[..., 2, 0], sy)
    x = np.where(singular, 0.0, np.arctan2(m[..., 1, 0], m[..., 0, 0]))
    return np.stack([x, y, z], axis=-1)


# ---------------------------------------------------------------------------
# angle errors
# ---------------------------------------------------------------------------

def rotation_angle_deg(rot_a: np.ndarray, rot_b: np.ndarray, eps=1e-15) -> np.ndarray:
    """Quaternion-dot rotation angle in degrees (metric.py:645-660)."""
    qa = matrix_to_quat_np(rot_a)
    qb = matrix_to_quat_np(rot_b)
    loss_q = np.clip(1.0 - np.sum(qa * qb, axis=-1) ** 2, eps, None)
    err = np.arccos(np.clip(1.0 - 2.0 * loss_q, -1.0, 1.0))
    return err * 180.0 / np.pi


def translation_angle_deg(
    t_a: np.ndarray, t_b: np.ndarray, eps=1e-15, ambiguity=True
) -> np.ndarray:
    """Angle between translation directions, degrees (metric.py:675-701)."""
    a = t_a / (np.linalg.norm(t_a, axis=-1, keepdims=True) + eps)
    b = t_b / (np.linalg.norm(t_b, axis=-1, keepdims=True) + eps)
    loss_t = np.clip(1.0 - np.sum(a * b, axis=-1) ** 2, eps, None)
    err = np.arccos(np.clip(np.sqrt(1.0 - loss_t), -1.0, 1.0))
    err = np.where(np.isfinite(err), err, 1e6)
    deg = err * 180.0 / np.pi
    if ambiguity:
        deg = np.minimum(deg, np.abs(180.0 - deg))
    return deg


# ---------------------------------------------------------------------------
# headline metrics
# ---------------------------------------------------------------------------

def all_pairs_indices(batch: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Index pairs (i, j), i<j, replicated per batch (metric.py:561-570)."""
    pairs = np.array(list(combinations(range(n), 2)), dtype=np.int64)
    i1 = (pairs[:, 0][None] + np.arange(batch)[:, None] * n).reshape(-1)
    i2 = (pairs[:, 1][None] + np.arange(batch)[:, None] * n).reshape(-1)
    return i1, i2


def pairwise_se3_errors(
    pred_q: np.ndarray,
    pred_t: np.ndarray,
    gt_q: np.ndarray,
    gt_t: np.ndarray,
    batch_size: int = 1,
) -> Dict[str, np.ndarray]:
    """camera_to_rel_deg3 equivalent (metric.py:183-247).

    Inputs are [B*S, 4] quats and [B*S, 3] translations. Returns per-pair
    rotation/translation-direction errors (deg) and absolute-T RMSE x 1e3.
    """
    pred_q = np.asarray(pred_q, np.float64)
    pred_t = np.asarray(pred_t, np.float64)
    gt_q = np.asarray(gt_q, np.float64)
    gt_t = np.asarray(gt_t, np.float64)

    n_elem = pred_t.shape[0]
    sq = (pred_t - gt_t) ** 2
    t_rmse = np.sqrt(sq.sum() / n_elem) * 1e3
    x_rmse = np.sqrt(sq[:, 0].sum() / n_elem) * 1e3
    y_rmse = np.sqrt(sq[:, 1].sum() / n_elem) * 1e3
    z_rmse = np.sqrt(sq[:, 2].sum() / n_elem) * 1e3

    gt_se3 = se3_row_np(quat_to_matrix_np(gt_q), gt_t)
    pred_se3 = se3_row_np(quat_to_matrix_np(pred_q), pred_t)

    i1, i2 = all_pairs_indices(batch_size, gt_se3.shape[0] // batch_size)
    rel_gt = se3_inverse_row_np(gt_se3[i1]) @ gt_se3[i2]
    rel_pred = se3_inverse_row_np(pred_se3[i1]) @ pred_se3[i2]

    r_err = rotation_angle_deg(rel_gt[:, :3, :3], rel_pred[:, :3, :3])
    t_err = translation_angle_deg(rel_gt[:, 3, :3], rel_pred[:, 3, :3])
    return {
        "rel_rangle_deg": r_err,
        "rel_tangle_deg": t_err,
        "T_rmse_x1e3": t_rmse,
        "X_rmse_x1e3": x_rmse,
        "Y_rmse_x1e3": y_rmse,
        "Z_rmse_x1e3": z_rmse,
    }


def relative_frame_errors(
    pred_enc: np.ndarray, gt_enc: np.ndarray, acc_threshold_deg: float = 5.0
) -> Dict[str, np.ndarray]:
    """camera_to_rel_deg2 equivalent (second definition, metric.py:391-451).

    pred_enc: [B*S, >=7] with trans in [:, :3] and quat in [:, 3:7];
    gt_enc likewise. Returns per-frame geodesic rotation error (deg), mean
    per-axis |Euler| error of the error rotation (deg, order [x, y, z]), and
    per-axis acc@threshold fractions.
    """
    pred_enc = np.asarray(pred_enc, np.float64)
    gt_enc = np.asarray(gt_enc, np.float64)

    rel_tangle_deg = translation_angle_deg(gt_enc[:, :3], pred_enc[:, :3])

    r_pred = quat_to_matrix_np(pred_enc[:, 3:7])
    r_gt = quat_to_matrix_np(gt_enc[:, 3:7])
    m = r_pred @ np.swapaxes(r_gt, -1, -2)
    cos = (m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2] - 1.0) / 2.0
    theta = np.arccos(np.clip(cos, -1.0, 1.0))
    rel_rangle_deg = np.degrees(theta)

    eulers_deg = np.degrees(euler_xyz_from_matrix_np(m))  # [N, 3] (x, y, z)
    error_euler = np.mean(np.abs(eulers_deg), axis=0)
    # Reference quirk (metric.py:437-441): the acc@5deg percentages compare
    # the SIGNED per-frame Euler error to the threshold — no abs() — so any
    # negative-signed error counts as accurate. X/Y/Z_err use |euler| but the
    # acc columns intentionally reproduce the reference's signed comparison.
    acc = (eulers_deg < acc_threshold_deg).mean(axis=0)

    return {
        "rel_rangle_deg": rel_rangle_deg,
        "rel_tangle_deg": rel_tangle_deg,
        "avg_rangle_deg": rel_rangle_deg.mean(),
        "error_euler_xyz": error_euler,
        "acc_at_5deg_xyz": acc,
    }


def auc_histogram(
    r_error: np.ndarray, t_error: np.ndarray, max_threshold: int = 30
) -> Tuple[float, np.ndarray]:
    """AUC of max(R, T) error (metric.py:524-558).

    Returns (auc, normalized_histogram with max_threshold+1 bins — the last
    bin collects [max_threshold-? ..] exactly like torch.histc with
    bins=max_threshold+1 over [0, max_threshold], clamping outliers out).
    """
    max_errors = np.maximum(np.asarray(r_error, np.float64), np.asarray(t_error, np.float64))
    bins = max_threshold + 1
    # torch.histc(min=0, max=max_threshold) drops values outside the range.
    hist, _ = np.histogram(
        max_errors, bins=bins, range=(0.0, float(max_threshold))
    )
    normalized = hist.astype(np.float64) / float(max_errors.size)
    auc = np.cumsum(normalized).mean()
    return float(auc), normalized


def auc_from_histogram_prefix(normalized_histogram: np.ndarray, threshold: int) -> float:
    """Auc_{threshold} = mean of the cumsum over the first ``threshold`` bins."""
    return float(np.cumsum(normalized_histogram[:threshold]).mean())
