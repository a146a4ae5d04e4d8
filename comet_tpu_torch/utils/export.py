"""Demo-mode JSON export, schema-compatible with the reference.

Counterpart of ``comet_tpu/utils/export.py``. Parity target: the DCA demo
JSON written by comet/models/train_eval_func_new_cp5.py:704-753
(sequence_name / metrics / trajectory with per-frame pred+gt quaternions
and translations). Tensors and numpy arrays are read alike.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def export_sequence_json(
    output_dir: str,
    seq_name: str,
    step_out: Dict[str, Any],
    gt_cams,
    metrics: Dict[str, float],
) -> str:
    pred_q = _host(step_out["pred_q"]).reshape(-1, 4)
    pred_t = _host(step_out["pred_t"]).reshape(-1, 3)
    gt_q = _host(gt_cams.q)
    gt_t = _host(gt_cams.t_xyz)

    trajectory = [
        {
            "frame_idx": i,
            "pred": {"R_quat": pred_q[i].tolist(), "T": pred_t[i].tolist()},
            "gt": {"R_quat": gt_q[i].tolist(), "T": gt_t[i].tolist()},
        }
        for i in range(pred_q.shape[0])
    ]

    metrics_data = {
        "R_avg": metrics.get("R_avg"),
        "T_avg": metrics.get("T_avg"),
        "Euler_Error_XYZ": [
            metrics.get("X_err"), metrics.get("Y_err"), metrics.get("Z_err")
        ],
        "Acc_5deg_XYZ": [
            metrics.get("acc@5deg_x"), metrics.get("acc@5deg_y"),
            metrics.get("acc@5deg_z"),
        ],
        "MSE_T_XYZ": [
            metrics.get("Tx_mse"), metrics.get("Ty_mse"), metrics.get("Tz_mse")
        ],
        "AUC": {f"Auc_{t}": metrics.get(f"Auc_{t}") for t in (30, 10, 5, 3)},
        "Accuracy_Him": {
            **{f"Racc_{t}": metrics.get(f"Racc_him_{t}") for t in (5, 10, 15)},
            **{f"Tacc_{t}": metrics.get(f"Tacc_him_{t}") for t in (5, 10, 15)},
        },
    }

    final = {
        "sequence_name": seq_name,
        "metrics": metrics_data,
        "trajectory": trajectory,
    }
    save_dir = os.path.join(output_dir, seq_name, "metrics")
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "results.json")
    with open(path, "w") as f:
        json.dump(final, f, indent=4)
    return path
