"""Metric accumulation, CSV logging and the loss-anomaly monitor.

Counterpart of ``comet_tpu/training/stats.py``: ``TO_PLOT_METRICS`` and
``RunningStats`` (the reference's VizStats subset, train_util.py:96-121,
1914-2037), ``CsvLogger`` (abl_ours.py:9-22; one CSV row per epoch) and
``TrainingMonitor`` (train_eval_func_new_cp5.py:82-186). The plots
(``plot_metrics_png``, ``write_live_dashboard``) are not ported yet.
"""

from __future__ import annotations

import csv
import gzip
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterable, Optional

# The reference's headline metric tuple (train_util.py:96-121).
TO_PLOT_METRICS = (
    "lr", "Auc_30", "Auc_10", "Auc_5", "Auc_3", "X_err", "Y_err", "Z_err", "Tx_mse", "Ty_mse",
    "Tz_mse", "R_avg", "T_avg", "Racc_him_5", "Racc_him_10", "Racc_him_15", "Tacc_him_5",
    "Tacc_him_10", "Tacc_him_15", "acc@5deg_x", "acc@5deg_y", "acc@5deg_z", "sec/it",
)


class RunningStats:
    """Per-epoch running averages (AverageMeter-style, VizStats subset)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._t0 = time.time()
        self._iters = 0

    def update(self, metrics: Dict[str, float]):
        self._iters += 1
        for k, v in metrics.items():
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            self._sums[k] += fv
            self._counts[k] += 1

    def averages(self) -> Dict[str, float]:
        out = {k: self._sums[k] / max(self._counts[k], 1) for k in self._sums}
        if self._iters:
            out["sec/it"] = (time.time() - self._t0) / self._iters
        return out

    def status_string(self, step: int, max_it: int, stat_set: str = "eval") -> str:
        avg = self.averages()
        keys = [k for k in ("loss", "R_avg", "T_avg", "Auc_30") if k in avg]
        body = " ".join(f"{k}: {avg[k]:.4f}" for k in keys)
        return f"[{stat_set}] it {step}/{max_it} | {body}"

    def save(self, path: str):
        with gzip.open(path, "wt") as f:
            json.dump({"sums": dict(self._sums), "counts": dict(self._counts)}, f)

    def load(self, path: str):
        with gzip.open(path, "rt") as f:
            data = json.load(f)
        self._sums = defaultdict(float, data["sums"])
        self._counts = defaultdict(int, data["counts"])


class CsvLogger:
    """Append one row per epoch (abl_ours.py:9-22): ``epoch``, then the
    ``fieldnames`` the metrics hold."""

    def __init__(self, path: str, fieldnames: Iterable[str] = TO_PLOT_METRICS):
        self.path = path
        self.fieldnames = ["epoch", *fieldnames]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not os.path.exists(path):
            with open(path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=self.fieldnames).writeheader()

    def log(self, epoch: int, metrics: Dict[str, float]):
        row = {"epoch": epoch, **{k: metrics[k] for k in self.fieldnames[1:] if k in metrics}}
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self.fieldnames, extrasaction="ignore").writerow(row)


class TrainingMonitor:
    """Loss-anomaly detector with context dumps (train_eval_func_new_cp5.py:
    82-186): a loss is anomalous above ``threshold`` or above ``ratio``
    times the previous one; each anomaly writes a JSON file to
    ``anomaly_dir`` with the step, the loss, the last 10 losses of a window
    of ``window`` and the given context."""

    def __init__(self, anomaly_dir: str = "anomaly_checkpoints", threshold: float = 1000.0,
                 ratio: float = 100.0, window: int = 50):
        self.anomaly_dir = anomaly_dir
        self.threshold = threshold
        self.ratio = ratio
        self.window = window
        self.history: list = []

    def check(self, loss: float, step: int, context: Optional[dict] = None) -> bool:
        """True if this step is anomalous (and its context was dumped)."""
        anomalous = loss > self.threshold or (
            len(self.history) > 0 and loss > self.ratio * self.history[-1] > 0
        )
        self.history.append(loss)
        if len(self.history) > self.window:
            self.history.pop(0)
        if anomalous:
            os.makedirs(self.anomaly_dir, exist_ok=True)
            stamp = time.strftime("%Y%m%d_%H%M%S")
            payload = {"step": step, "loss": loss, "history": self.history[-10:]}
            if context:
                payload.update({k: str(v) for k, v in context.items()})
            name = os.path.join(self.anomaly_dir, f"anomaly_{stamp}_step{step}.json")
            with open(name, "w") as f:
                json.dump(payload, f, indent=2)
        return anomalous
