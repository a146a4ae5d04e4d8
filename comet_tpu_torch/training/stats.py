"""Per-epoch running averages of the metric rows.

Counterpart of ``RunningStats`` in ``comet_tpu/training/stats.py`` (the
reference's AverageMeter-style VizStats subset); ``CsvLogger`` and
``TrainingMonitor`` come with training.
"""

from __future__ import annotations

import gzip
import json
import time
from collections import defaultdict
from typing import Dict


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
