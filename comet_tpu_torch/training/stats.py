"""Metric accumulation, CSV logging and the loss-anomaly monitor.

Counterpart of ``comet_tpu/training/stats.py``: ``TO_PLOT_METRICS`` and
``RunningStats`` (the reference's VizStats subset, train_util.py:96-121,
1914-2037), ``CsvLogger`` (abl_ours.py:9-22; one CSV row per epoch) and
``TrainingMonitor`` (train_eval_func_new_cp5.py:82-186), and the CSV's
curves as a PNG (``plot_metrics_png``, matplotlib, imported in the call)
and as a static HTML dashboard (``write_live_dashboard``).
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


def plot_metrics_png(csv_path: str, out_path: str = None) -> str:
    """Render the CsvLogger history as a grid of per-metric curves.

    The matplotlib stand-in for the reference's VizStats plotting
    (pytorch3d implicitron Stats.plot_stats + visdom live plots,
    train_util.py:1914-2037): one small subplot per logged metric over
    epochs, written as a PNG next to the CSV.
    """
    import csv as _csv

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(csv_path, newline="") as f:
        rows = list(_csv.DictReader(f))
    if not rows:
        raise ValueError(f"no rows in {csv_path}")
    keys = [k for k in rows[0] if k != "epoch"]
    series = {
        k: [(int(r["epoch"]), float(r[k])) for r in rows if r.get(k) not in (None, "")]
        for k in keys
    }
    series = {k: v for k, v in series.items() if v}

    n = len(series)
    cols = 4
    nrows = (n + cols - 1) // cols
    fig, axes = plt.subplots(
        nrows, cols, figsize=(3.2 * cols, 2.2 * nrows), squeeze=False
    )
    for ax in axes.flat[n:]:
        ax.axis("off")
    for ax, (k, pts) in zip(axes.flat, sorted(series.items())):
        xs, ys = zip(*pts)
        ax.plot(xs, ys, lw=1.2)
        ax.set_title(k, fontsize=8)
        ax.tick_params(labelsize=6)
    fig.tight_layout()
    out_path = out_path or os.path.splitext(csv_path)[0] + ".png"
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def write_live_dashboard(csv_path: str, out_path: str = None,
                         refresh_s: int = 15) -> str:
    """Self-contained auto-refreshing HTML training dashboard.

    The live-view role of the reference's visdom VizStats
    (train_util.py:1914-2037) and gluefactory's TensorBoard (train.py:20,
    230), with zero server and zero dependencies: one static HTML file
    next to the CSV that re-fetches the CSV every ``refresh_s`` seconds
    and redraws one inline-SVG sparkline chart per metric. Open it in any
    browser (file:// works) while training appends rows.
    """
    out_path = out_path or os.path.join(
        os.path.dirname(csv_path) or ".", "dashboard.html"
    )
    csv_name = os.path.basename(csv_path)
    html = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>comet_tpu_torch training</title>
<style>
 body{font-family:system-ui,sans-serif;background:#111;color:#ddd;margin:16px}
 h1{font-size:16px;font-weight:600} .t{color:#888;font-size:11px}
 .grid{display:grid;grid-template-columns:repeat(auto-fill,minmax(260px,1fr));gap:10px}
 .card{background:#1c1c1e;border-radius:8px;padding:8px 10px}
 .k{font-size:11px;color:#aaa} .v{font-size:15px;font-weight:600}
 svg{width:100%;height:54px} path{fill:none;stroke:#6aa9ff;stroke-width:1.5}
</style></head><body>
<h1>comet_tpu_torch training <span class="t" id="stamp"></span></h1>
<div class="grid" id="grid"></div>
<script>
const CSV = "__CSV__", REFRESH = __REFRESH__ * 1000;
async function tick() {
  try {
    const txt = await (await fetch(CSV + "?t=" + Date.now())).text();
    const lines = txt.trim().split("\\n");
    const head = lines[0].split(",");
    const rows = lines.slice(1).map(l => l.split(","));
    const grid = document.getElementById("grid");
    grid.innerHTML = "";
    for (let c = 1; c < head.length; c++) {
      const ys = rows.map(r => parseFloat(r[c])).filter(Number.isFinite);
      if (!ys.length) continue;
      const lo = Math.min(...ys), hi = Math.max(...ys), span = (hi - lo) || 1;
      const pts = ys.map((y, i) =>
        `${(i / Math.max(ys.length - 1, 1)) * 100},${52 - ((y - lo) / span) * 48}`
      ).join(" L");
      grid.insertAdjacentHTML("beforeend",
        `<div class="card"><div class="k">${head[c]}</div>` +
        `<div class="v">${ys[ys.length - 1].toPrecision(5)}</div>` +
        `<svg viewBox="0 0 100 54" preserveAspectRatio="none">` +
        `<path d="M${pts}"/></svg></div>`);
    }
    document.getElementById("stamp").textContent =
      `epoch ${rows.length ? rows[rows.length - 1][0] : "-"} - ` +
      new Date().toLocaleTimeString();
  } catch (e) {
    document.getElementById("stamp").textContent = "waiting for " + CSV;
  }
}
tick(); setInterval(tick, REFRESH);
</script></body></html>
"""
    html = html.replace("__CSV__", csv_name).replace(
        "__REFRESH__", str(int(refresh_s))
    )
    with open(out_path, "w") as f:
        f.write(html)
    return out_path
