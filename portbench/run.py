"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``portbench/configs/<file>``), a traffic mix
(``portbench/traffic/<traffic>.json``) and, through the metrics that list
it, the readers of its per-layer metrics (``portbench/metrics/<name>.py``).
Nothing here names a cell: a new one is a new entry and new data files.

A run makes the weights and the requests from ``--seed`` on the card, warms
every shape up (set-up), sends the traffic for ``--seconds`` (the window),
then checks a sample of the window's requests against the plain reference
(``portbench/check.py``). With ``--trace 0`` it reports the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from
profiles of the window's first requests and the rate of the rest
(``trace.TracedWindow``).
"""

import time

_T0 = time.perf_counter()  # set-up is timed from here, before the imports

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "comet_tpu")


def _pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic mix
    and metrics, found by name."""

    def __init__(self, name: str, root: Path = ROOT, cfg: Optional[dict] = None):
        with open(root / "BENCHMARK.json") as f:
            bench = json.load(f)
        self.root, self.name = root, name
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(work)}")
        self.workload = work[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        if cfg is None:
            with open(root / conf["file"]) as f:
                cfg = json.load(f)
        self.cfg = cfg
        from . import traffic

        self.mix = traffic.load(root / "portbench" / "traffic" / f"{self.workload['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]

    def reader(self, metric: str):
        """The ``read`` function of ``portbench/metrics/<metric>.py``."""
        path = self.root / "portbench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def model_flops_per_sequence(cfg: dict, mode: str = "infer_closed") -> float:
    """Operations of one sequence through the plain reference at the cell's
    shapes, counted by ``FlopCounterMode`` on the meta device: the forward,
    and for training the backward of the trained camera predictor too."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .program import parameter_shapes
    from .reference import comet as ref
    from .reference.train import trainable

    meta = torch.device("meta")
    train = mode == "train_closed"
    params = {k: torch.empty(s, device=meta, requires_grad=train and trainable(k))
              for k, s in parameter_shapes(cfg).items()}
    s, hw, n = cfg["seqlen"], cfg["img_size"], cfg["track_num"]
    images = torch.empty((1, s, hw, hw, 3), device=meta)
    queries = torch.empty((1, n, 2), device=meta)
    plain, spec = ref.Plain(params), ref.tracker_spec(cfg)
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():  # the trackers are frozen
            coarse, _ = plain.coarse(images, queries, spec)
            refined, fine_rel, qfeat, pfeat = plain.fine(images, coarse, spec)
            conf = ref.confidence_from_score(ref.score_from_fine(
                qfeat, pfeat, fine_rel, spec["fine"]["sradius"], 2 * spec["fine"]["pradius"] + 1))
        with torch.set_grad_enabled(train):
            pose = plain.camera(images, refined, conf, ref.camera_spec(cfg))
        if train:
            pose.sum().backward()
    return float(counter.get_total_flops())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float = _T0) -> dict:
    """One run of ``cell``; returns the result's dict (the keys the driver
    reads, ``check`` last). On a device other than CUDA every metric's value
    is None: no device number comes from a CPU run."""
    import torch

    from . import check
    from .modes import MODES
    from .trace import TracedWindow, read_profile

    cfg, mix = cell.cfg, cell.mix
    cuda = device.type == "cuda"
    marks = [("imports", time.perf_counter())]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        from comet_tpu_torch.ops import kernels

        kernels.library()  # builds into the port's fixed directory on a checkout's first run
    marks.append(("library", time.perf_counter()))
    loop = MODES[mix["mode"]](cell, seed, device)  # set-up: weights, inputs, warm-up
    marks += loop.marks
    spans = traced_spans = loop.spans() if trace else None
    loop.finish()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    print("setup " + " ".join(f"{name} {b - a:.3f}" for (_, a), (name, b)
                              in zip([("", t0)] + marks, marks)), file=sys.stderr)

    # the window; a traced run profiles its first units (trace.TracedWindow)
    lat: List[float] = []
    tw = TracedWindow(mix["trace_requests"], cuda, loop.finish) if trace else None
    start = time.perf_counter()
    end = start + seconds
    while time.perf_counter() < end:
        i = len(lat)
        if tw is not None:
            tw.before(i)
        t = time.perf_counter()
        if tw is not None and tw.spanned(i):
            with torch.profiler.record_function("portbench.request"):
                loop.unit(i)
        else:
            loop.unit(i)
        lat.append(time.perf_counter() - t)
        if tw is not None:
            tw.after(i)
            if i + 1 == tw.n:
                spans.remove()  # the spans' hooks cost host time; the rest reads no span
                spans = None
    loop.finish()
    if tw is not None:
        tw.close()
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if spans is not None:
        spans.remove()
    found = _forbidden_modules()
    if found:
        raise SystemExit(f"portbench: the run loaded {', '.join(found)} (a JAX module or the JAX "
                         f"package); the port must run without them")

    # the check, once the program is freed
    attempted, failed = len(lat), loop.failed()
    gaps, whole = loop.judge()
    limits = cfg["limits"][mix["mode"]]
    correct = whole and failed == 0 and check.verdict(gaps, limits)

    metrics: Dict[str, dict] = {}
    result_device = {"platform": "gpu" if cuda else device.type,
                     "kind": torch.cuda.get_device_name(device) if cuda else None,
                     "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if not trace:
        values = dict(loop.values(attempted, window_s, lat), setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]] if cuda else None, "unit": m["unit"]}
    else:
        tr = tw.full_trace
        dev = read_profile(tw.device) if tw.device is not None else None
        busy = dev.busy_s if dev is not None and tw.device_s > 0 else None
        units = len(tr.spans.get("request", []))
        reading = SimpleNamespace(
            trace=tr, units=units, sequences=units * mix["batch"],
            busy_s=busy, window_s=tw.device_s if busy is not None else None,
            tail_sequences=tw.tail_units * mix["batch"], tail_s=tw.tail_s,
            backward_work=getattr(traced_spans, "backward_work", []),
            model_flops_per_sequence=lambda: model_flops_per_sequence(cfg, mix["mode"]))
        for m in cell.per_layer:
            v = cell.reader(m["name"])(reading) if cuda else None
            if v is not None or not cuda:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result_device["busy_s"] = reading.busy_s
        result_device["window_s"] = reading.window_s
        if cuda:
            breakdown = tr.breakdown(tr.window())
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _pin_caches()
    cell = Cell(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(f"check correct {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
