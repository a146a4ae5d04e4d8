"""The traced run: spans around the port's layers, the profiler's device
trace, and what the per-layer readers read from it.

Spans come from the benchmark's own hooks (``LayerSpans``, ``TrainSpans``)
and loop: ``torch.profiler.record_function`` ranges named
``portbench.<name>`` around each request or train step (``request``), from
the start of ``COMET.forward`` to the call of its camera predictor
(``tracker``), over the camera predictor (``camera``), and over a train
step's forward (``forward``). Nothing inside the program changes.

The profiler's chrome trace is written under ``TMPDIR``, read once into a
:class:`Trace` and deleted. Times are in seconds. A kernel belongs to the
span, or the ``comet::`` operator call, within whose host interval its
launch was issued.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from .reference.flops import KERNEL_OPERATORS, bound_s, operator_work

SPAN_PREFIX = "portbench."
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class _Ranges:
    """``record_function`` ranges opened and closed by hooks, by name."""

    def __init__(self):
        self.open: Dict[str, object] = {}
        self.handles: list = []

    def enter(self, name: str) -> None:
        rf = torch.profiler.record_function(SPAN_PREFIX + name)
        rf.__enter__()
        self.open[name] = rf

    def exit(self, name: str) -> None:
        rf = self.open.pop(name, None)
        if rf is not None:
            rf.__exit__(None, None, None)

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


class LayerSpans(_Ranges):
    """Forward hooks that open and close the layer spans on a COMET model:
    ``tracker`` from the start of its forward to its camera predictor's
    call, ``camera`` over that call."""

    def __init__(self, model):
        super().__init__()
        cam = model.camera_predictor

        def to_camera(module, args):  # returns None: the inputs stay as they are
            self.exit("tracker")
            self.enter("camera")

        self.handles = [
            model.register_forward_pre_hook(lambda m, a: self.enter("tracker")),
            cam.register_forward_pre_hook(to_camera),
            cam.register_forward_hook(lambda m, a, o: self.exit("camera")),
        ]


class TrainSpans(_Ranges):
    """Forward hooks that put a train step's forward in a span ``forward``
    (the rest of the step is its backward and optimizer), and a span
    ``vjp.<i>`` around each call of an operator's registered backward
    (``ops.library.plain_vjp``, which the operators look up at call time),
    whose least work ``backward_work[i]`` holds."""

    def __init__(self, model):
        from comet_tpu_torch.ops import library

        from .reference.flops import operator_backward_work

        super().__init__()
        self.handles = [
            model.register_forward_pre_hook(lambda m, a: self.enter("forward")),
            model.register_forward_hook(lambda m, a, o: self.exit("forward")),
        ]
        self.library, self.plain_vjp = library, library.plain_vjp
        self.backward_work: list = []

        def spanned(name, inputs, needs, grad):
            i = len(self.backward_work)
            shapes = [list(t.shape) if isinstance(t, torch.Tensor) else [] for t in inputs]
            self.backward_work.append(operator_backward_work(name, shapes))
            with torch.profiler.record_function(f"{SPAN_PREFIX}vjp.{i}"):
                return self.plain_vjp(name, inputs, needs, grad)

        library.plain_vjp = spanned

    def remove(self) -> None:
        super().remove()
        self.library.plain_vjp = self.plain_vjp


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Trace:
    """What a chrome trace of the window holds, reduced: device intervals,
    each kernel's launch time, the spans and the operator calls."""

    def __init__(self, events: List[dict]):
        self.kernels: List[Tuple[float, float, str, Optional[int]]] = []  # start, end, name, corr
        launches: Dict[int, float] = {}
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.ops: List[Tuple[float, float, str, list]] = []
        self.host_ops: List[Tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), e["ts"] * 1e-6, e.get("dur", 0) * 1e-6
            args = e.get("args", {})
            if cat in _DEVICE_CATS:
                self.kernels.append((ts, ts + dur, e["name"], args.get("correlation")))
            elif cat in _LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = ts
            elif cat == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
                self.spans[e["name"][len(SPAN_PREFIX):]].append((ts, ts + dur))
            elif cat == "cpu_op":
                self.host_ops.append((ts, ts + dur, e["name"]))
                if e["name"] in KERNEL_OPERATORS:
                    self.ops.append((ts, ts + dur, e["name"], args.get("Input Dims", [])))
        self.launch_of = [launches.get(k[3]) for k in self.kernels]
        self.busy = _union([(a, b) for a, b, _, _ in self.kernels])
        self.busy_s = sum(b - a for a, b in self.busy)
        order = sorted((t, i) for i, t in enumerate(self.launch_of) if t is not None)
        self._launch_times = [t for t, _ in order]
        self._launch_kernel = [i for _, i in order]

    def _kernels_launched_in(self, a: float, b: float) -> List[int]:
        lo = bisect.bisect_left(self._launch_times, a)
        hi = bisect.bisect_right(self._launch_times, b)
        return self._launch_kernel[lo:hi]

    def device_s_in(self, intervals: List[Tuple[float, float]]) -> float:
        """Device seconds of the kernels launched within the host intervals."""
        return sum(self.kernels[i][1] - self.kernels[i][0]
                   for a, b in intervals for i in self._kernels_launched_in(a, b))

    def span_device_s(self, name: str) -> Optional[float]:
        """Device seconds of the kernels launched inside span ``name``; None
        where the span or its kernels are missing."""
        if not self.spans.get(name):
            return None
        s = self.device_s_in(self.spans[name])
        return s if s > 0 else None

    def operator_roofline(self) -> Optional[Tuple[float, float]]:
        """(least seconds, device seconds) summed over every ``comet::``
        operator call whose kernels the trace holds; None without one."""
        least = device = 0.0
        for a, b, name, dims in self.ops:
            t = self.device_s_in([(a, b)])
            work = operator_work(name, dims)
            if t <= 0 or work is None:
                continue
            flops, nbytes, peak = work
            least += bound_s(flops, nbytes, peak)[0]
            device += t
        return (least, device) if device > 0 else None

    def window(self) -> Tuple[float, float]:
        """From the first ``request`` span's start to the later of the last
        one's end and the last device interval's end."""
        req = self.spans.get("request", [])
        if not req:
            return 0.0, 0.0
        end = max(b for _, b in req)
        if self.busy:
            end = max(end, self.busy[-1][1])
        return min(a for a, _ in req), end

    def breakdown(self, window: Tuple[float, float], top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle gaps of
        the device inside ``window`` summed by the innermost host operation
        open at each gap's start ("python" where none is)."""
        by_name: Dict[str, float] = defaultdict(float)
        for a, b, name, _ in self.kernels:
            by_name[name] += b - a
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps: Dict[str, float] = defaultdict(float)
        host = sorted(self.host_ops, key=lambda h: (h[0], -h[1]))
        edges = [window[0]] + [x for iv in self.busy for x in iv] + [window[1]]
        stack: List[Tuple[float, float, str]] = []
        nxt = 0
        for a, b in zip(edges[::2], edges[1::2]):
            a, b = max(a, window[0]), min(b, window[1])
            if b <= a:
                continue
            # host operations nest, so the innermost one open at a is on top
            while nxt < len(host) and host[nxt][0] <= a:
                while stack and stack[-1][1] < host[nxt][0]:
                    stack.pop()
                stack.append(host[nxt])
                nxt += 1
            while stack and stack[-1][1] < a:
                stack.pop()
            gaps[stack[-1][2] if stack else "python"] += b - a
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


def profile():
    """A profiler of host and device with shapes recorded, for one window."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=True)


class TracedWindow:
    """A traced run's window in three parts, by unit. The first ``n`` units
    run under :func:`profile` with a ``request`` span each (the spans, the
    operator calls and the breakdown). Host operations and shapes recorded
    at every call slow a host-paced unit, so the device's busy time and the
    window it is set against come from the next ``n`` units, under a profile
    of the device alone, timed by the host clock between synchronisations.
    The rest of the window runs untraced and gives the rate that the
    whole-step readings use. On a host without a card the second part is
    left out."""

    def __init__(self, n: int, cuda: bool, finish):
        self.n, self.cuda, self.finish = n, cuda, finish
        self.tail_from = 2 * n if cuda else n
        self.full = self.device = self._open = None
        self.full_trace: Optional[Trace] = None
        self.device_s = 0.0
        self.tail_units, self.tail_s = 0, 0.0
        self._t = None

    def spanned(self, i: int) -> bool:
        return i < self.n

    def before(self, i: int) -> None:
        if i == 0:
            self._open = self.full = profile()
            self._open.__enter__()
        elif i == self.n and self.cuda:
            self.finish()
            self._open = self.device = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self._open.__enter__()
            self._t = time.perf_counter()
        if i == self.tail_from:
            self._t = time.perf_counter()
        if i >= self.tail_from:
            self.tail_units += 1

    def after(self, i: int) -> None:
        if i + 1 in (self.n, self.tail_from):
            self._stop()

    def _stop(self) -> None:
        if self._open is None:
            return
        self.finish()
        if self._open is self.device:
            self.device_s = time.perf_counter() - self._t
        prof, self._open = self._open, None
        prof.__exit__(None, None, None)
        if prof is self.full:  # read now: the next profile clears its events
            self.full_trace = read_profile(prof)

    def close(self) -> None:
        """At the window's end, after the last unit's synchronisation."""
        if self._open is not None:
            self._stop()
        elif self.tail_units:
            self.tail_s = time.perf_counter() - self._t


def read_profile(prof) -> Trace:
    """The profile's chrome trace, written under TMPDIR, read and deleted."""
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return Trace(data["traceEvents"] if isinstance(data, dict) else data)
