"""The program's own spans and host-sync counts
(``comet_tpu_torch.utils.profiling``: ``span``, ``recording``) read against
a traced run's two profiles, and a traced run of a cell with them on.

    python3 -m portbench.spans --workload <name> --seed <n> --seconds <s>

runs the cell as ``python3 -m portbench.run --trace 1`` does, with the fully
profiled units under ``profiling.recording(annotate=True, syncs=True)`` and
the device-only units under ``profiling.recording(annotate=False)``, so no
host event joins the light profile. It prints to stderr, per unit,
``idle <span> <ms>``: the device-only part's idle gaps by the innermost
program span open at each gap's start (``harness`` where none was), and
``sync <span> <file:line> <n>``: the full part's host synchronisations by
span and source line. Its last line is ``run``'s result with ``program``:
the readings of :data:`PROGRAM_METRICS` (``portbench/metrics/<name>.py``,
each given ``r.program``, a :class:`ProgramReading`) and the sums they are
held to.

The spans' times are ``time.time_ns()``; a chrome trace's ``ts`` (µs) plus
its ``baseTimeNanoseconds`` is on that clock, so the spans move onto a
trace's clock (seconds, as :class:`trace.Trace` keeps them) by subtracting
the base. In the full part the spans' ``comet.<name>`` annotations are on
the trace itself. Times are in seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .trace import _DEVICE_CATS, Trace, TracedWindow, _union, read_profile

ANNOTATION = "comet."
HARNESS = "harness"  # idle time where no program span was open
PROGRAM_METRICS = ("coarse_ms.infer", "fine_ms.infer", "backbone_ms.infer", "host_syncs.infer",
                   "program_idle_ms.infer", "backward_ms.train", "optimizer_ms.train",
                   "host_syncs.train", "program_idle_ms.train")
_SUFFIX = {"infer_closed": ".infer", "train_closed": ".train"}

Interval = Tuple[float, float]


def chrome(prof) -> Tuple[List[dict], int]:
    """The profile's chrome trace events and its ``baseTimeNanoseconds``,
    written under TMPDIR, read and deleted."""
    fd, path = tempfile.mkstemp(prefix="portbench-spans-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return data["traceEvents"], int(data["baseTimeNanoseconds"])


def annotations(events: Sequence[dict]) -> Dict[str, List[Interval]]:
    """The program spans' ``comet.<name>`` ranges in a trace, by name."""
    out: Dict[str, List[Interval]] = defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e["name"].startswith(ANNOTATION)):
            ts = e["ts"] * 1e-6
            out[e["name"][len(ANNOTATION):]].append((ts, ts + e.get("dur", 0) * 1e-6))
    return out


def on_trace_clock(rec, base_ns: int) -> List[Tuple[float, float, str]]:
    """A recording's spans as (start, end, name) on a trace's clock."""
    return [((s.t0 - base_ns) * 1e-9, (s.t1 - base_ns) * 1e-9, s.name) for s in rec.spans]


def idle_gaps(busy: List[Interval], window: Interval) -> List[Interval]:
    """The parts of ``window`` outside the sorted, disjoint ``busy``."""
    gaps, at = [], window[0]
    for a, b in busy:
        if a > at:
            gaps.append((at, min(a, window[1])))
        at = max(at, b)
        if at >= window[1]:
            break
    if at < window[1]:
        gaps.append((at, window[1]))
    return [(a, b) for a, b in gaps if b > a]


def innermost(spans: List[Tuple[float, float, str]], points: List[float]) -> List[Optional[str]]:
    """For each point, the name of the innermost of the nested ``spans``
    open at it (None where none is)."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    order = sorted(range(len(points)), key=points.__getitem__)
    out: List[Optional[str]] = [None] * len(points)
    stack: List[Tuple[float, float, str]] = []
    nxt = 0
    for i in order:
        p = points[i]
        while nxt < len(spans) and spans[nxt][0] <= p:
            while stack and stack[-1][1] < spans[nxt][0]:
                stack.pop()
            stack.append(spans[nxt])
            nxt += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


class ProgramReading:
    """What the program's spans say of one traced run: ``full`` (the fully
    profiled part's :class:`trace.Trace`), ``spans`` (its ``comet.*``
    ranges by name), ``syncs`` (its recording's host synchronisations by
    (span or None, ``file:line``)), ``units`` (of that part), and of the
    device-only part ``gaps`` (its idle gaps with the innermost program
    span open at each gap's start, or :data:`HARNESS`), ``device_units`` and
    ``device_idle_s`` (the part's window less its busy time)."""

    def __init__(self, full_events: Sequence[dict], syncs, units: int,
                 device_events: Optional[Sequence[dict]] = None, device_base_ns: int = 0,
                 device_recording=None, device_window_ns: Optional[Tuple[int, int]] = None,
                 device_units: int = 0, full: Optional[Trace] = None):
        self.full = full if full is not None else Trace(list(full_events))
        self.spans = annotations(full_events)
        self.syncs, self.units, self.device_units = syncs, units, device_units
        self.gaps: List[Tuple[float, float, str]] = []
        self.device_idle_s: Optional[float] = None
        if device_events is None or device_window_ns is None:
            return
        window = tuple((t - device_base_ns) * 1e-9 for t in device_window_ns)
        busy = _union([(e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6)
                       for e in device_events
                       if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS])
        gaps = idle_gaps(busy, window)
        names = innermost(on_trace_clock(device_recording, device_base_ns) if device_recording
                          else [], [a for a, _ in gaps])
        self.gaps = [(a, b, n or HARNESS) for (a, b), n in zip(gaps, names)]
        self.device_idle_s = sum(b - a for a, b in gaps)

    def span_device_s(self, name: str) -> Optional[float]:
        """Device seconds of the kernels launched inside the program span
        ``name`` in the full part; None where it or its kernels are missing."""
        if not self.spans.get(name):
            return None
        s = self.full.device_s_in(self.spans[name])
        return s if s > 0 else None

    def idle_by_span(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for a, b, name in self.gaps:
            out[name] += b - a
        return dict(out)

    def program_idle_s(self) -> Optional[float]:
        """Idle seconds of the device-only part whose gap began inside a
        program span; None without that part."""
        if self.device_idle_s is None:
            return None
        return sum(b - a for a, b, name in self.gaps if name != HARNESS)

    def host_syncs(self) -> int:
        """The full part's host synchronisations issued inside program spans."""
        return sum(n for (span, _), n in self.syncs.items() if span is not None)


class RecordedWindow(TracedWindow):
    """``trace.TracedWindow`` with the program's recordings open: the full
    part under ``recording(annotate=True, syncs=True)``, the device-only
    part under ``recording(annotate=False)`` and its bounds on the Unix
    clock. Each part's chrome trace is kept (``events``: part -> (events,
    base))."""

    def __init__(self, n: int, cuda: bool, finish):
        super().__init__(n, cuda, finish)
        self.recordings: Dict[str, object] = {}
        self.events: Dict[str, Tuple[List[dict], int]] = {}
        self.device_window_ns: Optional[Tuple[int, int]] = None
        self.units = {"full": 0, "device": 0}
        self._recording = None
        self._t_ns = 0

    def before(self, i: int) -> None:
        super().before(i)
        if i < self.n:
            self.units["full"] += 1
        elif i < self.tail_from:
            self.units["device"] += 1
        if i == 0 or (i == self.n and self.cuda):
            from comet_tpu_torch.utils import profiling

            part = "full" if i == 0 else "device"
            self._recording = profiling.recording(annotate=i == 0, syncs=i == 0)
            self.recordings[part] = self._recording.__enter__()
            self._t_ns = time.time_ns()

    def _stop(self) -> None:  # trace.TracedWindow._stop, with the recording closed first
        if self._open is None:
            return
        self.finish()
        if self._open is self.device:
            self.device_s = time.perf_counter() - self._t
            self.device_window_ns = (self._t_ns, time.time_ns())
        self._recording.__exit__(None, None, None)
        prof, self._open = self._open, None
        prof.__exit__(None, None, None)
        if prof is self.full:  # read now: the next profile clears its events
            self.full_trace = self.read(prof)

    def read(self, prof) -> Trace:
        """``trace.read_profile`` of one of the window's profiles, whose
        events and base it keeps (a profile's trace is exported once)."""
        part = "full" if prof is self.full else "device"
        self.events[part] = chrome(prof)
        return Trace(self.events[part][0])

    def reading(self) -> ProgramReading:
        device = self.events.get("device")
        return ProgramReading(
            self.events["full"][0], self.recordings["full"].syncs, self.units["full"],
            device[0] if device else None, device[1] if device else 0,
            self.recordings.get("device"), self.device_window_ns, self.units["device"],
            self.full_trace)


def traced_run(cell, seed: int, seconds: float, device) -> Tuple[dict, RecordedWindow]:
    """``run.run_cell(..., trace=True)`` with :class:`RecordedWindow` in
    ``TracedWindow``'s place; returns its result and the window."""
    from . import run, trace

    windows: List[RecordedWindow] = []

    class Window(RecordedWindow):
        def __init__(self, *args):
            super().__init__(*args)
            windows.append(self)

    trace.TracedWindow = Window
    trace.read_profile = lambda prof: windows[0].read(prof)  # run_cell reads the device part
    try:
        result = run.run_cell(cell, seed, seconds, True, device)
    finally:
        trace.TracedWindow, trace.read_profile = TracedWindow, read_profile
    return result, windows[0]


def program_metrics(cell, program: ProgramReading, cuda: bool) -> Dict[str, Optional[float]]:
    """The readings of the cell's :data:`PROGRAM_METRICS`; None off the card."""
    from types import SimpleNamespace

    suffix = _SUFFIX[cell.mix["mode"]]
    r = SimpleNamespace(program=program, units=program.units,
                        sequences=program.units * cell.mix["batch"])
    return {m: cell.reader(m)(r) if cuda else None for m in PROGRAM_METRICS
            if m.endswith(suffix)}


def report(result: dict, program: ProgramReading, values: dict, out=sys.stderr) -> dict:
    """Prints the idle and sync lines per unit; returns ``values`` with the
    sums the readings are held to."""
    idle = program.idle_by_span()
    for name, s in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"idle {name} {s * 1e3 / max(program.device_units, 1)!r}", file=out)
    for (span, where), n in sorted(program.syncs.items(), key=lambda kv: -kv[1]):
        print(f"sync {span or HARNESS} {where} {n / max(program.units, 1)!r}", file=out)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    sums = {"idle_table_ms": sum(idle.values()) * 1e3,
            "device_idle_ms": None if program.device_idle_s is None
            else program.device_idle_s * 1e3}
    dev = result["device"]
    if dev.get("busy_s") is not None and dev.get("window_s") is not None:
        sums["run_idle_ms"] = (dev["window_s"] - dev["busy_s"]) * 1e3
    if "coarse_ms.infer" in values and None not in (values["coarse_ms.infer"],
                                                   values["fine_ms.infer"]):
        sums["coarse_plus_fine_ms"] = values["coarse_ms.infer"] + values["fine_ms.infer"]
        sums["tracker_ms"] = m.get("tracker_ms.infer")
    if "backward_ms.train" in values and None not in (values["backward_ms.train"],
                                                     values["optimizer_ms.train"]):
        sums["backward_plus_optimizer_ms"] = (values["backward_ms.train"]
                                              + values["optimizer_ms.train"])
        sums["bwd_opt_ms"] = m.get("bwd_opt_ms.train")
    return dict(values, sums=sums)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from . import run

    run._pin_caches()
    cell = run.Cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA device", file=sys.stderr)
        return 2
    result, tw = traced_run(cell, args.seed, args.seconds, torch.device("cuda", 0))
    program = tw.reading()
    result["program"] = report(result, program, program_metrics(cell, program, True))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
