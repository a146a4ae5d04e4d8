"""The readings of the program's spans (``portbench/spans.py`` and its
metrics) on hand-built traces and recordings, and a traced run of the tiny
cell on the CPU with the program's recordings open."""

from __future__ import annotations

import io
import time
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from comet_tpu_torch.utils.profiling import Recording, SpanRecord
from portbench import run, spans

from portbench_tiny import tiny_cell

BASE_NS = 1_700_000_000_000_000_000
NEW = spans.PROGRAM_METRICS


def _x(name, cat, ts, dur=0, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def _full_events():
    """Three program spans, a kernel launched inside each and one outside (µs)."""
    return [
        _x("comet.tracker.coarse", "user_annotation", 100, 50),
        _x("comet.tracker.fine", "user_annotation", 160, 40),
        _x("comet.camera.backbone", "user_annotation", 210, 20),
        _x("comet.train.backward", "user_annotation", 400, 10),  # launches nothing
        *[_x("cudaLaunchKernel", "cuda_runtime", ts, 2, correlation=c)
          for c, ts in ((1, 110), (2, 170), (3, 215), (4, 300))],
        _x("k1", "kernel", 120, 30, correlation=1), _x("k2", "kernel", 175, 10, correlation=2),
        _x("k3", "kernel", 220, 5, correlation=3), _x("k4", "kernel", 305, 7, correlation=4),
    ]


def _device_part():
    """A 1 ms device-only window with three busy intervals and three gaps,
    which start before any span, inside ``tracker.coarse`` (nested in
    ``tracker`` and ``forward``) and inside ``forward`` alone."""
    events = [_x("k", "kernel", a, b - a) for a, b in ((100, 300), (400, 500), (600, 1000))]
    rec = Recording(annotate=False, spans=[
        SpanRecord("forward", -1, 0, BASE_NS + 50_000, BASE_NS + 700_000),
        SpanRecord("tracker", 0, 0, BASE_NS + 250_000, BASE_NS + 450_000),
        SpanRecord("tracker.coarse", 1, 0, BASE_NS + 280_000, BASE_NS + 350_000)])
    return events, rec, (BASE_NS, BASE_NS + 1_000_000)


def _reading(units=2, device_units=2):
    events, rec, window = _device_part()
    syncs = Counter({("camera", "camera_predictor.py:166"): 4,
                     ("train.forward", "codecs.py:58"): 2, (None, "modes.py:60"): 3})
    return spans.ProgramReading(_full_events(), syncs, units, events, BASE_NS, rec, window,
                                device_units)


def test_kernels_are_put_down_to_the_span_that_launched_them():
    p = _reading()
    assert p.span_device_s("tracker.coarse") == pytest.approx(30e-6)
    assert p.span_device_s("tracker.fine") == pytest.approx(10e-6)
    assert p.span_device_s("camera.backbone") == pytest.approx(5e-6)
    assert p.span_device_s("train.backward") is None  # a span whose kernels are missing
    assert p.span_device_s("train.optimizer") is None  # a span the trace lacks


def test_idle_gaps_go_to_the_innermost_open_span_or_the_harness():
    p = _reading()
    idle = p.idle_by_span()
    assert idle == pytest.approx({spans.HARNESS: 100e-6, "tracker.coarse": 100e-6,
                                  "forward": 100e-6})
    assert p.device_idle_s == pytest.approx(300e-6) == pytest.approx(sum(idle.values()))
    assert p.program_idle_s() == pytest.approx(200e-6)
    assert p.host_syncs() == 6  # the harness's own 3 left out


def test_the_new_readers_give_the_known_values():
    cell = run.Cell("ours-infer-b8")
    r = SimpleNamespace(program=_reading(), units=2, sequences=16)
    want = {"coarse_ms.infer": 30e-3 / 16, "fine_ms.infer": 10e-3 / 16,
            "backbone_ms.infer": 5e-3 / 16, "host_syncs.infer": 3.0,
            "program_idle_ms.infer": 0.1, "backward_ms.train": None,
            "optimizer_ms.train": None, "host_syncs.train": 3.0, "program_idle_ms.train": 0.1}
    got = {m: cell.reader(m)(r) for m in NEW}
    assert got == pytest.approx(want)


def test_the_new_readers_read_none_from_a_run_without_the_program_spans():
    """``run.py``'s reading has no ``program``, as off the card."""
    cell = run.Cell("ours-infer-b8")
    r = SimpleNamespace(trace=None, units=4, sequences=32, busy_s=None, window_s=None)
    assert {m: cell.reader(m)(r) for m in NEW} == {m: None for m in NEW}
    no_device = spans.ProgramReading(_full_events(), Counter(), 2)
    r.program = no_device
    assert cell.reader("program_idle_ms.infer")(r) is None


def test_a_cpu_traced_run_keeps_the_program_spans_and_prints_its_tables():
    cell = tiny_cell()
    result, tw = spans.traced_run(cell, 2**31 + 11, 3.0, torch.device("cpu"))
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    p = tw.reading()
    assert p.units >= 1 and p.device_units == 0  # no device-only part without a card
    names = ["forward", "tracker", "tracker.coarse", "tracker.fine", "camera", "camera.backbone"]
    assert sorted(p.spans) == sorted(names)
    assert all(len(p.spans[n]) == p.units for n in names)
    rec = tw.recordings["full"]
    assert [s.name for s in rec.spans[:6]] == names  # in the order they opened
    values = spans.program_metrics(cell, p, cuda=False)
    assert values == {m: None for m in NEW if m.endswith(".infer")}
    out = io.StringIO()
    summary = spans.report(result, p, values, out=out)
    assert summary["sums"]["device_idle_ms"] is None
    assert all(line.startswith(("idle ", "sync ")) for line in out.getvalue().splitlines())
