"""The program's spans and host-sync counters (``utils/profiling.py``:
``span``, ``recording``, ``SPANS``) at the dry run's tiny configuration.

Off, a span records nothing and adds no profiler event; on, one forward and
one train step give the tree of ``SPANS``; a sync warning is counted under
the innermost open span and its source line; the spans' Unix-clock
intervals bracket their ``comet.*`` events in the chrome trace once its
``baseTimeNanoseconds`` is added; ``profiling.trace`` writes them. The
``-m cuda`` cases run on the card without the JAX-side conftest:

    python -m pytest tests/test_torch_port_tracing.py --noconftest -q
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path

import pytest
import torch

from comet_tpu_torch.config import get_config
from comet_tpu_torch.entry import _dryrun_batch, dryrun_config
from comet_tpu_torch.models import build_comet
from comet_tpu_torch.training import build_optimizer, build_train_step
from comet_tpu_torch.utils import profiling

FORWARD_TREE = {"forward": None, "tracker": "forward", "tracker.coarse": "tracker",
                "tracker.fine": "tracker", "camera": "forward",
                "camera.backbone": "camera"}
TRAIN_TREE = dict(FORWARD_TREE, forward="train.forward", **{
    "train.step": None, "train.forward": "train.step", "train.backward": "train.step",
    "train.optimizer": "train.step", "train.decode": "train.step"})

# Every host synchronisation of one comet-ours forward and of one train step
# at batch 2 on the card, by (innermost span, file:line), as PERF.md lists
# them; the kernels are compiled for the published widths only, so these run
# at full width.
FORWARD_SYNCS = {("camera", "camera_predictor.py:153"): 1,
                 ("camera", "camera_predictor.py:166"): 1,
                 ("camera", "camera_predictor.py:167"): 1}
TRAIN_SYNCS = {**FORWARD_SYNCS,
               ("train.forward", "quaternions.py:43"): 2,
               ("train.forward", "codecs.py:58"): 2}


@pytest.fixture(scope="module")
def tiny():
    cfg = dryrun_config()
    model = build_comet(cfg, device="cpu", seed=0)
    return cfg, model, _dryrun_batch(cfg, 2, "cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sync debug mode and the card's trace")
    return torch.device("cuda")


def _unit(which, cfg, model, batch):
    """One forward or one train step of ``model`` on ``batch``, as a call."""
    images, queries, cams = batch
    if which == "forward":
        def forward():
            with torch.no_grad():
                return model(images, queries)
        return forward
    optimizer, scheduler = build_optimizer(model, cfg.train.lr, steps_per_epoch=100)
    step = build_train_step(model, cfg, optimizer, scheduler)
    return lambda: step(images, queries, cams)


def _warn(text):
    warnings.warn(text)


WARN_LINE = _warn.__code__.co_firstlineno + 1


def _chrome(prof, path):
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    return data["traceEvents"], int(data["baseTimeNanoseconds"])


def test_spans_off_record_nothing_and_enter_no_range(tiny, monkeypatch):
    cfg, model, (images, queries, _) = tiny
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model(images, queries)
    assert not [e for e in prof.events() if e.name.startswith("comet.")]

    def no_range(name):
        raise AssertionError(f"a span entered record_function({name!r}) while off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    with torch.no_grad():
        model(images, queries)
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and not rec.syncs
    with pytest.raises(KeyError):  # an exception passes through a span that is off
        with profiling.span("forward"):
            raise KeyError("x")


@pytest.mark.parametrize("which,tree", [("forward", FORWARD_TREE), ("train", TRAIN_TREE)])
def test_one_unit_gives_the_spans_tree(tiny, which, tree):
    cfg, model, batch = tiny
    unit = _unit(which, cfg, model, batch)
    with profiling.recording(annotate=False) as rec:
        unit()
    assert set(tree) <= set(profiling.SPANS)
    assert sorted(s.name for s in rec.spans) == sorted(tree)  # each name once
    root = rec.spans[0]
    assert tree[root.name] is None and root.parent == -1 and root.root == 0
    for s in rec.spans:
        assert s.root == 0 and s.t0 <= s.t1
        if s.parent >= 0:
            parent = rec.spans[s.parent]
            assert parent.name == tree[s.name], s.name
            assert parent.t0 <= s.t0 and s.t1 <= parent.t1, s.name
    assert profiling.span("forward") is profiling._NO_SPAN  # off again after the block


def test_recording_is_one_at_a_time_and_an_exception_closes_its_spans():
    with profiling.recording(annotate=False) as rec:
        with pytest.raises(RuntimeError, match="already open"):
            with profiling.recording():
                pass
        with pytest.raises(KeyError):
            with profiling.span("train.step"):
                with profiling.span("train.backward"):
                    raise KeyError("x")
        with profiling.span("forward"):
            pass
    assert [(s.name, s.parent, s.root) for s in rec.spans] == [
        ("train.step", -1, 0), ("train.backward", 0, 0), ("forward", -1, 2)]
    assert all(s.t1 >= s.t0 > 0 for s in rec.spans)


def test_a_sync_warning_is_counted_under_its_span_and_line(monkeypatch):
    modes = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    filters, shown = list(warnings.filters), warnings.showwarning
    where = f"{Path(__file__).name}:{WARN_LINE}"
    with warnings.catch_warnings(record=True) as passed:
        warnings.simplefilter("always")
        with profiling.recording(annotate=False, syncs=True) as rec:
            assert modes == ["warn"]
            with profiling.span("camera"):
                with profiling.span("camera.backbone"):
                    pass
                _warn(profiling.SYNC_WARNING)
                _warn("called a synchronizing CUDA operation")  # torch's text
            _warn(profiling.SYNC_WARNING)
            _warn("another warning")
    assert dict(rec.syncs) == {("camera", where): 2, (None, where): 1}
    assert [str(w.message) for w in passed] == ["another warning"]  # only the syncs are kept
    assert modes == ["warn", 0]
    assert warnings.filters == filters and warnings.showwarning is shown


def test_span_times_bracket_their_chrome_trace_events(tiny, tmp_path):
    """The spans' ``time.time_ns`` interval holds its ``record_function``
    event, whose ``ts`` (µs) plus ``baseTimeNanoseconds`` is on the same
    Unix clock, within 1 µs of float arithmetic."""
    cfg, model, (images, queries, _) = tiny
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.recording(annotate=True) as rec, torch.no_grad():
            model(images, queries)
    events, base = _chrome(prof, tmp_path / "trace.json")
    seen = sorted((e["ts"], e["name"], e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"].startswith("comet."))
    assert [n for _, n, _ in seen] == ["comet." + s.name for s in rec.spans]
    for (ts, _, dur), s in zip(seen, rec.spans):
        start, end = ts * 1e3 + base, (ts + dur) * 1e3 + base
        assert s.t0 <= start + 1e3 and end <= s.t1 + 1e3, (s.name, s.t0 - start, s.t1 - end)


def test_trace_writes_the_spans_into_trace_json(tiny, tmp_path):
    cfg, model, (images, queries, _) = tiny
    with profiling.trace(str(tmp_path), device="cpu"), torch.no_grad():
        model(images, queries)
    data = json.loads((tmp_path / "trace.json").read_text())
    names = [e["name"] for e in data["traceEvents"] if e.get("name", "").startswith("comet.")]
    assert sorted(names) == sorted("comet." + n for n in FORWARD_TREE)


@pytest.mark.cuda
def test_a_kernel_launched_inside_a_span_lands_after_its_t0(cuda_device, tmp_path):
    x = torch.randn(2048, 2048, device=cuda_device)
    x @ x
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.recording(annotate=True) as rec:
            with profiling.span("tracker"):
                for _ in range(4):
                    x = x @ x * 1e-3
            torch.cuda.synchronize()
    events, base = _chrome(prof, tmp_path / "trace.json")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels
    (span,) = rec.spans
    for e in kernels:
        assert e["ts"] * 1e3 + base >= span.t0, (e["name"], e["ts"] * 1e3 + base - span.t0)
    (ann,) = [e for e in events  # the host's range, not its copy on the card's stream
              if e.get("name") == "comet.tracker" and e.get("cat") == "user_annotation"]
    assert span.t0 <= ann["ts"] * 1e3 + base + 1e3
    assert (ann["ts"] + ann["dur"]) * 1e3 + base <= span.t1 + 1e3


@pytest.mark.cuda
@pytest.mark.parametrize("which,expected", [("forward", FORWARD_SYNCS), ("train", TRAIN_SYNCS)])
def test_a_units_syncs_are_the_listed_sites(cuda_device, which, expected):
    cfg = get_config("ours")
    model = build_comet(cfg, device=cuda_device, seed=0)
    unit = _unit(which, cfg, model, _dryrun_batch(cfg, 2, cuda_device))
    unit()  # warm: the kernels' first calls
    torch.cuda.synchronize()
    with profiling.recording(annotate=False, syncs=True) as rec:
        unit()
    assert dict(rec.syncs) == expected, dict(rec.syncs)
