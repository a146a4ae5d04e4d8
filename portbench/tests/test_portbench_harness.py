"""The harness on the CPU at a tiny size: what it finds by name, the shape
of its result line, and that the check catches a wrong answer where it is
produced."""

from __future__ import annotations

import json
import shutil
import time

import pytest
import torch

from portbench import run

from portbench_tiny import ROOT, tiny_cell

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


def _run(cell, seconds=2.0, trace=False, seed=2**31 + 11):
    return run.run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())


def test_a_traffic_file_added_in_a_copy_is_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((ROOT / "portbench" / "traffic" / "infer-b8.json").read_text())
    mix.update(batch=2, why="a mix added by a later change")
    (tmp_path / "portbench" / "traffic" / "infer-b2.json").write_text(json.dumps(mix))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ours-infer-b2", "config": "comet-ours",
                               "traffic": "infer-b2", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = run.Cell("ours-infer-b2", root=tmp_path)
    assert cell.mix["batch"] == 2 and cell.mix["why"] == "a mix added by a later change"
    assert cell.cfg["name"] == "comet-ours"
    # a metric that lists no workloads is every cell's: here the set-up time
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    assert callable(run.Cell("ours-infer-b8", root=tmp_path).reader("mfu.infer"))


@pytest.mark.parametrize("trace", [False, True])
def test_a_cpu_dry_run_prints_the_contract_keys_and_no_device_number(trace, capsys):
    result = _run(tiny_cell(), trace=trace)
    line = json.dumps(result)
    assert list(json.loads(line)) == CONTRACT_KEYS
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    wanted = [m["name"] for m in (run.Cell("ours-infer-b8").per_layer if trace
                                  else run.Cell("ours-infer-b8").end_to_end)]
    assert sorted(result["metrics"]) == sorted(wanted)
    assert all(m["value"] is None for m in result["metrics"].values())
    assert result["device"]["memory_peak_bytes"] is None
    assert all(set(v) == {"value", "limit"} for v in result["check"].values())


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "ours-infer-b8", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def _alter_pose(model):
    def hook(module, args, out):
        out.pred_pose_enc[0, 1:] += 0.5
    model.camera_predictor.register_forward_hook(hook)


def _alter_coarse_track(model):
    def hook(module, args, out):
        out.coord_preds[-1][0, 1, 0, 0] += 10.0
    model.coarse_tracker.register_forward_hook(hook)


def _alter_refined_track(model):
    def hook(module, args, out):
        out["pred_track"][0, 1, 0, 1] += 10.0
    model.register_forward_hook(hook)


def _alter_one_frame_pose(model):
    """One frame of one sequence: its pose is judged against the rounding
    that frame shows, so one frame counts."""
    def hook(module, args, out):
        out.pred_pose_enc[0, 1, 4] += 0.5
    model.camera_predictor.register_forward_hook(hook)


def _alter_score(model):
    """One sequence's confidence halved."""
    def hook(module, args, out):
        out["track_score"][0].mul_(0.5)
    model.register_forward_hook(hook)




def _alter_visibility(model):
    def hook(module, args, out):
        out.vis[0, 1, 0] += 0.5 if out.vis[0, 1, 0] < 0.5 else -0.5
    model.coarse_tracker.register_forward_hook(hook)


def _skip_an_update(model):
    """The coarse update transformer returns no update in its last iteration."""
    calls = []

    def hook(module, args, out):
        calls.append(1)
        if len(calls) % 2 == 0:
            return torch.zeros_like(out)
    model.coarse_tracker.updateformer.register_forward_hook(hook)


FAULTS = [_alter_pose, _alter_one_frame_pose, _alter_coarse_track, _alter_refined_track,
          _alter_score, _alter_visibility, _skip_an_update]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    """The timed path broken underneath (an answer altered where it is
    produced), with the run otherwise whole: ``correct`` comes out false."""
    from portbench import modes

    build = modes.build_inference

    def broken(*a, **k):
        model = build(*a, **k)
        fault(model)
        return model

    monkeypatch.setattr(modes, "build_inference", broken)
    result = _run(tiny_cell(), seconds=1.0)
    assert result["correct"] is False, result["check"]


def _train_cell():
    from portbench_tiny import tiny_config

    cell = run.Cell("ours-train-b4", cfg=tiny_config("comet-ours"))
    cell.mix = dict(cell.mix, batch=2, gt_uv_px=[8, 512], trace_requests=2)
    return cell


def test_a_train_dry_run_is_correct():
    result = _run(_train_cell(), seconds=1.0)
    assert list(result) == CONTRACT_KEYS and result["correct"] is True, result["check"]
    assert sorted(result["check"]) == ["change", "grad", "loss"]


def test_a_train_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    """The optimizer runs, then every parameter is put back as it was."""
    from comet_tpu_torch.training import optim

    step = optim.ClippedAdamW.step

    def unchanged(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        before = [p.detach().clone() for p in params]
        step(self, closure)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)

    monkeypatch.setattr(optim.ClippedAdamW, "step", unchanged)
    result = _run(_train_cell(), seconds=1.0)
    assert result["correct"] is False and result["check"]["change"]["value"] == 1.0


def test_a_train_step_on_half_the_batch_is_not_correct(monkeypatch):
    import comet_tpu_torch.training.loop as loop_module

    whole = loop_module.pose_loss
    monkeypatch.setattr(loop_module, "pose_loss",
                        lambda c, pred, gt: whole(c, pred[: len(pred) // 2], gt[: len(gt) // 2]))
    result = _run(_train_cell(), seconds=1.0)
    assert result["correct"] is False, result["check"]
