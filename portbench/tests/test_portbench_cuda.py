"""On the card: one short run of each cell, untraced and traced, through
the command, correct and with every metric measured; and the control of the
check failing at the cell's own size. Skipped without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench_tiny import ROOT, WORKLOADS

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _last_line(args, timeout=600):
    out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.strip().splitlines()]


@pytest.mark.parametrize("workload", sorted(WORKLOADS.values()) + ["ours-train-b4"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct_and_measured(card, workload, trace):
    """20 s: the judged requests are drawn among the window's first 8, which a
    traced window shorter than that may not reach."""
    r = _last_line(["portbench.run", "--workload", workload, "--seed", str(2**31 + 101 + trace),
                    "--seconds", "20", "--trace", str(trace)])[-1]
    assert r["correct"] is True, r["check"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert r["device"]["memory_peak_bytes"] > 0
    assert r["metrics"] and all(m["value"] is not None and m["value"] > 0
                                for m in r["metrics"].values())
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert r["breakdown"]["device_ops"]
        assert all(m["value"] < 100 for k, m in r["metrics"].items() if "roofline" in k or "mfu" in k)


def test_the_control_fails_at_the_cells_size(card):
    """The float8 control exceeds a limit on a seed where the program is
    within every limit."""
    from portbench.check import verdict

    lines = _last_line(["portbench.calibrate", "--workload", "ours-infer-b8", "--seeds", "31",
                        "--control-seeds", "31"], timeout=900)
    cfg = json.loads((ROOT / "portbench" / "configs" / "comet-ours.json").read_text())
    limits = cfg["limits"]["infer_closed"]
    side = {line["side"]: line["gaps"] for line in lines}
    assert verdict(side["program"], limits)
    assert not verdict(side["control"], limits)
