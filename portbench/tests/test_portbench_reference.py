"""The plain reference against the port, on the CPU at a tiny size, float32
on both sides, for both configurations; and the control's failure there."""

from __future__ import annotations

import pytest
import torch

from portbench import check
from portbench.program import build_inference, make_state, parameter_shapes
from portbench.reference import comet as ref

from portbench_tiny import MIX, tiny_config


def _port_outputs(cfg, seed, dtype=torch.float32):
    torch.manual_seed(0)
    state = make_state(parameter_shapes(cfg), seed, "cpu", dtype)
    model = build_inference(cfg, state, "cpu")
    capture = check.Capture(model)
    gen = torch.Generator().manual_seed(seed + 1)
    images = torch.randn((MIX["batch"], cfg["seqlen"], cfg["img_size"], cfg["img_size"], 3),
                         generator=gen)
    queries = torch.rand((MIX["batch"], cfg["track_num"], 2), generator=gen) * 32 + 16
    capture.start()
    with torch.inference_mode():
        out = dict(model(images, queries))
    out.update(capture.stop(MIX["batch"], cfg["seqlen"], cfg["track_num"]))
    return state, images, queries, out


@pytest.mark.parametrize("name", ["comet-ours", "comet-abl_all"])
def test_reference_forward_matches_the_port(name):
    """The reference's whole forward, stage after stage from its own outputs,
    equals the port's f32 forward on the same state dict and inputs."""
    cfg = tiny_config(name)
    state, images, queries, out = _port_outputs(cfg, seed=3)
    params = check.reference_params(state, "cpu")
    with torch.no_grad():
        want = ref.forward(ref.Plain(params), cfg, images, queries)
    # end to end, the iterating trackers amplify f32 rounding (the two sides
    # reduce in other orders): tracks within 0.05 px, the rest within 1e-3
    for key, atol in (("coarse_track", 0.05), ("pred_track", 0.05), ("track_vis", 1e-3),
                      ("track_score", 1e-3), ("pred_pose_enc", 1e-3)):
        torch.testing.assert_close(want[key], out[key], atol=atol, rtol=0, msg=key)


@pytest.mark.parametrize("name", ["comet-ours", "comet-abl_all"])
def test_judge_reads_the_f32_port_as_exact(name):
    """Every number of the teacher-forced judge is at f32 rounding for the
    port in f32, and within the configuration's limits."""
    cfg = tiny_config(name)
    state, images, queries, out = _port_outputs(cfg, seed=4)
    gaps = check.judge(check.reference_params(state, "cpu"), cfg, images, queries, out)
    assert set(gaps) == set(check.NUMBERS)
    assert max(gaps.values()) < 1e-3, gaps
    assert check.verdict(gaps, cfg["limits"]["infer_closed"])


def test_control_fails_where_the_bf16_port_passes():
    """At the tiny size: the float8 control's widest gaps exceed, in at least
    one number on every seed, twice the largest the bf16 port reads over the
    same seeds (the limits' rule at this size), and the port never does."""
    cfg = tiny_config("comet-ours", "bfloat16")
    program, control = [], []
    for seed in (5, 6, 7):
        state, images, queries, out = _port_outputs(cfg, seed, torch.bfloat16)
        params = check.reference_params(state, "cpu")
        program.append(check.judge(params, cfg, images, queries, out))
        ctl = check.control_outputs(params, cfg, images, queries)
        control.append(check.judge(params, cfg, images, queries, ctl))
    limits = {k: 2.0 * max(p[k] for p in program) for k in check.NUMBERS}
    assert all(check.verdict(p, limits) for p in program)
    assert not any(check.verdict(c, limits) for c in control), (control, limits)
