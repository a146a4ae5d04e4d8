"""The port's serving path on the CPU: the kernels as ``comet::`` operators
(``ops/library.py``), the exported forward and windowed chain
(``utils/serving.py``), the CLI's ``export`` and ``utils/profiling.py``.

- **Operators.** Each passes ``torch.library.opcheck`` (schema, autograd
  registration, fake implementation, AOT dispatch); its CPU implementation
  is its plain version; its fake implementation gives the real result's
  shape and dtype; its registered backward equals the plain version's
  autograd bit for bit.
- **Forward.** The model of tests/test_torch_port_models.py's ``tiny``
  fixture (the JAX weights through ``params_from_jax``) is exported once;
  the artifact, its weights restored by name from a ``.pt`` file, equals
  the port's eager forward bit for bit (the eager model's parameters
  frozen, as a server holds them: with ``requires_grad`` parameters
  ``aten.matmul`` reduces a one-column Linear, the visibility head, in
  another order, 1 ulp away), and ``comet_tpu``'s ``model.apply`` within
  test_forward_matches_jax's tolerances (2e-2 px on tracks, 5e-3 on scores
  and poses); a saved and loaded artifact equals the one in memory, also in
  a fresh process that never imports ``comet_tpu_torch.models``.
- **Windowed chain.** At T = 2 * seqlen - 1 (two windows) on ``FUSED_ROUTE``
  with 128 tracks (over K2's, K3's and K4's gates) and one block per
  tracker, the artifact equals ``windowed_forward_scan`` bit for bit; its
  graph holds K1, K3, K4 and K5 as operator nodes, the CLI's (default
  route) K1 and K2.

In one process the file takes about two minutes, most of it in
``torch.export``'s traces.
"""

import json
import os
import re
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import comet_tpu_torch.config as tcfg
from comet_tpu_torch import cli as tcli
from comet_tpu_torch.models import build_comet
from comet_tpu_torch.models.windowed import windowed_forward_scan
from comet_tpu_torch.ops import kernels, library
from comet_tpu_torch.utils import profiling, serving
from comet_tpu_torch.utils.serialization import save_params
from comet_tpu_torch.weights import params_from_jax
from test_torch_port_models import _CAMERA, _TRACKER, _close, _t, _tiny, tiny  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ operators


def _op_cases():
    """(id, operator, arguments), small shapes from one numpy generator;
    every tensor requires a gradient."""
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).requires_grad_()

    c, hid = 32, 64
    block_w = [t(c, c, scale=0.2), t(c, scale=0.1), t(hid, c, scale=0.2), t(hid, scale=0.1),
               t(c, hid, scale=0.1), t(c, scale=0.1)]
    qkv = [t(2, 9, 64), t(2, 13, 64), t(2, 13, 64)]
    return [
        ("K1", "attention", (*qkv, 4, 0.25, "base")),
        ("K1 nomax", "attention", (*qkv, 4, 0.25, "nomax")),
        ("K1 bf16e", "attention", (*qkv, 4, 0.25, "bf16e")),
        ("K3", "short_attention", (t(16, 8, 64), t(16, 8, 64), t(16, 8, 64), 4, 0.25)),
        ("K2", "attn_block", (t(4, 8, c), t(3 * c, c, scale=0.2), t(3 * c, scale=0.1), *block_w, 2)),
        ("K4", "cross_block", (t(2, 16, c), t(2, 8, c), 1 + t(c, scale=0.1), t(c, scale=0.1),
                               t(c, c, scale=0.2), t(c, scale=0.1), t(2 * c, c, scale=0.2),
                               t(2 * c, scale=0.1), *block_w, 2)),
        ("K5", "layer_norm", (t(6, c), 1 + t(c, scale=0.1), t(c, scale=0.1), 1e-6)),
        ("K5 no affine", "layer_norm", (t(6, c), None, None, 1e-6)),
    ]


_OPS = _op_cases()
_IDS = [case[0] for case in _OPS]


def _op(name):
    return getattr(torch.ops.comet, name).default


def _detached(args):
    return tuple(a.detach() if isinstance(a, torch.Tensor) else a for a in args)


@pytest.mark.parametrize("case", _OPS, ids=_IDS)
def test_operator_passes_opcheck(case):
    _, name, args = case
    torch.library.opcheck(_op(name), args)


@pytest.mark.parametrize("case", _OPS, ids=_IDS)
def test_operator_cpu_implementation_is_the_plain_version(case):
    _, name, args = case
    args = _detached(args)
    assert torch.equal(_op(name)(*args), library.PLAIN[name](*args))


@pytest.mark.parametrize("case", _OPS, ids=_IDS)
def test_operator_fake_implementation_gives_the_real_shape(case):
    _, name, args = case
    args = _detached(args)
    real = _op(name)(*args)
    with FakeTensorMode() as mode:
        fake = _op(name)(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                           for a in args))
    assert fake.shape == real.shape and fake.dtype == real.dtype and fake.is_contiguous()


@pytest.mark.parametrize("case", _OPS, ids=_IDS)
def test_operator_backward_is_the_plain_versions_autograd(case):
    _, name, args = case
    leaves = [a for a in args if isinstance(a, torch.Tensor)]
    out = _op(name)(*args)
    assert type(out.grad_fn).__name__.startswith(f"GeneratedBackwardFor_comet_{name}")
    cot = torch.from_numpy(np.random.default_rng(1).normal(size=out.shape).astype(np.float32))
    got = torch.autograd.grad(out, leaves, cot)
    want = torch.autograd.grad(library.PLAIN[name](*args), leaves, cot)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# -------------------------------------------------------------- forward


@pytest.fixture(scope="module")
def served(tiny, tmp_path_factory):  # noqa: F811 (a fixture)
    """The tiny model exported, saved, its weights written to a .pt file and
    restored into the artifact, and one request served."""
    tc = tiny["tc"]
    model = build_comet(tc, device="cpu")
    model.load_state_dict(params_from_jax({"params": tiny["params"]}, tc))
    model.requires_grad_(False)
    exported = serving.export_forward(model, tc, device="cpu")
    root = tmp_path_factory.mktemp("serving")
    path = str(root / "comet_tiny_forward.pt2")
    manifest = serving.save_exported(exported, path, cfg=tc, extra_manifest={"preset": "tiny"})
    weights = save_params(str(root / "weights.pt"), model)
    params = serving.params_from_file(weights, exported)
    images, queries = _t(tiny["images"]), _t(tiny["queries"])
    out = serving.serving_call(exported)(params, images, queries)
    with torch.no_grad():
        eager = model(images, queries)
    return dict(tc=tc, model=model, exported=exported, path=path, manifest=manifest,
                weights=weights, params=params, images=images, queries=queries, out=out,
                eager=eager, root=root, loaded=serving.load_exported(path))


def test_served_forward_equals_the_eager_forward(served):
    out, eager = served["out"], served["eager"]
    assert set(out) == set(eager)
    for key in eager:
        assert torch.equal(out[key], eager[key]), key


def test_served_forward_matches_jax(served, tiny):  # noqa: F811 (a fixture)
    got, want = served["out"], tiny["out"]
    assert set(got) == set(want)
    _close(got["coarse_track"], want["coarse_track"], 2e-2, 2e-2)
    _close(got["pred_track"], want["pred_track"], 2e-2, 2e-2)
    _close(got["track_vis"], want["track_vis"], 5e-3, 5e-3)
    _close(got["track_score"], want["track_score"], 5e-3, 5e-3)
    _close(got["pred_pose_enc"], want["pred_pose_enc"], 5e-3, 5e-3)
    # the served invariants: frame 0 is the query and the identity pose
    _close(got["pred_track"][:, 0], tiny["queries"], 1e-6)
    _close(got["pred_pose_enc"][:, 0], [[0, 0, 0, 1, 0, 0, 0]], 0)


def test_saved_artifact_round_trips(served):
    out = serving.serving_call(served["loaded"])(served["params"], served["images"], served["queries"])
    for key, value in served["out"].items():
        assert torch.equal(out[key], value), key


def test_manifest(served):
    manifest, path, tc = served["manifest"], served["path"], served["tc"]
    with open(path + ".json") as f:
        assert json.load(f) == manifest
    assert manifest["format"] == "torch.export" and manifest["strict"] is False
    assert manifest["artifact_bytes"] == os.path.getsize(path)
    assert manifest["torch_version"] == torch.__version__
    assert manifest["cuda_version"] == torch.version.cuda
    assert manifest["device"] == "cpu" and manifest["preset"] == "tiny"
    assert manifest["kernels_digest"] == kernels._digest()
    assert manifest["n_params"] == sum(p.numel() for p in served["model"].parameters())
    assert manifest["n_inputs"] == len(served["params"]) + 2 and manifest["n_outputs"] == 5
    assert manifest["model"] == {"seqlen": tc.seqlen, "img_size": tc.img_size,
                                 "track_num": tc.track_num, "compute_dtype": tc.compute_dtype}


def test_artifact_holds_no_weights(served):
    """The weights are an input: the saved program has no parameter, no
    example input and only the forward's three small constants
    (``camera_predictor.py``'s ``new_tensor``s), and its graph calls K1 as
    an operator node."""
    loaded = served["loaded"]
    assert not loaded.state_dict and loaded.example_inputs is None
    assert sorted(t.numel() for t in loaded.constants.values()) == [3, 3, 7]
    assert "comet.attention.default" in _kernel_ops(loaded)


def test_params_from_file_restores_by_name(served):
    state = served["model"].state_dict()
    path = str(served["root"] / "shuffled.pt")
    torch.save(dict(reversed(list(state.items()))), path)
    params = serving.params_from_file(path, served["exported"])
    assert list(params) == list(served["params"])
    assert all(torch.equal(params[k], state[k]) for k in state)


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape", "dtype", "msgpack"])
def test_params_from_file_raises_on_a_mismatch(served, fault):
    state = dict(served["model"].state_dict())
    key = "camera_predictor.pose_token"
    error, match = ValueError, key
    if fault == "missing":
        del state[key]
        error = KeyError
    elif fault == "unexpected":
        state["camera_predictor.extra"] = torch.zeros(1)
        error, match = KeyError, "camera_predictor.extra"
    elif fault == "shape":
        state[key] = torch.zeros(3)
    elif fault == "dtype":
        state[key] = state[key].to(torch.complex64)
        error = TypeError
    else:
        match = "params_from_msgpack"
    path = str(served["root"] / ("bad.msgpack" if fault == "msgpack" else f"bad_{fault}.pt"))
    torch.save(state, path)
    with pytest.raises(error, match=match):
        serving.params_from_file(path, served["exported"])


def test_params_from_msgpack_fills_the_artifact(served, tiny):  # noqa: F811 (a fixture)
    """The JAX package's weight file of the same weights, read without JAX,
    fills the artifact's input exactly as the port's .pt file does, and
    serves the same outputs; a tree of another model raises."""
    from comet_tpu.utils.serialization import save_params_msgpack

    path = str(served["root"] / "weights.msgpack")
    save_params_msgpack(path, {"params": tiny["params"]})
    params = serving.params_from_msgpack(path, served["exported"])
    assert list(params) == list(served["params"])
    for k, v in served["params"].items():
        assert params[k].dtype == v.dtype and torch.equal(params[k], v), k
    out = serving.serving_call(served["exported"])(params, served["images"], served["queries"])
    for key, value in served["out"].items():
        assert torch.equal(out[key], value), key
    bad = str(served["root"] / "other.msgpack")
    save_params_msgpack(bad, {"params": {**tiny["params"], "extra": {"bias": np.zeros(2)}}})
    with pytest.raises(KeyError, match="extra.bias"):
        serving.params_from_msgpack(bad, served["exported"])


@pytest.mark.parametrize("fault", ["digest", "no manifest"])
def test_load_exported_refuses_another_kernel_library(served, tmp_path, fault):
    """An artifact whose manifest names other kernel sources than this
    checkout's raises, naming both digests; one without a manifest raises;
    the unedited artifact still loads."""
    import shutil

    path = str(tmp_path / "copy.pt2")
    shutil.copy(served["path"], path)
    if fault == "digest":
        manifest = dict(served["manifest"], kernels_digest="0123456789abcdef")
        with open(path + ".json", "w") as f:
            json.dump(manifest, f)
        with pytest.raises(RuntimeError, match=f"0123456789abcdef.*{kernels._digest()}"):
            serving.load_exported(path)
    else:
        with pytest.raises(FileNotFoundError, match="no manifest"):
            serving.load_exported(path)
    assert serving.load_exported(served["path"]) is not None


def test_a_fresh_process_serves_the_artifact_without_the_model(served):
    root = served["root"]
    inputs, outputs = str(root / "inputs.pt"), str(root / "fresh_out.pt")
    torch.save((served["images"], served["queries"]), inputs)
    code = (
        "import json, sys, torch\n"
        "from comet_tpu_torch.utils import serving\n"
        f"exported = serving.load_exported({served['path']!r})\n"
        f"params = serving.params_from_file({served['weights']!r}, exported)\n"
        f"out = serving.serving_call(exported)(params, *torch.load({inputs!r}))\n"
        f"torch.save(out, {outputs!r})\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.startswith('comet_tpu'))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": REPO}, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    modules = json.loads(proc.stdout.splitlines()[-1])
    assert "comet_tpu_torch.ops.library" in modules
    assert not [m for m in modules if m.startswith(("comet_tpu_torch.models", "comet_tpu."))]
    out = torch.load(outputs)
    for key, value in served["out"].items():
        assert torch.equal(out[key], value), key


def test_an_artifact_for_cuda_needs_a_card(served, monkeypatch):
    monkeypatch.setattr(serving, "artifact_device", lambda exported: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.serving_call(served["exported"])


def test_export_windowed_refuses_less_than_a_window(served):
    with pytest.raises(ValueError, match="seqlen"):
        serving.export_windowed(served["model"], served["tc"], served["tc"].seqlen - 1)


# ------------------------------------------------------------- windowed


def _wide():
    """The tiny config with 128 tracks (2 frames x 128 tracks: over K2's,
    K3's and K4's row gates) and one block and iteration per tracker and
    ViT, which halves the traces."""
    one = dict(coarse_depth=1, coarse_iters=1, fine_depth=1, fine_iters=1)
    return _tiny(tcfg, backbone_depth=1).replace(
        track_num=128, tracker=tcfg.TrackerConfig(**{**_TRACKER, **one}))


def _inputs(cfg, frames, seed):
    rng = np.random.default_rng(seed)
    hw = cfg.img_size
    images = rng.normal(size=(1, frames, hw, hw, 3)).astype(np.float32)
    queries = (rng.random((1, cfg.track_num, 2)) * (hw - 20) + 10).astype(np.float32)
    return _t(images), _t(queries)


def _kernel_ops(exported):
    return {str(n.target) for gm in exported.graph_module.modules()
            if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes
            if str(n.target).startswith("comet.")}


def test_served_windowed_chain_equals_the_scan_form():
    cfg = _wide()
    model = build_comet(cfg, device="cpu", seed=2, route=tcfg.FUSED_ROUTE).requires_grad_(False)
    frames = 2 * cfg.seqlen - 1
    exported = serving.export_windowed(model, cfg, frames, device="cpu")
    assert _kernel_ops(exported) == {"comet.attention.default", "comet.short_attention.default",
                                     "comet.cross_block.default", "comet.layer_norm.default"}
    images, queries = _inputs(cfg, frames, seed=3)
    ratio = torch.tensor(0.9)
    with torch.no_grad():
        want = windowed_forward_scan(model, images, queries, cfg.seqlen, ratio)
    got = serving.serving_call(exported)(model.state_dict(), images, queries, ratio)
    assert len(got) == 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].shape == (1, frames, 7) and got[1].shape == (1, frames, cfg.track_num, 2)


# ------------------------------------------------------------------ CLI


@pytest.fixture
def wide_cli(monkeypatch):
    cfg = _wide()
    monkeypatch.setattr(tcfg, "get_config", lambda name="ours": cfg)
    return cfg


def _cli_export(argv, capsys):
    tcli.main(["export", *argv])
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    printed = json.loads(line)
    path = printed.pop("artifact")
    with open(path + ".json") as f:
        assert json.load(f) == printed
    assert printed["artifact_bytes"] == os.path.getsize(path)
    return path, printed


def _kernel_ops_in_file(path):
    """The operator nodes of a saved artifact, read from its serialized
    graph without loading it."""
    with zipfile.ZipFile(path) as z:
        (graph,) = [n for n in z.namelist() if n.endswith("models/model.json")]
        text = z.read(graph).decode()
    return set(re.findall(r'"torch\.ops\.(comet\.\w+\.default)"', text))


def test_cli_exports_the_forward(wide_cli, tmp_path, capsys):
    path, manifest = _cli_export(["--device", "cpu", "--output-dir", str(tmp_path)], capsys)
    assert path == str(tmp_path / "comet_ours_forward.pt2")
    assert manifest["preset"] == "ours" and manifest["device"] == "cpu"
    assert manifest["batch"] == 1 and manifest["model"]["track_num"] == 128
    assert manifest["n_params"] == sum(p.numel() for p in build_comet(wide_cli, "meta").parameters())
    assert _kernel_ops_in_file(path) == {"comet.attention.default", "comet.attn_block.default"}


def test_cli_exports_the_windowed_chain(wide_cli, tmp_path, capsys):
    frames = wide_cli.seqlen
    path, manifest = _cli_export(["--platforms", "cpu", "--seq-frames", str(frames),
                                  "--output-dir", str(tmp_path)], capsys)
    assert path == str(tmp_path / f"comet_ours_windowed{frames}.pt2")
    assert manifest["total_frames"] == frames and manifest["device"] == "cpu"
    n_tensors = len(build_comet(wide_cli, "meta").state_dict())
    assert manifest["n_inputs"] == n_tensors + 3 and manifest["n_outputs"] == 2
    assert _kernel_ops_in_file(path) == {"comet.attention.default", "comet.attn_block.default"}


@pytest.mark.parametrize("platforms", ["tpu", "tpu,cpu"])
def test_cli_export_refuses_other_platforms(platforms, tmp_path):
    with pytest.raises(ValueError, match="platforms"):
        tcli.main(["export", "--platforms", platforms, "--output-dir", str(tmp_path)])


def test_cli_export_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["export", "--output-dir", str(tmp_path)])


# ------------------------------------------------------------ profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_benchmark_fn_reports_sane_timing():
    stats = profiling.benchmark_fn(lambda a: a @ a, torch.ones(64, 64), reps=4)
    assert set(stats) == {"ms_per_call", "calls_per_sec", "host_rtt_ms", "reps"}
    assert stats["ms_per_call"] >= 0.0 and stats["calls_per_sec"] > 0.0
    assert stats["host_rtt_ms"] > 0.0 and stats["reps"] == 4


def test_measure_host_rtt_positive():
    assert profiling.measure_host_rtt(reps=2, device="cpu") > 0.0


def test_log_memory_status(capsys):
    out = profiling.log_memory_status("mem", device="cpu")
    assert set(out) == {"host_rss_gb"} and out["host_rss_gb"] > 0
    assert capsys.readouterr().out.startswith("mem")


def test_profiling_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.measure_host_rtt()
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.benchmark_fn(lambda: None)
