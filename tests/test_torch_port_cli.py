"""The port's CLI (``python -m comet_tpu_torch.cli``) against ``comet_tpu.cli``.

Both CLIs run on the CPU (the port's with ``--device cpu``) on fixture
datasets, with the tiny config of tests/test_torch_port_models.py at 4
frames: ``get_config`` is monkeypatched in both packages, and both
``_init_model``s give the same weights (one flax tree of random numpy
values, through ``weights.params_from_jax`` for the port), cast for
inference as each CLI casts them (in f32 a no-op). Query points come from
the "grid" backend. The weights hold the trackers' coordinate updates at 0,
so the tracks stay at the queries: with random updates the trackers
amplify the two packages' f32 rounding into pixels (the decoded
translations of one window 0.2 % apart, and 20 % in a second window that
is seeded with the first's tracks; PROFILE.md:54-69), which would hide
the CLI behind the random tracker.

Tolerances: ``eval``'s CSV row as tests/test_torch_port_eval.py holds
``evaluate()``: the continuous metrics within 1e-5 relative and 1e-4; the
fractions and AUCs, counts of thresholded errors, equal. ``demo`` runs 6
frames in two windows of 4: its trajectory within 1e-5 (+ 1e-5 relative;
2e-5 seen on translations of ~14), and its GLB and COLMAP model are read
back. ``train`` (plain and ``--windowed``) is held to the contract of
tests/test_cli_train_e2e.py, on the port alone.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

import comet_tpu.config as jcfg
import comet_tpu_torch.config as tcfg
from comet_tpu import cli as jcli
from comet_tpu.data import fixtures as jfix
from comet_tpu.models import COMET as JaxCOMET
from comet_tpu.utils import cast_params_for_inference as jax_cast
from comet_tpu_torch import cli as tcli
from comet_tpu_torch.utils.colmap_io import colmap_to_batch, read_model_text
from comet_tpu_torch.utils.scene_export import parse_glb
from comet_tpu_torch.utils.serialization import cast_params_for_inference
from comet_tpu_torch.weights import params_from_jax
from test_torch_port_eval import CONTINUOUS
from test_torch_port_models import _jax_params, _tiny
from test_torch_port_train import _one_torch_thread  # noqa: F401 (a fixture)

_CFG = dict(seqlen=4, min_track_num=4)
_GRID = ["--keypoints", "grid"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """An AMD fixture (AMD_train, AMD_eval) and a DCA fixture, and the
    tiny model's weights."""
    root = tmp_path_factory.mktemp("cli_data")
    amd = str(root / "AMD")
    kw = dict(n_models=1, n_frames=6, img_hw=(96, 128))
    jfix.generate_amd_fixture(os.path.join(amd, "AMD_train"), n_seqs=2, seed=1, **kw)
    jfix.generate_amd_fixture(os.path.join(amd, "AMD_eval"), n_seqs=2, seed=2, **kw)
    dca = jfix.generate_dca_fixture(str(root / "DCA"), n_seqs=1, n_frames=6, img_hw=(96, 96),
                                    seed=3)
    jc = _tiny(jcfg).replace(**_CFG)
    s, hw, n = jc.seqlen, jc.img_size, jc.track_num
    params = _jax_params(jc, np.zeros((1, s, hw, hw, 3), np.float32),
                         np.full((1, n, 2), hw / 2.0, np.float32), seed=41)
    return dict(amd=amd, dca=dca, params=_still_tracks(params))


def _still_tracks(params):
    """The trackers' coordinate updates held at 0 (the first two columns of
    each ``flow_head``): the tracks stay at their queries on both sides."""
    for tracker in ("coarse_tracker", "fine_tracker"):
        head = params[tracker]["updateformer"]["flow_head"]
        head["kernel"] = np.asarray(head["kernel"]).copy()
        head["bias"] = np.asarray(head["bias"]).copy()
        head["kernel"][..., :2] = 0.0
        head["bias"][:2] = 0.0
    return params


@pytest.fixture
def tiny_cli(monkeypatch, data):
    """Both CLIs on the tiny config and the shared weights."""
    jc, tc = _tiny(jcfg).replace(**_CFG), _tiny(tcfg).replace(**_CFG)
    monkeypatch.setattr(jcfg, "get_config", lambda name="ours": jc)
    monkeypatch.setattr(tcfg, "get_config", lambda name="ours": tc)
    params = {"params": data["params"]}

    def jax_init(cfg, seed=0, checkpoint=None, inference=True):
        return JaxCOMET(cfg), jax_cast(params, cfg.dtype) if inference else params

    port_init = tcli._init_model

    def init(cfg, seed=0, checkpoint=None, inference=True, device=None):
        model = port_init(cfg, seed, checkpoint, inference=False, device=device)
        if checkpoint is None:
            model.load_state_dict(params_from_jax(params, cfg))
        return cast_params_for_inference(model, cfg.dtype) if inference else model

    monkeypatch.setattr(jcli, "_init_model", jax_init)
    monkeypatch.setattr(tcli, "_init_model", init)
    return data


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_eval_matches_jax(tiny_cli, tmp_path, capsys):
    args = ["eval", "--data-root", os.path.join(tiny_cli["amd"], "AMD_eval"), *_GRID,
            "--max-sequences", "2"]
    jcli.main(args + ["--output-dir", str(tmp_path / "jax")])
    tcli.main(args + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed.count("sequences/sec:") == 2
    (want,), (got,) = (_rows(tmp_path / d / "test_results.csv") for d in ("jax", "port"))
    assert list(got) == list(want)
    for key in got:
        if key == "sec/it":
            continue
        if key in CONTINUOUS:
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-4,
                                       err_msg=key)
        else:
            assert float(got[key]) == float(want[key]), key
        assert np.isfinite(float(got[key])), key


def test_demo_windowed_matches_jax(tiny_cli, tmp_path):
    args = ["demo", "--data-root", tiny_cli["dca"], *_GRID, "--demo-seq-len", "6",
            "--max-sequences", "1"]
    jcli.main(args + ["--output-dir", str(tmp_path / "jax")])
    tcli.main(args + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    out = tmp_path / "port"
    (seq,) = [d for d in os.listdir(out) if (out / d).is_dir() and not d.endswith("_colmap")]
    trajectories = []
    for d in ("jax", "port"):
        with open(tmp_path / d / seq / "metrics" / "results.json") as f:
            trajectories.append(json.load(f))
    want, got = trajectories
    assert set(got) == {"sequence_name", "metrics", "trajectory"} and len(got["trajectory"]) == 6
    assert set(got["metrics"]) == set(want["metrics"])
    for g, w in zip(got["trajectory"], want["trajectory"]):
        for part in ("pred", "gt"):
            for key in ("R_quat", "T"):
                np.testing.assert_allclose(g[part][key], w[part][key], atol=1e-5, rtol=1e-5,
                                           err_msg=f"frame {g['frame_idx']} {part} {key}")
    assert np.isfinite(got["metrics"]["R_avg"])

    base = out / f"{seq}_scene"
    gltf, blob = parse_glb(str(base) + ".glb")
    assert gltf["meshes"][0]["name"] == "points" and len(gltf["meshes"]) == 1 + 6
    assert len(blob) > 0 and os.path.getsize(str(base) + ".html") > 1000
    model = read_model_text(str(base) + "_colmap")
    assert len(model.images) == 6 and len(model.cameras) == 1
    _, ext, _, _ = colmap_to_batch(model)
    assert ext.shape == (6, 3, 4) and np.isfinite(ext).all()
    for im in model.images.values():
        assert all(int(pid) in model.points3d for pid in im.point3d_ids)


def _train(root, out, *extra):
    tcli.main(["train", "--data-root", root, "--output-dir", out, *_GRID, "--ckpt-interval", "1",
               "--eval-interval", "1", "--max-sequences", "1", "--device", "cpu", *extra])


def test_train_checkpoints_resume_and_eval(tiny_cli, tmp_path):
    out = str(tmp_path / "out")
    _train(tiny_cli["amd"], out, "--epochs", "1")
    ckpt = os.path.join(out, "ckpt")
    assert "ckpt_000000" in os.listdir(ckpt)
    assert os.path.exists(os.path.join(ckpt, "best.pt"))
    with open(os.path.join(ckpt, "best.json")) as f:
        assert json.load(f)["key"] == "Auc_30"
    rows = _rows(os.path.join(out, "train_results.csv"))
    assert len(rows) == 1 and float(rows[0]["loss"]) > 0 and "tf_ratio" in rows[0]
    assert os.path.exists(os.path.join(out, "dashboard.html"))

    _train(tiny_cli["amd"], out, "--epochs", "2")  # auto-resume: exactly one more epoch
    rows = _rows(os.path.join(out, "train_results.csv"))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert sorted(d for d in os.listdir(ckpt) if d.startswith("ckpt_")) == [
        "ckpt_000000", "ckpt_000001"]
    assert os.path.exists(os.path.join(out, "train_results.png"))

    tcli.main(["eval", "--data-root", os.path.join(tiny_cli["amd"], "AMD_eval"), *_GRID,
               "--output-dir", str(tmp_path / "eval"), "--max-sequences", "1", "--device", "cpu",
               "--checkpoint", os.path.join(ckpt, "best.pt")])
    (row,) = _rows(tmp_path / "eval" / "test_results.csv")
    assert np.isfinite(float(row["Auc_30"]))


def test_windowed_train_logs_tf_ratio(tiny_cli, tmp_path):
    out = str(tmp_path / "win")
    _train(tiny_cli["amd"], out, "--epochs", "2", "--windowed", "--train-seq-len", "6",
           "--tf-start", "1.0", "--tf-end", "0.2", "--tf-epochs", "2")
    rows = _rows(os.path.join(out, "train_results.csv"))
    assert len(rows) == 2 and float(rows[0]["loss"]) > 0
    assert float(rows[0]["tf_ratio"]) == 1.0
    assert abs(float(rows[1]["tf_ratio"]) - 0.6) < 1e-6
    assert os.path.exists(os.path.join(out, "ckpt", "best.pt"))
    assert os.path.exists(os.path.join(out, "ckpt", "best.json"))


def test_bench_prints_json(tiny_cli, capsys):
    tcli.main(["bench", "--suite", "infer", "--device", "cpu"])
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    result = json.loads(line)
    assert result["unit"] == "seq/s" and result["value"] > 0 and result["device"] == "cpu"


@pytest.mark.parametrize("argv", [
    ["eval", "--loader", "native"],
    ["eval", "--keypoints", "superpoint"],
    ["match", "--list"],
], ids=["native loader", "superpoint", "match"])
def test_what_is_not_ported_raises(argv):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tcli.main(argv + (["--device", "cpu"] if argv[0] in ("eval", "train") else []))


def test_without_a_card_the_cli_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["bench", "--suite", "infer", "--output-dir", str(tmp_path)])
