"""The port's eval and bench entry points against the JAX package.

Codecs, ``encode_gt`` and ``pose_loss``, the float64 metrics and the metric
block, the datasets and fixtures, keypoint seeding, the preprocessing on a
device, the eval step, ``evaluate()`` and the benchmarks' keys, on the CPU:
both packages get the same numpy inputs, the same fixture files and the same
weights (``params_from_jax``).

Tolerances: 1e-5 for the codecs, ``encode_gt`` and ``pose_loss`` (a few f32
operations); 1e-12 for the float64 metrics and the metric block on identical
inputs (the same numpy code, so equal up to the last bit or two); exact
equality for dataset samples, fixture files and seeded query points (the
same numpy and PIL operations); 1e-5 for the preprocessing (two f32
sampling products, then a division by std ~0.22); for the eval step the
whole-forward tolerances of tests/test_torch_port_models.py (2e-2 px on
tracks, 5e-3 on scores and poses); for ``evaluate()`` the continuous metric
keys within 1e-5 relative + 1e-4 absolute (degrees; the forward's f32
reassociation reaches these averages at about 2e-6 relative, at most 1e-5
degrees here). The threshold keys (acc@5deg, Racc/Tacc, AUC) jump at a
threshold, so they are held exactly by the metric block test.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comet_tpu.config as jcfg
import comet_tpu_torch.config as tcfg
from comet_tpu.data import datasets as jds
from comet_tpu.data import device_pipeline as jdp
from comet_tpu.data import fixtures as jfix
from comet_tpu.data import keypoints as jkp
from comet_tpu.geometry import cameras as jcam
from comet_tpu.geometry import codecs as jcodecs
from comet_tpu.geometry import quaternions as jquat
from comet_tpu.metrics import pose_metrics as jpm
from comet_tpu.models import COMET as JaxCOMET
from comet_tpu.models import comet as jcomet
from comet_tpu.training import loop as jloop
from comet_tpu_torch import bench_lib, entry
from comet_tpu_torch.data import datasets as tds
from comet_tpu_torch.data import device_pipeline as tdp
from comet_tpu_torch.data import fixtures as tfix
from comet_tpu_torch.data import keypoints as tkp
from comet_tpu_torch.data.prefetch import prefetch
from comet_tpu_torch.geometry import cameras as tcam
from comet_tpu_torch.geometry import codecs as tcodecs
from comet_tpu_torch.geometry import quaternions as tquat
from comet_tpu_torch.metrics import pose_metrics as tpm
from comet_tpu_torch.models import build_comet
from comet_tpu_torch.models import comet as tcomet
from comet_tpu_torch.training import data_parallel as tdpar
from comet_tpu_torch.training import loop as tloop
from comet_tpu_torch.training.stats import RunningStats
from comet_tpu_torch.weights import params_from_jax
from test_torch_port_models import _cameras, _close, _jax_params, _t, _tiny

REPO = Path(__file__).resolve().parent.parent
# the eval tests' tiny model: the parity tests' widths, 4 frames
_EVAL = dict(seqlen=4, min_track_num=4)
# continuous metric keys (the rest jump at thresholds)
CONTINUOUS = ("loss", "loss_trans", "loss_rot", "R_avg", "T_avg", "Tx_mse", "Ty_mse", "Tz_mse",
              "X_err", "Y_err", "Z_err")


def _jcams(c):
    return jcam.make_camera_set(**c)


def _tcams(c):
    return tcam.make_camera_set(**c)


# ------------------------------------------------------------ codecs


@pytest.mark.parametrize("s", [1, 5])
def test_encoders_match_jax(s):
    cams = _cameras(21, s=s)
    cams["focal"] = np.random.default_rng(22).uniform(0.05, 40, size=(s, 2)).astype(np.float32)
    _close(tcodecs.encode_relative_uvz(_tcams(cams)),
           jcodecs.encode_relative_uvz(_jcams(cams)), 1e-5)
    _close(tcodecs.encode_relative_xyz(_tcams(cams)),
           jcodecs.encode_relative_xyz(_jcams(cams)), 1e-5)
    q = cams["q"]
    _close(tquat.quat_invert(_t(q)), jquat.quat_invert(jnp.asarray(q)), 0)


@pytest.mark.parametrize("use_gapr", [True, False])
def test_encode_gt_and_pose_loss_match_jax(use_gapr):
    jc, tc = _tiny(jcfg, use_gapr=use_gapr), _tiny(tcfg, use_gapr=use_gapr)
    one = _cameras(23, s=4)
    _close(tcomet.encode_gt(tc, _tcams(one)), jcomet.encode_gt(jc, _jcams(one)), 1e-5)
    batch = [_cameras(24 + i, s=4) for i in range(3)]
    jb = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[_jcams(c) for c in batch])
    tb = tdpar.stack_camera_sets([jcam.CameraSet(**{k: np.asarray(v) for k, v in
                                                   _jcams(c)._asdict().items()})
                                  for c in batch])
    gt_j, gt_t = jcomet.encode_gt(jc, jb), tcomet.encode_gt(tc, tb)
    _close(gt_t, gt_j, 1e-5)
    pred = np.random.default_rng(25).normal(size=(3, 4, 7)).astype(np.float32)
    want = jcomet.pose_loss(jc, jnp.asarray(pred), gt_j)
    got = tcomet.pose_loss(tc, _t(pred), gt_t)
    assert set(got) == set(want) == {"loss", "loss_trans", "loss_rot"}
    for key in want:
        _close(got[key], want[key], 1e-5, 1e-6)
    # the dtype follows pred's promotion with the gt encoding, as in JAX
    assert tcomet.pose_loss(tc, _t(pred).bfloat16(), gt_t)["loss"].dtype == torch.float32


# ----------------------------------------------------------- metrics


def _metric_inputs(seed, s=6):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, s, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q, rng.normal(size=(2, s, 3)), rng.normal(size=(2, s, 7))


def test_pose_metrics_match_jax():
    (pq, gq), (pt, gt), (pe, ge) = _metric_inputs(31)
    for name in ("pairwise_se3_errors",):
        want, got = getattr(jpm, name)(pq, pt, gq, gt), getattr(tpm, name)(pq, pt, gq, gt)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-12, atol=1e-12)
    want, got = jpm.relative_frame_errors(pe, ge), tpm.relative_frame_errors(pe, ge)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12, atol=1e-12)
    r = np.random.default_rng(32).uniform(0, 40, size=50)
    t = np.random.default_rng(33).uniform(0, 40, size=50)
    auc_j, hist_j = jpm.auc_histogram(r, t, 30)
    auc_t, hist_t = tpm.auc_histogram(r, t, 30)
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-12, atol=1e-12)
    assert abs(auc_t - auc_j) <= 1e-12
    for th in (30, 10, 5, 3):
        assert abs(tpm.auc_from_histogram_prefix(hist_t, th)
                   - jpm.auc_from_histogram_prefix(hist_j, th)) <= 1e-12
    m = tpm.quat_to_matrix_np(pq)
    np.testing.assert_allclose(tpm.matrix_to_quat_np(m), jpm.matrix_to_quat_np(m), atol=1e-12)
    np.testing.assert_allclose(tpm.euler_xyz_from_matrix_np(m), jpm.euler_xyz_from_matrix_np(m),
                               atol=1e-12)


def _step_out(seed, s=6):
    """A step's metric keys for one sequence, and its gt cameras."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(s, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    out = dict(
        pred_q=q[None], pred_t=rng.normal(size=(1, s, 3)).astype(np.float32),
        pred_pose_enc=rng.normal(size=(1, s, 7)).astype(np.float32),
        gt_pose_enc=rng.normal(size=(s, 8)).astype(np.float32),
        loss=np.float32(1.5), loss_trans=np.float32(0.25), loss_rot=np.float32(0.625),
    )
    gq = rng.normal(size=(s, 4)).astype(np.float32)
    gq /= np.linalg.norm(gq, axis=-1, keepdims=True)
    cams = dict(q=gq, t_xyz=rng.normal(size=(s, 3)).astype(np.float32),
                t_uvz=np.zeros((s, 3), np.float32), focal=np.ones((s, 2), np.float32),
                pp=np.zeros((s, 2), np.float32), ratio=np.float32(1.0))
    return out, cams


@pytest.mark.parametrize("seed", [41, 42, 43])
def test_metric_block_matches_jax(seed):
    out, cams = _step_out(seed)
    want = jloop.metric_block(out, jcam.CameraSet(**cams), "model1/seq_1")
    got = tloop.metric_block(out, tcam.CameraSet(**cams), "model1/seq_1")
    assert list(got) == list(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-12 * max(1.0, abs(want[key])), key
    # tensors (the step's own outputs, bf16 among them) read the same
    tensors = {k: torch.as_tensor(v) for k, v in out.items()}
    tensors["pred_pose_enc"] = tensors["pred_pose_enc"].bfloat16()
    out_bf = dict(out, pred_pose_enc=tensors["pred_pose_enc"].float().numpy())
    assert tloop.metric_block(tensors, tcam.CameraSet(**cams)) == jloop.metric_block(
        out_bf, jcam.CameraSet(**cams))


def test_metric_fetch_keys_and_batch_metrics():
    assert tloop.METRIC_FETCH_KEYS == jloop.METRIC_FETCH_KEYS
    rows = [_step_out(50 + i) for i in range(2)]
    batched = {k: np.stack([r[0][k][0] if r[0][k].ndim == 3 else r[0][k] for r in rows])
               for k in ("pred_q", "pred_t", "pred_pose_enc", "gt_pose_enc")}
    # a batch's losses are scalars over the batch
    batched.update(loss=np.float32(2.0), loss_trans=np.float32(0.5), loss_rot=np.float32(0.75),
                   pred_track=np.zeros((2, 6, 3, 2), np.float32))
    fetch = tdpar.start_metric_fetch({k: torch.as_tensor(v) for k, v in batched.items()})
    assert set(fetch.host) == set(tloop.METRIC_FETCH_KEYS) and fetch.ready is None
    got = tdpar.batch_metrics(fetch, [tcam.CameraSet(**r[1]) for r in rows], ["a", "b"])
    for (out, cams), row, name in zip(rows, got, "ab"):
        out = dict(out, loss=batched["loss"], loss_trans=batched["loss_trans"],
                   loss_rot=batched["loss_rot"])
        assert row == jloop.metric_block(out, jcam.CameraSet(**cams), name)


def test_running_stats():
    stats = RunningStats()
    stats.update({"a": 1.0, "b": 2.0, "name": "x"})
    stats.update({"a": 3.0})
    avg = stats.averages()
    assert avg["a"] == 2.0 and avg["b"] == 2.0 and "name" not in avg and avg["sec/it"] >= 0
    assert stats.status_string(3, 10) == "[eval] it 3/10 | "
    stats.update({"loss": 1.0})
    assert stats.status_string(3, 10).endswith("loss: 1.0000")


# -------------------------------------------------------------- data


@pytest.fixture(scope="module")
def amd_root(tmp_path_factory):
    """A JAX-written AMD fixture: 3 sequences of 6 frames at 96 x 128."""
    root = tmp_path_factory.mktemp("amd")
    return jfix.generate_amd_fixture(str(root), n_seqs=3, n_frames=6, img_hw=(96, 128), seed=3)


def _files(root):
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("kind", ["amd", "dca"])
def test_fixtures_write_the_same_files(tmp_path, kind):
    if kind == "amd":
        kw = dict(n_models=2, n_seqs=2, n_frames=3, img_hw=(48, 64), seed=5)
        jfix.generate_amd_fixture(str(tmp_path / "j"), **kw)
        tfix.generate_amd_fixture(str(tmp_path / "t"), **kw)
    else:
        kw = dict(n_seqs=2, n_frames=3, img_hw=(64, 64), seed=6)
        jfix.generate_dca_fixture(str(tmp_path / "j"), **kw)
        tfix.generate_dca_fixture(str(tmp_path / "t"), **kw)
    want, got = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert len(want) == (36 if kind == "amd" else 18)
    assert got == want


def _assert_samples_equal(got, want):
    for field in ("images", "t_xyz", "q_wxyz", "t_uvz", "r_matrix", "first_mask"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert (got.ratio, got.seq_name, got.image_names) == (want.ratio, want.seq_name,
                                                         want.image_names)


@pytest.mark.parametrize("use_augs", [False, True])
def test_amd_dataset_samples_equal_jax(amd_root, use_augs):
    kw = dict(crop_size=48, seq_len=4, use_augs=use_augs, seed=7)
    jd, td = jds.AMDDataset(amd_root, **kw), tds.AMDDataset(amd_root, **kw)
    assert td.seq_names == jd.seq_names and len(td) == 3
    for i in range(len(jd)):
        _assert_samples_equal(td[i], jd[i])
    raw_j, raw_t = jd.load_sequence_raw(jd.seq_names[1]), td.load_sequence_raw(td.seq_names[1])
    for key in raw_j:
        np.testing.assert_array_equal(raw_t[key], raw_j[key], err_msg=key)


def test_dca_dataset_samples_and_exclusion_equal_jax(tmp_path):
    root = jfix.generate_dca_fixture(str(tmp_path), n_seqs=2, n_frames=5, img_hw=(64, 64), seed=8)
    for name in ("seq_1119", "seq_1134", "seq_1135", "seq_x", "other"):
        (tmp_path / name).mkdir()
    jd = jds.DCADataset(root, crop_size=32, seq_len=3)
    td = tds.DCADataset(root, crop_size=32, seq_len=3)
    assert td.seq_names == jd.seq_names == ["other", "seq_1", "seq_1134", "seq_2", "seq_x"]
    for i in (1, 3):
        _assert_samples_equal(td[i], jd[i])
    custom = dict(exclude=("seq_1",), max_seq_num=2000)
    assert (tds.DCADataset(root, **custom).seq_names
            == jds.DCADataset(root, **custom).seq_names)


def test_dataset_helpers_equal_jax():
    rng_j, rng_t = np.random.default_rng(9), np.random.default_rng(9)
    for total, s in ((40, 8), (5, 8), (100, 16)):
        assert tds.sample_with_max_gap(total, s, rng_t) == jds.sample_with_max_gap(total, s, rng_j)
        assert tds.sample_evenly(total, s) == jds.sample_evenly(total, s)
    bbox = np.array([10.5, 20.25, 60.0, 70.75])
    np.testing.assert_array_equal(tds.make_bbox_square(bbox, 80.3),
                                  jds.make_bbox_square(bbox, 80.3))
    mask = np.zeros((20, 30), np.uint8)
    mask[3:9, 5:17] = 1
    assert tds.mask_bbox(mask) == jds.mask_bbox(mask)


# ---------------------------------------------------------- seeding


@pytest.mark.parametrize("backend", ["corners", "grid"])
def test_seed_query_points_equal_jax(amd_root, backend):
    sample = jds.AMDDataset(amd_root, crop_size=64, seq_len=4)[0]
    want = jkp.seed_query_points(sample.images[0], sample.first_mask, 32, 16, backend=backend,
                                 rng=np.random.default_rng(11))
    got = tkp.seed_query_points(sample.images[0], sample.first_mask, 32, 16, backend=backend,
                                rng=np.random.default_rng(11))
    assert got.shape == (32, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # an image on a device is read back for the detector
    got_t = tkp.seed_query_points(torch.as_tensor(sample.images[0]), sample.first_mask, 32, 16,
                                  backend=backend, rng=np.random.default_rng(11))
    np.testing.assert_array_equal(got_t, want)


def test_filter_and_pad_and_grid_samples_equal_jax():
    mask = np.zeros((40, 40), bool)
    mask[10:14, 5:9] = True
    pts = np.random.default_rng(12).uniform(0, 40, size=(30, 2)).astype(np.float32)
    for lo, hi in ((64, 64), (8, 16), (2, 4)):
        np.testing.assert_array_equal(
            tkp.filter_and_pad(pts, mask, lo, hi, np.random.default_rng(13)),
            jkp.filter_and_pad(pts, mask, lo, hi, np.random.default_rng(13)))
    for kw in (dict(n=50), dict(pixel_interval=7)):
        np.testing.assert_array_equal(tkp.generate_grid_samples([3, 4, 60, 33], **kw),
                                      jkp.generate_grid_samples([3, 4, 60, 33], **kw))


def test_superpoint_backend_waits_for_the_matching_slice(monkeypatch):
    """The superpoint backend (ported with the matching slice) runs on the
    card unless the caller passes a device: without one it raises rather
    than fall back to the CPU, and with ``device="cpu"`` it seeds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frame = np.random.default_rng(0).integers(0, 255, (32, 40, 3)).astype(np.uint8)
    mask = np.ones((32, 40), bool)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkp.seed_query_points(frame, mask, 16, 8, backend="superpoint")
    pts = tkp.seed_query_points(frame, mask, 16, 8, backend="superpoint", device="cpu")
    assert pts.shape == (16, 2) and np.isfinite(pts).all()


# ----------------------------------------------------- preprocessing


@pytest.mark.parametrize("resample", ["bilinear", "lanczos"])
@pytest.mark.parametrize("square", [(10.0, 6.0, 70.0, 66.0), (-12.0, -20.0, 90.0, 82.0),
                                    (30.0, 2.0, 45.0, 17.0)])
def test_preprocess_frames_matches_jax(resample, square):
    frames = np.random.default_rng(14).integers(0, 256, size=(2, 60, 80, 3), dtype=np.uint8)
    sq = np.asarray(square, np.float32)
    want = jdp.preprocess_frames(jnp.asarray(frames), jnp.asarray(sq), 32, resample)
    got = tdp.preprocess_frames(torch.from_numpy(frames), sq, 32, resample)
    assert got.dtype == torch.float32 and got.shape == (2, 32, 32, 3)
    _close(got, want, 1e-5)
    mask = (np.random.default_rng(15).random((60, 80)) > 0.5).astype(np.uint8)
    want_m = np.asarray(jdp.preprocess_mask(jnp.asarray(mask), jnp.asarray(sq), 32))
    np.testing.assert_array_equal(tdp.preprocess_mask(torch.from_numpy(mask), sq, 32).numpy(),
                                  want_m)
    np.testing.assert_array_equal(tdp._host_nearest_mask(mask, sq, 32), want_m)


def test_device_preprocess_dataset_matches_jax(amd_root):
    base_j = jds.AMDDataset(amd_root, crop_size=48, seq_len=4)
    base_t = tds.AMDDataset(amd_root, crop_size=48, seq_len=4)
    jd = jdp.DevicePreprocessDataset(base_j, resample="lanczos")
    td = tdp.DevicePreprocessDataset(base_t, resample="lanczos", device="cpu")
    kept = tdp.DevicePreprocessDataset(base_t, resample="lanczos", keep_on_device=True,
                                       device="cpu")
    for i in range(2):
        want, got, on_device = jd[i], td[i], kept[i]
        _close(got.images, want.images, 1e-5)
        assert isinstance(got.images, np.ndarray) and isinstance(on_device.images, torch.Tensor)
        assert on_device.ready is None and torch.equal(on_device.images,
                                                        torch.from_numpy(got.images))
        np.testing.assert_array_equal(got.first_mask, want.first_mask)
        np.testing.assert_array_equal(got.frame0_u8, want.frame0_u8)
        np.testing.assert_array_equal(got.q_wxyz, want.q_wxyz)
    # decode="native": the C++ loader's raw frames, then the same ops (PNG
    # fixtures decode to the same pixels as PIL's)
    native_t = tdp.DevicePreprocessDataset(base_t, resample="lanczos", decode="native",
                                           device="cpu")
    native_j = jdp.DevicePreprocessDataset(base_j, resample="lanczos", decode="native")
    for i in range(2):
        got, want = native_t[i], td[i]
        np.testing.assert_array_equal(got.images, want.images)
        _close(got.images, native_j[i].images, 1e-5)
        np.testing.assert_array_equal(got.first_mask, want.first_mask)
        np.testing.assert_array_equal(got.frame0_u8, want.frame0_u8)
        np.testing.assert_array_equal(got.t_uvz, want.t_uvz)


# ------------------------------------------------------- eval step


@pytest.fixture(scope="module")
def eval_model(amd_root):
    """The tiny config at 4 frames (both packages), shared weights, and the
    fixture's datasets at its crop size."""
    jc, tc = _tiny(jcfg).replace(**_EVAL), _tiny(tcfg).replace(**_EVAL)
    s, hw, n = jc.seqlen, jc.img_size, jc.track_num
    images = np.zeros((1, s, hw, hw, 3), np.float32)
    queries = np.full((1, n, 2), hw / 2.0, np.float32)
    params = _jax_params(jc, images, queries, seed=17)
    model = build_comet(tc, device="cpu")
    model.load_state_dict(params_from_jax({"params": params}, tc))
    kw = dict(crop_size=hw, seq_len=s, use_augs=False)
    return dict(jc=jc, tc=tc, params={"params": params}, model=model,
                jds=jds.AMDDataset(amd_root, **kw), tds=tds.AMDDataset(amd_root, **kw))


def _queries(sample):
    """The same query points for both packages: the grid over the mask."""
    return tkp.grid_points(sample.first_mask, 8)


def test_eval_step_matches_jax(eval_model):
    sample = eval_model["jds"][0]
    images, queries = sample.images[None], _queries(sample)[None]
    gt_j = jloop.make_gt_cameras(sample)
    want = jloop.build_eval_step(JaxCOMET(eval_model["jc"]), eval_model["jc"])(
        eval_model["params"], jnp.asarray(images), jnp.asarray(queries), gt_j)
    want = {k: np.asarray(v) for k, v in want.items()}
    gt_t = tloop.make_gt_cameras(eval_model["tds"][0])
    for a, b in zip(gt_t, gt_j):
        np.testing.assert_array_equal(a, b)
    tc = eval_model["tc"]
    got = tloop.eval_step(eval_model["model"], tc, _t(images), _t(queries), gt_t)
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
    _close(got["pred_track"], want["pred_track"], 2e-2, 2e-2)
    _close(got["track_score"], want["track_score"], 5e-3, 5e-3)
    _close(got["pred_pose_enc"], want["pred_pose_enc"], 5e-3, 5e-3)
    _close(got["gt_pose_enc"], want["gt_pose_enc"], 1e-5)
    # decode and loss of the port's own poses: the JAX functions, at 1e-5
    pred = jnp.asarray(got["pred_pose_enc"].numpy())
    q_abs, t_abs = jcomet.decode_predictions(eval_model["jc"], pred, jcam.CameraSet(*gt_j))
    _close(got["pred_q"], q_abs, 1e-5, 1e-5)
    _close(got["pred_t"], t_abs, 1e-5, 1e-5)
    losses = jcomet.pose_loss(eval_model["jc"], pred, jnp.asarray(want["gt_pose_enc"])[None])
    for key in ("loss", "loss_trans", "loss_rot"):
        _close(got[key], losses[key], 1e-5, 1e-5)
        _close(got[key], want[key], 5e-3, 5e-3)


# -------------------------------------------------------- evaluate


@pytest.fixture(scope="module")
def jax_eval(eval_model):
    """JAX's evaluate() over the fixture's 3 sequences, one at a time."""
    return jloop.evaluate(JaxCOMET(eval_model["jc"]), eval_model["params"], eval_model["jds"],
                          eval_model["jc"], keypoint_backend=_queries, print_fn=lambda *a: None)


@pytest.mark.parametrize("eval_batch", [1, 2])
def test_evaluate_matches_jax(eval_model, jax_eval, eval_batch):
    """3 sequences: at eval_batch 2 the second batch is padded, and its
    padded row dropped. JAX's own test holds its eval_batch 2 to its
    eval_batch 1, so both are held to JAX's sequential run."""
    printed = []
    got = tloop.evaluate(eval_model["model"], eval_model["tds"], eval_model["tc"],
                         keypoint_backend=_queries, print_fn=printed.append,
                         print_interval=1, eval_batch=eval_batch, device="cpu")
    assert set(got) == set(jax_eval)
    assert sum(k.startswith("Auc_scene_model1/seq_") for k in got) == 3
    for key in CONTINUOUS:
        np.testing.assert_allclose(got[key], jax_eval[key], rtol=1e-5, atol=1e-4, err_msg=key)
    assert all(np.isfinite(v) for v in got.values())
    assert len(printed) == (3 if eval_batch == 1 else 2) and printed[0].startswith("[eval] it 0/3")


def test_evaluate_seeds_as_jax(eval_model, monkeypatch):
    """With a backend name the query points come from one rng seeded with
    cfg.train.seed, drawn in dataset order: the port's evaluate hands the
    model the points JAX's would, padded rows included."""
    seen = []
    model = eval_model["model"]
    real_forward = type(model).forward

    def recording(self, images, queries):
        seen.append(queries.numpy().copy())
        return real_forward(self, images, queries)

    monkeypatch.setattr(type(model), "forward", recording)
    tloop.evaluate(model, eval_model["tds"], eval_model["tc"], keypoint_backend="grid",
                   print_fn=lambda *a: None, eval_batch=2, device="cpu")
    rng = np.random.default_rng(eval_model["jc"].train.seed)
    ds, jc = eval_model["jds"], eval_model["jc"]
    want = [jkp.seed_query_points(ds[i].images[0], ds[i].first_mask, jc.track_num,
                                  jc.min_track_num, backend="grid", rng=rng) for i in (0, 1, 2, 2)]
    np.testing.assert_array_equal(np.concatenate(seen), np.stack(want))


class _CpuMesh:
    """A 2-rank CPU mesh, as far as evaluate looks at one."""

    device_type = "cpu"

    def size(self, dim=None):
        return 2


def test_evaluate_refuses_what_it_does_not_run(eval_model, monkeypatch):
    args = (eval_model["model"], eval_model["tds"], eval_model["tc"])
    # the mesh path runs on the rank's device (tests/test_torch_port_distributed.py)
    with pytest.raises(ValueError, match="mesh device is cpu"):
        tloop.evaluate(*args, mesh=_CpuMesh(), device="meta")
    with pytest.raises(ValueError, match="eval_batch"):
        tloop.evaluate(*args, eval_batch=0, device="cpu")
    with pytest.raises(ValueError, match="model is on cpu"):
        tloop.evaluate(*args, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tloop.evaluate(*args)


def test_prefetch_keeps_order_and_raises():
    assert list(prefetch(lambda i: i * i, 5, depth=2)) == [0, 1, 4, 9, 16]
    assert list(prefetch(lambda i: i, 0)) == []

    def failing(i):
        if i == 2:
            raise KeyError("bad item")
        return i

    with pytest.raises(KeyError, match="bad item"):
        list(prefetch(failing, 4))


# ------------------------------------------------------ benchmarks


def _jax_return_keys(fn_name):
    """The keys of the dict literal that comet_tpu/bench_lib.py's function returns."""
    tree = ast.parse((REPO / "comet_tpu" / "bench_lib.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    (ret,) = [n for n in ast.walk(fn)
              if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    return {k.value for k in ret.value.keys}


def test_run_benchmark_keys_on_the_cpu(eval_model):
    out = bench_lib.run_benchmark(eval_model["tc"], warmup=1, reps=2, device="cpu")
    want = _jax_return_keys("run_benchmark") - {"host_rtt_ms"} | {"device_ms_per_sequence"}
    assert set(out) == want
    assert out["value"] > 0 and out["device"] == "cpu" and out["device_ms_per_sequence"] is None
    assert out["metric"] == "sequences/sec/chip (seqlen=4, 64px, N=8)"


def test_run_eval_data_benchmark_keys_on_the_cpu(eval_model):
    out = bench_lib.run_eval_data_benchmark(eval_model["tc"], max_sequences=2, eval_batch=2,
                                            device="cpu")
    assert set(out) == _jax_return_keys("run_eval_data_benchmark")
    assert out["n_sequences"] == 2 and out["value"] > 0 and "decode=pil" in out["metric"]


def test_entry_is_the_forward_of_zero_params(eval_model):
    tc = eval_model["tc"]
    fn, (params, images, queries) = entry.entry(tc, device="cpu")
    assert set(params) == set(eval_model["model"].state_dict())
    assert all(not p.any() for p in params.values())
    assert images.shape == (1, 4, 64, 64, 3) and queries.shape == (1, 8, 2)
    with torch.inference_mode():
        out = fn(params, images, queries)
        model = build_comet(tc, device="cpu")
        model.load_state_dict(params)
        want = model(images, queries)
    assert set(out) == set(want)
    for key in out:
        assert torch.equal(out[key], want[key]), key


@pytest.mark.parametrize("name", ["evaluate", "DevicePreprocessDataset", "run_benchmark",
                                  "run_eval_data_benchmark", "entry"])
def test_entry_points_need_a_card_by_default(eval_model, monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "evaluate": lambda: tloop.evaluate(eval_model["model"], eval_model["tds"],
                                           eval_model["tc"]),
        "DevicePreprocessDataset": lambda: tdp.DevicePreprocessDataset(eval_model["tds"]),
        "run_benchmark": lambda: bench_lib.run_benchmark(eval_model["tc"]),
        "run_eval_data_benchmark": lambda: bench_lib.run_eval_data_benchmark(eval_model["tc"]),
        "entry": lambda: entry.entry(eval_model["tc"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[name]()


def test_eval_modules_import_without_pillow_cv2_or_jax():
    code = ("import sys\n"
            "for m in ('PIL', 'cv2', 'jax', 'flax', 'comet_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import comet_tpu_torch.bench_lib, comet_tpu_torch.data, comet_tpu_torch.entry\n"
            "import comet_tpu_torch.metrics, comet_tpu_torch.training\n"
            "print('imported')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "imported"
