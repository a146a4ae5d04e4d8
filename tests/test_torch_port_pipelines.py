"""The port's depth ground truth (``depth_gt``), cached-prediction pipelines
(``eval_pipeline``), feature cache (``cache_loader``) and drawing (``viz``)
against ``comet_tpu``'s, on the CPU, on the same numpy inputs: 64 x 64 depth
maps of a plane seen by two cameras (with holes), 64 keypoints and 8 lines;
the pipelines on synthetic 64 px pairs (one, and two for the inspection),
on a directory of 64 px images (a folder warp, a pairs file: a pair each)
and on an AMD fixture's pair of 48 x 64 frames.

The homography and essential RANSACs of the port draw their samples through
``twoview.estimators.ransac_samples``; the tests replace it with the indices
JAX draws from its key (``PRNGKey(0)`` per estimator call), so the robust
rows compare. The JAX side's SIFT, matcher, metrics, DLT and RANSACs run
under ``jax.jit`` (``torch_port_line_helpers.jit_jax_matching``).

Tolerances: depth and line ground-truth labels and visibility exactly equal,
their distances and projections within 1e-5 of the largest |value| (at least
1); the pipelines' per-pair metrics within 1e-5 of the largest |value|, but
the homography and pose errors (a DLT or an 8-point fit: an f32 SVD) within
1e-3 relative, as ``test_torch_port_match_cli.py`` holds ``H_error``; the
summaries as ``torch_port_line_helpers.same_pipeline_row`` holds them; the
names, scenes and match counts equal; the .h5 files each package writes
read by the other, array for array equal; the drawings pixel for pixel
equal.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu.matching import cache_loader as jcache
from comet_tpu.matching import depth_gt as jdgt
from comet_tpu.matching import eval_pipeline as jep
from comet_tpu.matching import registry as jreg
from comet_tpu.matching import viz as jviz
from comet_tpu_torch.matching import cache_loader as tcache
from comet_tpu_torch.matching import depth_gt as tdgt
from comet_tpu_torch.matching import eval_pipeline as tep
from comet_tpu_torch.matching import registry as treg
from comet_tpu_torch.matching import viz as tviz
from torch_port_line_helpers import jax_draws, jit_jax_matching, one_torch_thread  # noqa: F401
from torch_port_line_helpers import same_pipeline_row

SIZE = 64
TOL = 1e-5


@pytest.fixture
def jax_jitted(monkeypatch):
    jit_jax_matching(monkeypatch)
    jax_draws(monkeypatch)


def _n(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, what="", tol=TOL):
    got, want = np.asarray(_n(got), np.float64), np.asarray(_n(want), np.float64)
    assert got.shape == want.shape, what
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=what)
    scale = max(float(np.abs(want[finite]).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=tol * scale, err_msg=what)


# ------------------------------------------------------------ depth ground truth

def _rot(axis, ang):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    kx = np.asarray([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(ang) * kx + (1 - np.cos(ang)) * kx @ kx


@pytest.fixture(scope="module")
def plane_scene():
    """Two 64 x 64 views of the plane n.X = d (camera-0 frame) with exact
    depth maps (a few holes of depth 0), 64 keypoints in view 0, their
    projections into view 1 with noise for the first 48 (the rest at
    random), and 8 segments with their warps (the plane's homography)."""
    rng = np.random.default_rng(0)
    k = np.asarray([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]])
    r = _rot([0.2, 1.0, 0.1], 0.15)
    t = np.asarray([0.4, -0.1, 0.05])
    n, d = np.asarray([0.1, -0.05, 1.0]), 4.0
    ys, xs = np.mgrid[0:SIZE, 0:SIZE] + 0.5
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(k).T
    depth0 = d / (rays @ n)
    # the plane in camera 1: n1 = R n, d1 = d + n1 . t
    n1 = r @ n
    depth1 = (d + n1 @ t) / (rays @ n1)
    for dm in (depth0, depth1):
        for _ in range(3):
            y, x = rng.integers(0, SIZE - 8, 2)
            dm[y:y + 8, x:x + 6] = 0.0
    h01 = k @ (r + np.outer(t, n) / d) @ np.linalg.inv(k)

    def warp(p, h):
        q = np.concatenate([p, np.ones_like(p[:, :1])], -1) @ h.T
        return q[:, :2] / q[:, 2:]

    kp0 = rng.uniform(2, SIZE - 2, (SIZE, 2))
    kp1 = warp(kp0, h01) + rng.normal(0, 0.5, kp0.shape)
    kp1[48:] = rng.uniform(2, SIZE - 2, (16, 2))
    lines0 = rng.uniform(4, SIZE - 4, (8, 2, 2))
    lines1 = warp(lines0.reshape(-1, 2), h01).reshape(8, 2, 2) + rng.normal(0, 0.3, (8, 2, 2))
    lines1[6:] = rng.uniform(4, SIZE - 4, (2, 2, 2))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(kp0=f32(kp0), kp1=f32(kp1), depth0=f32(depth0), depth1=f32(depth1), K0=f32(k),
                K1=f32(k), R_0to1=f32(r), t_0to1=f32(t), lines0=f32(lines0), lines1=f32(lines1),
                H_0to1=f32(h01))


_LABELS = ("matches0", "matches1", "assignment", "visible0", "visible1", "line_matches0",
           "line_matches1")


def _compare_gt(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if k in _LABELS:
            np.testing.assert_array_equal(_n(got[k]), np.asarray(w), err_msg=k)
        else:
            _close(got[k], w, k)


_POSE = ("depth0", "depth1", "K0", "K1", "R_0to1", "t_0to1")


@pytest.mark.parametrize("conf", [{}, {"cc_threshold": 4.0}, {"epi_threshold": 1.0},
                                  {"pos_threshold": 1.0, "neg_threshold": 2.0}],
                         ids=["plain", "cycle", "epipolar", "tight"])
def test_gt_matches_from_pose_depth_match_jax(plane_scene, conf):
    s = plane_scene
    want = jax.jit(functools.partial(jdgt.gt_matches_from_pose_depth, **conf))(
        s["kp0"], s["kp1"], *(s[k] for k in _POSE))
    got = tdgt.gt_matches_from_pose_depth(_t(s["kp0"]), _t(s["kp1"]),
                                          *(_t(s[k]) for k in _POSE), **conf)
    m0 = np.asarray(want["matches0"])
    assert (m0 >= 0).sum() >= 10 and (m0 == -1).sum() >= 3
    _compare_gt(got, want)


def test_depth_helpers_match_jax(plane_scene):
    s = plane_scene
    pts = np.concatenate([s["kp0"], [[-1.0, 3.0], [63.9, 63.9], [0.2, 0.3]]]).astype(np.float32)
    for got, want in zip(tdgt.sample_depth(_t(pts), _t(s["depth0"])),
                         jdgt.sample_depth(pts, s["depth0"])):
        _close(got, want, "sample_depth")
    e = tdgt.pose_to_essential(_t(s["R_0to1"]), _t(s["t_0to1"]))
    _close(e, jdgt.pose_to_essential(s["R_0to1"], s["t_0to1"]), "E")
    f = tdgt.essential_to_fundamental(e, _t(s["K0"]), _t(s["K1"]))
    jf = jdgt.essential_to_fundamental(jnp.asarray(_n(e)), s["K0"], s["K1"])
    _close(f, jf, "F")
    _close(tdgt.sym_epipolar_distance_all(_t(s["kp0"]), _t(s["kp1"]), f),
           jdgt.sym_epipolar_distance_all(s["kp0"], s["kp1"], jf), "epipolar")
    for cc in (None, 4.0):
        want = jax.jit(functools.partial(jdgt.dense_warp_consistency, cc_th=cc))(
            *(s[k] for k in _POSE))
        got = tdgt.dense_warp_consistency(*(_t(s[k]) for k in _POSE), cc_th=cc)
        np.testing.assert_array_equal(_n(got[1]), np.asarray(want[1]))
        valid = np.asarray(want[1])
        _close(_n(got[0])[valid], np.asarray(want[0])[valid], "warped")


def test_line_gt_matches_jax(plane_scene):
    s = plane_scene
    want = jax.jit(jdgt.gt_line_matches_from_pose_depth)(s["lines0"], s["lines1"],
                                                        *(s[k] for k in _POSE))
    got = tdgt.gt_line_matches_from_pose_depth(_t(s["lines0"]), _t(s["lines1"]),
                                               *(_t(s[k]) for k in _POSE))
    assert (np.asarray(want["line_matches0"]) >= 0).sum() >= 3
    _compare_gt(got, want)
    want = jax.jit(jdgt.gt_line_matches_from_homography)(s["lines0"], s["lines1"], s["H_0to1"])
    got = tdgt.gt_line_matches_from_homography(_t(s["lines0"]), _t(s["lines1"]),
                                               _t(s["H_0to1"]))
    assert (np.asarray(want["line_matches0"]) >= 0).sum() >= 3
    _compare_gt(got, want)


def test_registered_gt_matchers_match_jax(plane_scene):
    s = plane_scene
    f0, f1 = {"keypoints": s["kp0"]}, {"keypoints": s["kp1"]}
    tf0, tf1 = {"keypoints": _t(s["kp0"])}, {"keypoints": _t(s["kp1"])}
    data = {k: s[k] for k in _POSE + ("H_0to1",)}
    tdata = {k: _t(v) for k, v in data.items()}
    for name in ("matcher_homography", "matcher_depth"):
        assert treg._DEFAULTS[name] == jreg._DEFAULTS[name]
        want = jax.jit(jreg.get_model(name))(f0, f1, data)
        got = treg.get_model(name)(tf0, tf1, tdata)
        for k in ("matches0", "matches1"):
            np.testing.assert_array_equal(_n(got[k]), np.asarray(want[k]), err_msg=name)


# ------------------------------------------------------------ metrics and files

def test_metrics_and_synthetic_poses_match_jax():
    rng = np.random.default_rng(1)
    errs = np.concatenate([rng.exponential(3.0, 20), [np.inf, 0.0]])
    assert tep.cal_error_auc(errs, [1, 3, 5]) == jep.cal_error_auc(errs, [1, 3, 5])
    assert tep.AUCMetric([5, 10], errs).compute() == jep.AUCMetric([5, 10], errs).compute()
    res = {th: {"err": list(rng.exponential(th, 6)), "inl": list(rng.random(6))}
           for th in (0.5, 1.0, 2.0)}
    assert tep.eval_poses(res, [1, 3], "err") == jep.eval_poses(res, [1, 3], "err")
    got, want = tep.make_synthetic_pose_pairs(3, seed=2), jep.make_synthetic_pose_pairs(3, seed=2)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    p = got[0]
    args = (p["kpts_proj0"], p["kpts_proj1"], p["K0"], p["K1"], p["R_0to1"], p["t_0to1"])
    np.testing.assert_array_equal(tep.sampson_distance_normalized(*args),
                                  jep.sampson_distance_normalized(*args))
    r2 = p["R_0to1"] @ _rot([0, 0, 1], 0.01)
    assert tep.relative_pose_error_deg(p["R_0to1"], p["t_0to1"], r2, -p["t_0to1"]) == \
        jep.relative_pose_error_deg(p["R_0to1"], p["t_0to1"], r2, -p["t_0to1"])


def _h5_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_h5_files_cross_both_ways(tmp_path):
    """Predictions written by either package (the port's from tensors: its
    int64 and float64 narrowed, as JAX's defaults are) and results written
    by either are read by the other, array for array."""
    rng = np.random.default_rng(3)
    items = [{"name": f"p{i}", "n": i + 3} for i in range(2)]

    def jmodel(d):
        return {"keypoints0": jnp.asarray(rng.random((d["n"], 2)), jnp.float32),
                "matches0": jnp.arange(d["n"]) - 1, "extra": jnp.ones(2)}

    jfile = jep.export_predictions(items, jmodel, str(tmp_path / "j.h5"), ["keypoints0",
                                   "matches0"], ["extra", "absent"])

    def tmodel(d):
        k = jep.load_predictions(jfile, d["name"])
        return {"keypoints0": torch.as_tensor(k["keypoints0"], dtype=torch.float64),
                "matches0": torch.arange(d["n"]) - 1, "extra": torch.ones(2)}

    tfile = tep.export_predictions(items, tmodel, str(tmp_path / "t.h5"), ["keypoints0",
                                   "matches0"], ["extra", "absent"])
    for d in items:
        _h5_equal(tep.load_predictions(jfile, d["name"]), jep.load_predictions(tfile, d["name"]))
    summaries = {"a": 0.5, "b": float("inf"), "c": [1, 2]}
    results = {"x": [1.0, 2.0], "names": ["p0", "p1"], "n": [3, 4]}
    for writer, reader, sub in ((jep, tep, "j"), (tep, jep, "t")):
        os.makedirs(tmp_path / sub)
        writer.save_eval(str(tmp_path / sub), summaries, results)
        assert tep.exists_eval(str(tmp_path / sub))
        s, r = reader.load_eval(str(tmp_path / sub))
        s2, r2 = writer.load_eval(str(tmp_path / sub))
        assert json.dumps(s) == json.dumps(s2)
        _h5_equal(r, r2)


def test_missing_h5py_raises_naming_it(monkeypatch, tmp_path):
    """Without h5py every file function and ``run`` raise, naming the
    package; no other file is written."""
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ModuleNotFoundError, match="h5py"):
        tep.export_predictions([], lambda d: d, str(tmp_path / "p.h5"), [])
    with pytest.raises(ModuleNotFoundError, match="h5py"):
        tep.save_eval(str(tmp_path), {}, {})
    with pytest.raises(ModuleNotFoundError, match="h5py"):
        tep.load_predictions(str(tmp_path / "p.h5"), "x")
    with pytest.raises(ModuleNotFoundError, match="h5py"):
        tep.HomographyEvalPipeline(device="cpu").run(str(tmp_path / "exp"))
    assert os.listdir(tmp_path) == []


# ------------------------------------------------------------ the pipelines

def _run_both(tmp_path, cls_name, conf, **kw):
    """JAX's and the port's pipeline ``run`` (the port on the CPU), each in
    its own directory: ((summaries, results), ...) and the two dirs."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = getattr(jep, cls_name)(conf).run(jdir, **kw)
    got = getattr(tep, cls_name)(conf, device="cpu").run(tdir, **kw)
    return got, want, tdir, jdir


_FIT = ("H_error", "rel_pose_error")
FIT_RTOL = 1e-3


def _same_results(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w.dtype.kind in "OSU":
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        elif k.startswith(_FIT):
            np.testing.assert_array_equal(np.isfinite(got[k]), np.isfinite(w), err_msg=k)
            np.testing.assert_allclose(got[k][np.isfinite(w)], w[np.isfinite(w)],
                                       rtol=FIT_RTOL, err_msg=k)
        else:
            _close(got[k], w, k)


def _same_run(got, want, tdir, jdir):
    same_pipeline_row(got[0], want[0])
    _same_results(got[1], want[1])
    with open(os.path.join(tdir, "conf.json")) as f, open(os.path.join(jdir, "conf.json")) as g:
        assert json.load(f) == json.load(g)
    # each package reads the other's prediction cache
    names = list(want[1]["names"])
    for name in names:
        a = jep.load_predictions(os.path.join(tdir, "predictions.h5"), name)
        b = tep.load_predictions(os.path.join(jdir, "predictions.h5"), name)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            _close(a[k], b[k], k)


def _images(root, n=3):
    from PIL import Image

    from comet_tpu_torch.matching.benchmarks import synthetic_texture

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(5)
    for i in range(n):
        img = (synthetic_texture(rng, SIZE, SIZE)[..., 0] * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"img{i}.png"))
    return root


@pytest.mark.parametrize("source", ["synthetic", "image_dir", "pairs_file"])
def test_homography_pipeline_matches_jax(source, tmp_path, jax_jitted):
    conf = {"data": {"n_pairs": 1, "image_size": SIZE},
            "model": {"extractor_conf": {"max_keypoints": 64}}}
    if source != "synthetic":
        conf["data"]["image_dir"] = _images(str(tmp_path / "images"),
                                            1 if source == "image_dir" else 2)
    if source == "pairs_file":
        h = "1.05 0.02 1.5 -0.01 0.98 -2.0 0.0001 0.0 1.0"
        path = tmp_path / "pairs.txt"
        path.write_text(f"img0.png img1.png {h}\nshort line\n")
        conf["data"]["pairs_file"] = str(path)
    got, want, tdir, jdir = _run_both(tmp_path, "HomographyEvalPipeline", conf)
    assert want[0]["mnum_matches"] > 4
    _same_run(got, want, tdir, jdir)


def test_relative_pose_pipeline_matches_jax(tmp_path, jax_jitted):
    """Synthetic pairs (the oracle correspondences) with one RANSAC
    threshold, then an AMD fixture's image pairs (SIFT and mutual nearest
    neighbours) with the default sweep."""
    from comet_tpu_torch.data.fixtures import generate_amd_fixture

    conf = {"data": {"n_pairs": 2, "n_points": 48}, "eval": {"ransac_th": 1.0}}
    got, want, tdir, jdir = _run_both(tmp_path / "synthetic", "RelativePoseEvalPipeline", conf)
    assert want[0]["mnum_matches"] == 48
    _same_run(got, want, tdir, jdir)
    root = str(tmp_path / "AMD")
    generate_amd_fixture(root, n_seqs=1, n_frames=5, img_hw=(48, 64), seed=3)
    conf = {"data": {"amd_dir": root, "max_pairs": 1},
            "model": {"extractor_conf": {"max_keypoints": 64}}}
    got, want, tdir, jdir = _run_both(tmp_path / "amd", "RelativePoseEvalPipeline", conf)
    assert list(want[1]["names"]) == ["model1_seq_1_f000_f002"]
    _same_run(got, want, tdir, jdir)


def test_pipeline_reuse_guard_and_inspect_match_jax(tmp_path, jax_jitted):
    """A rerun reuses the cache; a changed data config raises until
    ``overwrite``; ``inspect`` draws the same PNGs as JAX's."""
    import cv2

    conf = {"data": {"n_pairs": 2, "image_size": SIZE},
            "model": {"extractor_conf": {"max_keypoints": 64}}, "eval": {"ransac_th": 2.0}}
    got, want, tdir, jdir = _run_both(tmp_path, "HomographyEvalPipeline", conf)
    _same_run(got, want, tdir, jdir)
    pipe = tep.HomographyEvalPipeline(conf, device="cpu")
    stamp = os.path.getmtime(os.path.join(tdir, "predictions.h5"))
    assert pipe.run(tdir)[0] == got[0]
    assert os.path.getmtime(os.path.join(tdir, "predictions.h5")) == stamp
    changed = tep.HomographyEvalPipeline({**conf, "data": {"n_pairs": 1, "image_size": SIZE}},
                                         device="cpu")
    with pytest.raises(RuntimeError, match="configs changed"):
        changed.run(tdir)
    paths = pipe.inspect(tdir, k=2)
    jpaths = jep.HomographyEvalPipeline(conf).inspect(jdir, k=2)
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jpaths]
    for p, q in zip(paths, jpaths):
        np.testing.assert_array_equal(cv2.imread(p), cv2.imread(q))
    assert len(changed.run(tdir, overwrite=True)[1]["names"]) == 1


# ------------------------------------------------------------ the cache and the drawing

def test_cache_loader_and_padding_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    x = rng.random((5, 2)).astype(np.float32)
    for mode in ("zeros", "ones", "random", "random_c"):
        np.testing.assert_array_equal(tcache.pad_to_length(x, 9, mode=mode),
                                      jcache.pad_to_length(x, 9, mode=mode))
    np.testing.assert_array_equal(tcache.pad_to_length(x[:0], 3, mode="random"),
                                  jcache.pad_to_length(x[:0], 3, mode="random"))
    with pytest.raises(ValueError):
        tcache.pad_to_length(x, 2)
    pred = {"keypoints": x, "descriptors": rng.random((5, 4)).astype(np.float32),
            "keypoint_scores": rng.random(5).astype(np.float32), "matches0": np.arange(5)}
    path = str(tmp_path / "feats.h5")
    tep.export_predictions([{"name": "a"}], lambda d: pred, path, list(pred))
    conf = dict(path=str(tmp_path / "{stem}.h5"), padding_length=8, numeric_type="float64")
    data = {"name": "a", "stem": "feats", "scales": np.asarray([2.0, 0.5])}
    got = treg.get_model("cache_loader", **conf)(data)
    want = jreg.get_model("cache_loader", **conf)(data)
    _h5_equal(got, want)
    assert got["keypoints"].shape == (8, 2) and got["keypoints"].dtype == np.float64
    calls = []

    def extractor(img):
        calls.append(img)
        return {"d": img}

    out = tcache.TripletPipeline(extractor, lambda a, b: {"m": a["d"] + b["d"]})(1, 2, 4)
    assert len(calls) == 3 and [out[k]["m"] for k in ("0to1", "0to2", "1to2")] == [3, 5, 6]


def test_viz_matches_jax():
    """Every drawing, given tensors (the port) and numpy (JAX), pixel for pixel."""
    rng = np.random.default_rng(7)
    img0 = rng.random((40, 48, 3)).astype(np.float32)
    img1 = (rng.random((36, 44)) * 255).astype(np.uint8)
    k0, k1 = rng.uniform(0, 36, (6, 2)), rng.uniform(0, 36, (6, 2))
    lines = rng.uniform(0, 36, (4, 2, 2))
    correct = rng.random(6) > 0.5
    f = rng.normal(size=(3, 3))
    cases = [
        ("cm_RdGn", (rng.random(5),), {}),
        ("side_by_side", (img0, img1), {}),
        ("draw_keypoints", (img0, k0), {"scores": rng.random(6)}),
        ("draw_keypoints", (img1, k0), {}),
        ("draw_matches", (img0, img1, k0, k1), {}),
        ("draw_matches", (img0, img1, k0, k1), {"correct": correct}),
        ("draw_matches", (img0, img1, k0[:0], k1[:0]), {}),
        ("draw_lines", (img0, lines), {}),
        ("draw_line_matches", (img0, img1, lines, lines[::-1].copy()), {}),
        ("draw_line_matches", (img0, img1, lines, lines), {"correct": correct[:4]}),
        ("draw_epipolar_lines", (img0, img1, f, k0), {}),
        ("heatmap_overlay", (img0, rng.random((20, 24))), {}),
    ]
    for name, args, kw in cases:
        targs = [torch.as_tensor(a) if isinstance(a, np.ndarray) and a.dtype != np.uint8 else a
                 for a in args]
        got, want = getattr(tviz, name)(*targs, **kw), getattr(jviz, name)(*args, **kw)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w, err_msg=name)
    pred = {"keypoints0": rng.uniform(0, 36, (2, 6, 2)), "keypoints1": rng.uniform(0, 36, (2, 6, 2)),
            "matches0": rng.integers(-1, 6, (2, 6)), "gt_matches0": rng.integers(-2, 6, (2, 6))}
    data = {"image0": rng.random((2, 40, 48, 3)), "image1": rng.random((2, 40, 48, 3))}
    got = tviz.make_match_figures({k: torch.as_tensor(v) for k, v in pred.items()}, data)
    want = jviz.make_match_figures(pred, data)
    for g, w in zip(got["matching"], want["matching"]):
        np.testing.assert_array_equal(g, w)
    fig = tviz.plot_cumulative_errors({"a": torch.as_tensor([1.0, 5.0, 20.0])})
    assert len(fig.axes[0].lines) == 1
