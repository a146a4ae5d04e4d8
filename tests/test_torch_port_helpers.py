"""The port's glue-factory helpers (``matching/{misc,patches,tools,image,
inspect_frames}.py``) and every package's exported names against
``comet_tpu``'s, on the CPU.

The cases are those of tests/test_harness_tools.py and tests/test_patches.py,
run through both packages on the same numpy inputs from a seed. Everything
is held exactly: patches, corners (those that hit the reference's clamp to
``dim - 1 - ps`` included) and heat maps, the metric accumulators, the
preprocessor's sizes and arrays (both resize with the same PIL), the batch
plumbing, and the inspection frames' renderings pixel for pixel (both draw
with the same cv2 and matplotlib).
"""

import importlib
import os
import random
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu.matching import image as jimage
from comet_tpu.matching import inspect_frames as jframes
from comet_tpu.matching import misc as jmisc
from comet_tpu.matching import patches as jpatches
from comet_tpu.matching import tools as jtools
from comet_tpu_torch.matching import eval_pipeline as teval
from comet_tpu_torch.matching import image as timage
from comet_tpu_torch.matching import inspect_frames as tframes
from comet_tpu_torch.matching import misc as tmisc
from comet_tpu_torch.matching import patches as tpatches
from comet_tpu_torch.matching import tools as ttools


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want):
    """Equal values of equal shape (numpy, jax and torch leaves alike)."""
    got, want = _n(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- patches

def _corners(rng, n, h, w):
    """Random corners over and beyond the image: fractions truncated toward
    zero, negatives clamped to 0, the far ones clamped to dim - 1 - ps."""
    c = rng.uniform(-6, 1, size=(n, 2)) * [w, h] / 4 + rng.uniform(0, 1, (n, 2)) * [w, h] * 1.3
    c[0] = [-0.7, 3.9]
    c[1] = [w + 5.0, h - 0.2]
    return c.astype(np.float32)


@pytest.mark.parametrize("c,ps", [(1, 3), (3, 5), (2, 7)])
def test_extract_patches_matches_jax(c, ps):
    rng = np.random.default_rng(ps)
    img = rng.normal(size=(c, 20, 26)).astype(np.float32)
    corners = _corners(rng, 9, 20, 26)
    got_p, got_c = tpatches.extract_patches(torch.from_numpy(img), torch.from_numpy(corners), ps)
    want_p, want_c = jpatches.extract_patches(jnp.asarray(img), jnp.asarray(corners), ps)
    _same(got_p, want_p)
    _same(got_c, want_c)
    assert got_c.dtype == torch.float32
    # the reference's bound: the far corner lands on dim - 1 - ps
    assert got_c[1].tolist() == [26 - 1 - ps, 20 - 1 - ps]
    assert got_c[0].tolist() == [0.0, 3.0]


@pytest.mark.parametrize("c", [1, 3])
def test_batch_patches_heatmap_and_drawing_match_jax(c):
    """The tests/test_patches.py case: [2, C, 24, 30] at 6 keypoints, ps 7;
    the drawn patches and the heat map with its mask as JAX's."""
    rng = np.random.RandomState(3)
    img = rng.randn(2, c, 24, 30).astype(np.float32)
    kpts = rng.uniform(0, 24, size=(2, 6, 2)).astype(np.float32)
    kpts[0, 0] = [29.5, 23.5]  # clamped on both axes
    got_p, got_c = tpatches.batch_extract_patches(torch.from_numpy(img), torch.from_numpy(kpts), 7)
    want_p, want_c = jpatches.batch_extract_patches(jnp.asarray(img), jnp.asarray(kpts), 7)
    _same(got_p, want_p)
    _same(got_c, want_c)
    canvas_t, canvas_j = np.zeros_like(img), np.zeros_like(img)
    tpatches.draw_image_patches(canvas_t, got_p, got_c)
    jpatches.draw_image_patches(canvas_j, np.asarray(want_p), np.asarray(want_c))
    _same(canvas_t, canvas_j)
    for got, want in zip(tpatches.build_heatmap(torch.from_numpy(img), got_p, got_c),
                         jpatches.build_heatmap(img, np.asarray(want_p), np.asarray(want_c))):
        _same(got, want)
        assert got.dtype == want.dtype


def test_patches_are_not_the_corr_patches():
    """``ops.corr.extract_patches`` is channel-last and clamps to dim - ps;
    the matching helper's last corner stops one short, as the reference's."""
    from comet_tpu_torch.ops import corr

    img = torch.arange(1 * 10 * 10, dtype=torch.float32).reshape(1, 10, 10)
    _, corners = tpatches.extract_patches(img, torch.tensor([[99.0, -5.0]]), 3)
    assert corners.tolist() == [[10 - 1 - 3, 0]]
    assert corr.extract_patches is not tpatches.extract_patches


# ----------------------------------------------------------------- tools

_METRIC_INPUTS = [
    [np.array([1.0, np.nan, 3.0]), np.float32(4.5), [2.0, 2.5]],
    [np.array([np.nan, np.nan])],
    [],
    [np.arange(7, dtype=np.float32) * 0.3, np.array([np.nan, 11.0, -2.0])],
]


@pytest.mark.parametrize("cls,args", [
    ("AverageMetric", ()), ("FAverageMetric", ()), ("MedianMetric", ()),
    ("QuantileMetric", (0.3,)), ("RecallMetric", ([0.5, 2.0, 5.0],)), ("RecallMetric", (2.0,)),
])
@pytest.mark.parametrize("inputs", range(len(_METRIC_INPUTS)))
def test_metrics_match_jax(cls, args, inputs):
    """Each accumulator over the same updates (the port's given tensors)
    computes JAX's value; FAverageMetric keeps the same elements."""
    got, want = getattr(ttools, cls)(*args), getattr(jtools, cls)(*args)
    for values in _METRIC_INPUTS[inputs]:
        got.update(torch.as_tensor(np.asarray(values, np.float64)))
        want.update(jnp.asarray(values) if np.ndim(values) else values)
    g, w = got.compute(), want.compute()
    np.testing.assert_array_equal(np.asarray(g, np.float64), np.asarray(w, np.float64))
    if cls == "FAverageMetric":
        np.testing.assert_array_equal(got.elements, want.elements)


def test_metric_rejects_a_2d_batch():
    with pytest.raises(ValueError, match="1-D"):
        ttools.AverageMetric().update(torch.zeros(2, 2))


def test_pr_metric_matches_jax():
    rng = np.random.default_rng(2)
    labels, preds = rng.random((3, 5)) > 0.5, rng.random((3, 5))
    mask = rng.random((3, 5)) > 0.3
    got, want = ttools.PRMetric(), jtools.PRMetric()
    got.update(torch.from_numpy(labels), torch.from_numpy(preds), torch.from_numpy(mask))
    want.update(labels, preds, mask)
    got.update(labels[0], preds[0])
    want.update(labels[0], preds[0])
    for g, w in zip(got.compute(), want.compute()):
        _same(g, w)
    with pytest.raises(ValueError):
        got.update(labels, preds[:2])
    got.reset()
    assert got.labels == [] and got.predictions == []


def test_timer_and_benchmark_model(capsys):
    with ttools.Timer("x") as t:
        pass
    assert t.duration >= 0 and capsys.readouterr().out.startswith("[x] Elapsed: ")
    calls = []

    def fn(data):
        calls.append(1)
        return {"y": [data * 2], "s": "text"}

    out = ttools.benchmark_model(fn, torch.ones(3), r=5, warmup=2)
    assert set(out) == set(jtools.benchmark_model(lambda d: d * 2, jnp.ones(3), r=2, warmup=1))
    assert len(calls) == 7 and out["mean"] >= 0 and out["std"] >= 0


def test_get_class_and_reexports():
    """``get_class`` finds a module's one subclass as JAX's does; the AUC
    helpers are the port's eval_pipeline's."""
    mod = types.ModuleType("comet_port_get_class_probe")

    class Base:
        pass

    class Child(Base):
        pass

    Child.__module__ = mod.__name__
    mod.Child, mod.Base = Child, Base
    import sys

    sys.modules[mod.__name__] = mod
    try:
        assert ttools.get_class(mod.__name__, Base) is jtools.get_class(mod.__name__, Base) is Child
        with pytest.raises(ValueError):
            ttools.get_class(mod.__name__, int)
    finally:
        del sys.modules[mod.__name__]
    assert ttools.cal_error_auc is teval.cal_error_auc and ttools.AUCMetric is teval.AUCMetric


def test_threads_and_seeds_match_jax(monkeypatch):
    """``set_num_threads`` sets JAX's variables (and torch's pool);
    ``set_seed`` and ``fork_rng`` give the streams JAX's give."""
    n = torch.get_num_threads()
    for var in ("OPENBLAS_NUM_THREADS", "NUMEXPR_NUM_THREADS", "OMP_NUM_THREADS",
                "MKL_NUM_THREADS"):
        monkeypatch.delenv(var, raising=False)
    try:
        jtools.set_num_threads(3)
        want = {k: os.environ[k] for k in os.environ if k.endswith("_NUM_THREADS")}
        ttools.set_num_threads(3)
        assert {k: os.environ[k] for k in os.environ if k.endswith("_NUM_THREADS")} == want
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(n)
    streams = []
    for tools in (jtools, ttools):
        tools.set_seed(11)
        with tools.fork_rng(5):
            inner = (random.random(), np.random.rand())
        streams.append((inner, random.random(), np.random.rand()))
    assert streams[0] == streams[1]
    state = ttools.get_random_state()
    a = np.random.rand()
    ttools.set_random_state(state)
    assert np.random.rand() == a


# ----------------------------------------------------------------- image

_SIZE_CASES = [
    (480, 640, {"resize": 320, "side": "long"}),
    (480, 640, {"resize": 320, "side": "short"}),
    (480, 640, {"resize": 300, "side": "vert"}),
    (480, 640, {"resize": 300, "side": "horz"}),
    (480, 640, {"resize": 321, "side": "long", "edge_divisible_by": 8}),
    (731, 457, {"resize": 500, "side": "short", "edge_divisible_by": 14}),
    (48, 64, {"resize": (24, 32)}),
]


def test_new_image_sizes_match_jax():
    """The tests' cases and 50 random ones (sides, sizes, divisors)."""
    cases = list(_SIZE_CASES)
    rng = np.random.RandomState(3)
    for _ in range(50):
        conf = {"resize": int(rng.randint(64, 800)),
                "side": ["short", "long", "vert", "horz"][rng.randint(4)],
                "edge_divisible_by": [None, 8, 14][rng.randint(3)]}
        cases.append((int(rng.randint(32, 1200)), int(rng.randint(32, 1200)), conf))
    for h, w, conf in cases:
        assert (tuple(timage.ImagePreprocessor(conf).get_new_image_size(h, w))
                == tuple(jimage.ImagePreprocessor(conf).get_new_image_size(h, w))), (h, w, conf)
    with pytest.raises(ValueError):
        timage.ImagePreprocessor({"resize": 10, "side": "diag"}).get_new_image_size(5, 5)


@pytest.mark.parametrize("conf", [
    {"resize": (24, 32)},
    {"resize": 40, "side": "short", "interpolation": "bicubic"},
    {"resize": 30, "interpolation": "nearest"},
    {"resize": 30, "interpolation": "area", "antialias": False},
    {"resize": 20, "antialias": False},
    {"square_pad": True, "add_padding_mask": True},
    {"resize": 50, "side": "horz", "square_pad": True},
], ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_preprocessor_output_matches_jax(conf):
    img = np.random.RandomState(0).rand(3, 48, 64).astype(np.float32)
    for x in (img, img[0]):
        got, want = timage.ImagePreprocessor(conf)(x), jimage.ImagePreprocessor(conf)(x)
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    dc = timage.ImagePreprocessor(timage.PreprocessConf(**conf), side="long")
    assert dc.conf == timage.PreprocessConf(**{**conf, "side": "long"})


def test_image_files_match_jax(tmp_path):
    from PIL import Image

    rgb = (np.random.RandomState(1).rand(8, 9, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "im.png")
    Image.fromarray(rgb).save(path)
    for gray in (False, True):
        _same(timage.read_image(path, gray), jimage.read_image(path, gray))
        _same(timage.load_image(path, gray), jimage.load_image(path, gray))
    _same(timage.numpy_image_to_chw(rgb), jimage.numpy_image_to_chw(rgb))
    _same(timage.numpy_image_to_chw(rgb[..., 0]), jimage.numpy_image_to_chw(rgb[..., 0]))
    got = timage.ImagePreprocessor({"resize": 6}).load_image(path)
    want = jimage.ImagePreprocessor({"resize": 6}).load_image(path)
    for k in want:
        _same(got[k], want[k])
    with pytest.raises(FileNotFoundError):
        timage.read_image(str(tmp_path / "missing.png"))
    with pytest.raises(ValueError):
        timage.numpy_image_to_chw(np.zeros((1, 2, 3, 4)))


# ----------------------------------------------------------------- misc

def test_map_tensor_and_numpy_match_jax():
    nested = {"a": [np.zeros(2), None], "b": {"c": np.ones(3)}, "s": "x", "t": (np.arange(2),)}
    want = jmisc.batch_to_numpy(jmisc.map_tensor(nested, jnp.asarray))
    got = tmisc.batch_to_numpy(tmisc.map_tensor(nested, torch.from_numpy))
    assert got["a"][1] is None and got["s"] == "x" and isinstance(got["t"], tuple)
    for g, w in ((got["a"][0], want["a"][0]), (got["b"]["c"], want["b"]["c"]),
                 (got["t"][0], want["t"][0])):
        assert isinstance(g, np.ndarray)
        _same(g, w)


def test_batch_to_device_moves_every_leaf():
    batch = {"x": np.arange(3), "y": [torch.ones(2), 2.5], "name": "pair", "none": None}
    out = tmisc.batch_to_device(batch, "cpu")
    assert isinstance(out["x"], torch.Tensor) and out["x"].device.type == "cpu"
    assert isinstance(out["y"][1], torch.Tensor) and out["name"] == "pair" and out["none"] is None
    with pytest.raises(TypeError):
        tmisc.batch_to_device(batch)  # no default device


def test_rbd_and_index_batch_match_jax():
    batch = {"x": np.arange(6).reshape(2, 3), "l": [[1, 2], [3]], "name": "pair"}
    got, want = tmisc.rbd({**batch, "x": torch.from_numpy(batch["x"])}), jmisc.rbd(batch)
    _same(got["x"], want["x"])
    assert got["l"] == want["l"] and got["name"] == want["name"]
    items = {"x": np.arange(8).reshape(4, 2), "y": {"z": np.arange(4)}}
    for g, w in zip(tmisc.index_batch(items), jmisc.index_batch(items), strict=True):
        _same(g["x"], w["x"])
        _same(g["y"]["z"], w["y"]["z"])


def _views():
    rng = np.random.default_rng(0)
    return {
        "keypoints0": rng.random((2, 4, 2)), "keypoints1": rng.random((2, 4, 2)),
        "keypoints2": rng.random((2, 4, 2)), "matches0to1": rng.integers(0, 4, (2, 4)),
        "matches1to2": rng.integers(0, 4, (2, 4)), "matches2to1": rng.integers(0, 4, (2, 4)),
        "matches0to2": rng.integers(0, 4, (2, 4)), "H": rng.random((2, 3, 3)),
    }


@pytest.mark.parametrize("idx", ["0to1", "1to2", "2to1", "0to2"])
def test_views_and_twoviews_match_jax(idx):
    data = _views()
    got, want = tmisc.get_twoview(data, idx), jmisc.get_twoview(data, idx)
    assert list(got) == list(want)
    for k in want:
        _same(got[k], want[k])
    for i in (0, 1, 2):
        assert tmisc.get_view(data, i).keys() == jmisc.get_view(data, i).keys()
        assert tmisc.to_view({"kp": 1}, i) == jmisc.to_view({"kp": 1}, i)
    with pytest.raises(ValueError):
        tmisc.get_twoview(data, "0_1")


def test_stack_and_unstack_match_jax():
    data = _views()
    del data["matches2to1"]  # every pair's keys the same
    got, want = tmisc.stack_twoviews(data), jmisc.stack_twoviews(data)
    assert list(got) == list(want)
    for k in want:
        _same(got[k], want[k])
    for g, w in zip(tmisc.unstack_twoviews(got, 2).items(), jmisc.unstack_twoviews(want, 2).items()):
        assert g[0] == w[0]
        for k in w[1]:
            _same(g[1][k], w[1][k])
    # tensors stay tensors
    tensors = {idx: {"kp": torch.full((2, 3), float(i))}
               for i, idx in enumerate(["0to1", "0to2", "1to2"])}
    stacked = tmisc.stack_twoviews(tensors)
    assert isinstance(stacked["kp"], torch.Tensor) and stacked["kp"].shape == (6, 3)


# ----------------------------------------------------------------- inspect frames

def _fake_pair(seed=0, n=12):
    """tests/test_harness_tools.py's pair."""
    rng = np.random.RandomState(seed)
    data = {"image0": rng.rand(32, 40, 3).astype(np.float32),
            "image1": rng.rand(32, 40, 3).astype(np.float32), "F_0to1": np.eye(3)}
    pred = {
        "keypoints0": rng.rand(n, 2) * [40, 32], "keypoints1": rng.rand(n, 2) * [40, 32],
        "keypoint_scores0": rng.rand(n), "keypoint_scores1": rng.rand(n),
        "matches0": np.where(rng.rand(n) > 0.3, np.arange(n), -1),
        "matching_scores0": rng.rand(n), "gt_matches0": np.arange(n),
        "heatmap0": rng.rand(16, 20), "heatmap1": rng.rand(16, 20),
        "lines0": rng.rand(5, 2, 2) * 30, "lines1": rng.rand(5, 2, 2) * 30,
        "line_matches0": np.array([0, 2, -1, 1, -1]),
    }
    return data, pred


def _torch_pred(pred):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in pred.items()}


@pytest.mark.parametrize("plot", sorted(jframes.PLOT_REGISTRY))
def test_every_plot_renders_as_jax(plot):
    """Each registered plot, pixel for pixel (the port given tensors)."""
    pytest.importorskip("cv2")
    assert list(tframes.PLOT_REGISTRY) == list(jframes.PLOT_REGISTRY)
    data, pred = _fake_pair()
    got = tframes.TwoViewFrame(data, {"exp": _torch_pred(pred)}).draw(plot)["exp"]
    want = jframes.TwoViewFrame(data, {"exp": pred}).draw(plot)["exp"]
    assert got.dtype == np.uint8
    _same(got, want)


def test_frame_options_cycle_and_save_match_jax(tmp_path):
    pytest.importorskip("cv2")
    data, pred = _fake_pair(1)
    minimal = {k: pred[k] for k in ("keypoints0", "keypoints1")}
    for preds in ({"exp": minimal}, {"a": pred, "b": pred}):
        got, want = tframes.TwoViewFrame(data, preds), jframes.TwoViewFrame(data, preds)
        assert got.options == want.options and got.current == want.current
        assert [got.cycle() for _ in range(3)] == [want.cycle() for _ in range(3)]
    with pytest.raises(KeyError):
        tframes.TwoViewFrame(data, {"exp": minimal}).draw("matches")
    paths = tframes.TwoViewFrame(data, {"a": pred, "b": pred}).save(
        str(tmp_path / "t"), plots=["matches", "keypoints"])
    jpaths = jframes.TwoViewFrame(data, {"a": pred, "b": pred}).save(
        str(tmp_path / "j"), plots=["matches", "keypoints"])
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jpaths]
    import cv2

    for p, q in zip(paths, jpaths):
        _same(cv2.imread(p), cv2.imread(q))


def _canvas(fig):
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


@pytest.mark.parametrize("diff", [False, True])
def test_global_frame_matches_jax(diff):
    """The scatter's points and its rendered figure, the worst pairs and the
    pair opener."""
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    results = {"expA": {"precision": [0.9, 0.2, 0.7], "num_matches": [50, 5, 30]},
               "expB": {"precision": [0.8, 0.4, 0.6], "num_matches": [40, 9, 28]}}
    opened = []

    def opener(i):
        opened.append(i)
        return _fake_pair(seed=i)[0], {"expB": _fake_pair(seed=i)[1]}

    got = tframes.GlobalFrame(results, x="num_matches", y="precision", diff=diff,
                              pair_opener=opener)
    want = jframes.GlobalFrame(results, x="num_matches", y="precision", diff=diff)
    for name in results:
        for g, w in zip(got._xy(name), want._xy(name)):
            _same(g, w)
    for kw in ({"k": 2, "largest": False}, {"metric": "num_matches", "experiment": "expB"}):
        assert got.worst_pairs(**kw) == want.worst_pairs(**kw)
    figs = [got.figure()[0], want.figure()[0]]
    try:
        _same(_canvas(figs[0]), _canvas(figs[1]))
    finally:
        for fig in figs:
            plt.close(fig)
    child = got.open_pair(1)
    assert opened == [1] and isinstance(child, tframes.TwoViewFrame)
    assert child.title == "pair 1"
    with pytest.raises(KeyError):
        tframes.GlobalFrame(results, x="nope")
    with pytest.raises(ValueError):
        tframes.GlobalFrame({"e": {"a": [1]}})
    with pytest.raises(RuntimeError):
        tframes.GlobalFrame(results).open_pair(0)


# ----------------------------------------------------------------- names

# JAX's exported names that the port's package of the same name does not
# export, each with its reason. Empty: the port exports every one.
NAMES_ALLOWED_MISSING = {
    "models": set(),
    "ops": set(),
    "utils": set(),
    "matching": set(),
    "training": set(),
}


def _exported(module):
    return {n for n in dir(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), types.ModuleType)}


@pytest.mark.parametrize("package", sorted(NAMES_ALLOWED_MISSING))
def test_package_exports_jax_names(package):
    """JAX's exported names minus the port's is the allow-list; each name
    the port exports under JAX's name is callable or a class (or, for
    constants, a value) in both."""
    jax_pkg = importlib.import_module(f"comet_tpu.{package}")
    port_pkg = importlib.import_module(f"comet_tpu_torch.{package}")
    assert _exported(jax_pkg) - _exported(port_pkg) == NAMES_ALLOWED_MISSING[package]
    for name in _exported(jax_pkg) & _exported(port_pkg):
        assert callable(getattr(jax_pkg, name)) == callable(getattr(port_pkg, name)), name
