"""The port's matching pipelines, checkpoint readers and ``match`` CLI
against ``comet_tpu``, on the CPU, with the same weights: SuperPoint from one
flax ``.msgpack`` (each package's own random initialization cannot be
reproduced by the other), matchers from a checkpoint written by the JAX
package's ``save_experiment``. LightGlue runs at depth 2, width 64; images
are 64 x 64 with 64 keypoints.

The homography RANSAC of the port draws its samples through
``twoview.estimators.ransac_samples``; the tests replace it with the
indices JAX draws from its key (``PRNGKey(seed)``, split per hypothesis),
so the estimated homographies compare.

Tolerances: match counts, accuracy buckets and seeded query points are
equal; precision and recall within 1e-6; ``H_error_ransac`` (a corner
distance of a DLT on the same inliers) within 1e-3 relative.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu import cli as jcli
from comet_tpu.data import keypoints as jkp
from comet_tpu.matching import benchmarks as jbench
from comet_tpu.matching import configs as jconfigs
from comet_tpu.matching import experiments as jexp
from comet_tpu.matching import lightglue as jlg
from comet_tpu.models.superpoint import SuperPoint
from comet_tpu.utils.serialization import save_params_msgpack
from comet_tpu_torch import cli as tcli
from comet_tpu_torch.data import keypoints as tkp
from comet_tpu_torch.matching import benchmarks as tbench
from comet_tpu_torch.matching import configs as tconfigs
from comet_tpu_torch.matching import experiments as texp
from comet_tpu_torch.twoview import estimators as test_
from test_torch_port_twoview import _jax_samples

SIZE = 64
LG = dict(depth=2, dim=64, filter_threshold=0.0)


class _Jitted:
    """A flax module whose ``init`` and ``apply`` run under ``jax.jit`` (the
    JAX package calls them op by op, tens of seconds per shape here)."""

    def __init__(self, module):
        self.module = module
        self.init = jax.jit(module.init)
        self.apply = jax.jit(module.apply)

    def __call__(self, kpts0, desc0, kpts1, desc1, valid0=None, valid1=None):
        raise TypeError("call through apply")


@pytest.fixture(autouse=True)
def jax_jitted(monkeypatch):
    """The JAX side's SuperPoint, flax matchers, metrics and homography
    RANSAC under ``jax.jit``: the same functions, compiled once per shape."""
    import functools

    from comet_tpu.matching import extractors as jext
    from comet_tpu.twoview import estimators as jest

    from comet_tpu.models import superpoint as jsp

    for mod in (jext, jsp):  # the extractor's and detect_superpoint's
        monkeypatch.setattr(mod, "SuperPoint", lambda **kw: _Jitted(SuperPoint(**kw)))
    get_model = jconfigs.get_model

    def get_jitted(name, **conf):
        m = get_model(name, **conf)
        return _Jitted(m) if hasattr(m, "init") else m

    monkeypatch.setattr(jconfigs, "get_model", get_jitted)
    monkeypatch.setattr(jbench, "eval_matches_homography", jax.jit(
        jbench.eval_matches_homography, static_argnames="threshold"))
    monkeypatch.setattr(jest, "estimate_homography_ransac", functools.partial(jax.jit(
        jest.estimate_homography_ransac, static_argnames=("threshold", "num_hypotheses"))))


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's RANSACs draw JAX's samples of ``PRNGKey(0)``."""

    def draw(n, num_hypotheses, sample_size, generator, device, p=None):
        idx = _jax_samples(jax.random.PRNGKey(0), n, num_hypotheses, sample_size)
        return torch.as_tensor(np.array(idx), dtype=torch.long, device=device)

    monkeypatch.setattr(test_, "ransac_samples", draw)


@pytest.fixture(scope="module")
def sp_params(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sp") / "superpoint.msgpack")
    init = jax.jit(SuperPoint(max_keypoints=8).init)
    save_params_msgpack(path, init(jax.random.PRNGKey(5), np.zeros((16, 16), np.float32)))
    return path


@pytest.fixture(scope="module")
def lg_experiment(tmp_path_factory):
    """A JAX save_experiment directory of a depth-2 LightGlue over
    SuperPoint's 256-d descriptors, optimizer state included, at steps 2
    and 3 (the best is step 2's)."""
    import optax

    exp_dir = str(tmp_path_factory.mktemp("lg_exp"))
    m = jlg.LightGlueMatcher(**LG)
    k, d = jnp.zeros((8, 2)), jnp.zeros((8, 256))
    init = jax.jit(m.init)
    best = None
    for step, seed, loss in ((2, 1, 0.4), (3, 2, 0.5)):
        params = init(jax.random.PRNGKey(seed), k, d, k, d)
        _, best = jexp.save_experiment(exp_dir, step, params, optax.adam(1e-3).init(params),
                                       conf={"experiment": "superpoint+lightglue_homography"},
                                       loss=loss, best_eval=best)
    return exp_dir


def _same_row(got, want):
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if w is None or g is None:
            assert g is None and w is None, key
        elif key.startswith("H_error"):
            np.testing.assert_allclose(g, w, rtol=1e-3, err_msg=key)
        elif key.startswith(("prec", "recall")):
            np.testing.assert_allclose(g, w, atol=1e-6, err_msg=key)
        else:
            assert g == w, key


def test_match_list_prints_the_jax_names(capsys):
    jcli.main(["match", "--list"])
    want = capsys.readouterr().out
    tcli.main(["match", "--list", "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and len(got.split()) == 11


@pytest.mark.parametrize("estimator", ["dlt", "ransac"])
def test_benchmark_row_matches_jax(sp_params, jax_draws, estimator):
    """run_homography_benchmark of superpoint+nn on the same pairs and
    SuperPoint weights: the same row (the RANSAC fed JAX's samples)."""
    over = dict(extractor={"params_path": sp_params, "max_keypoints": SIZE})
    jpipe = jconfigs.build_pipeline("superpoint+nn", (SIZE, SIZE), **copy.deepcopy(over))
    tpipe = tconfigs.build_pipeline("superpoint+nn", (SIZE, SIZE), **copy.deepcopy(over))
    want = jbench.run_homography_benchmark(jpipe, jbench.make_synthetic_pairs(2, (SIZE, SIZE), 1),
                                           estimator=estimator)
    got = tbench.run_homography_benchmark(
        tpipe, tbench.make_synthetic_pairs(2, (SIZE, SIZE), 1, device="cpu"), estimator=estimator)
    assert want["num_matches"] > 10
    _same_row(got, want)


def test_checkpoint_readers_match_jax(lg_experiment):
    assert sorted(texp.list_checkpoints(lg_experiment)) == sorted(
        jexp.list_checkpoints(lg_experiment))
    assert texp.get_last_checkpoint(lg_experiment) == jexp.get_last_checkpoint(lg_experiment)
    assert texp.get_best_checkpoint(lg_experiment) == jexp.get_best_checkpoint(lg_experiment)
    for get_last in (False, True):
        tree, meta = texp.load_checkpoint(lg_experiment, get_last=get_last)
        jtree, jmeta = jexp.load_checkpoint(lg_experiment, get_last=get_last)
        assert meta == jmeta and meta["step"] == (3 if get_last else 2)
        flat = jax.tree_util.tree_leaves_with_path(jtree["params"])
        got = dict(jax.tree_util.tree_leaves_with_path(tree["params"]))
        assert len(flat) == len(got)
        for path, leaf in flat:
            np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))
        assert "opt" in tree
    with pytest.raises(FileNotFoundError):
        texp.get_last_checkpoint(lg_experiment + "/nothing")


def test_match_load_experiment_prints_jax_row(sp_params, lg_experiment, jax_draws, monkeypatch,
                                              capsys):
    """``match --experiment superpoint+lightglue_homography --load-experiment
    DIR`` with a SuperPoint params_path: the same printed lines as JAX's
    (the experiment's LightGlue cut to depth 2 and its filter threshold to
    0, so that random weights match points)."""
    name = "superpoint+lightglue_homography"
    for configs in (jconfigs, tconfigs):
        exp = copy.deepcopy(configs.EXPERIMENTS[name])
        exp["extractor"].update(params_path=sp_params, max_keypoints=SIZE)
        exp["matcher"].update(LG)
        monkeypatch.setitem(configs.EXPERIMENTS, name, exp)
    argv = ["match", "--experiment", name, "--load-experiment", lg_experiment, "--n-pairs", "2",
            "--image-size", str(SIZE)]
    jcli.main(argv)
    want = capsys.readouterr().out.splitlines()
    tcli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] == "loaded checkpoint (step 2, loss 0.4)"
    row, jrow = json.loads(got[-1]), json.loads(want[-1])
    assert jrow["num_matches"] > 10
    _same_row(row, jrow)


@pytest.mark.parametrize("option,item", [
    (["--pipeline", "hpatches"], "7b"), (["--pipeline", "relpose"], "7b"),
    (["--export-features", "."], "7b"), (["--inspect", "2"], "7f"),
])
def test_unported_match_options_raise(option, item, tmp_path, monkeypatch, capsys):
    """The options that raised until ROADMAP Queue 1 items 7b and 7f were
    ported now work as JAX's do, on the same inputs (JAX's RANSAC samples
    replayed): ``--pipeline hpatches`` and ``relpose`` print JAX's row
    (``torch_port_line_helpers.same_pipeline_row``) and write the files JAX
    reads; ``--export-features`` (over a directory of images) writes the
    features JAX's ``cache_loader`` reads back; ``--inspect 2`` after a
    ``--pipeline hpatches`` run draws JAX's PNGs."""
    import os

    import cv2
    from PIL import Image

    from comet_tpu.matching import eval_pipeline as jep
    from comet_tpu.matching import registry as jreg
    from comet_tpu_torch.matching import eval_pipeline as tep
    from comet_tpu_torch.matching import registry as treg
    from torch_port_line_helpers import jax_draws as draws
    from torch_port_line_helpers import jit_jax_matching, same_pipeline_row

    jit_jax_matching(monkeypatch)
    draws(monkeypatch)
    argv = ["match", "--n-pairs", "1", "--image-size", str(SIZE)]
    if option[0] == "--export-features":
        images = tmp_path / "images"
        images.mkdir()
        rng = np.random.default_rng(2)
        for i in range(2):
            img = (tbench.synthetic_texture(rng, 80, 72)[..., 0] * 255).astype(np.uint8)
            Image.fromarray(img).save(images / f"im{i}.png")
        argv += ["--experiment", "sift+nn", "--export-features", str(images)]
    elif option[0] == "--inspect":
        argv += ["--pipeline", "hpatches", *option]
    else:
        argv += option
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcli.main(argv + ["--exp-dir", jdir])
    want = capsys.readouterr().out.splitlines()
    tcli.main(argv + ["--exp-dir", tdir, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    row, jrow = json.loads(got[-1]), json.loads(want[-1])
    assert len(got) == len(want)
    if option[0] == "--export-features":
        assert row["exported"] == jrow["exported"] == 2 and row["path"].startswith(tdir)
        for name in ("im0", "im1"):
            loaded = [reg.get_model("cache_loader", path=os.path.join(d, "features.h5"))(
                {"name": name}) for reg, d in ((jreg, tdir), (treg, jdir))]
            assert loaded[0].keys() == loaded[1].keys() == {"keypoints", "descriptors", "scores"}
            for k in loaded[0]:
                np.testing.assert_allclose(loaded[0][k], loaded[1][k], rtol=0, atol=1e-5,
                                           err_msg=k)
        return
    assert row["pipeline"] == jrow["pipeline"] and row["exp_dir"] == tdir
    same_pipeline_row(row, jrow, skip=("exp_dir",))
    names = list(jep.load_eval(jdir)[1]["names"])
    for name in names:  # each reads the other's prediction cache
        a = jep.load_predictions(os.path.join(tdir, "predictions.h5"), name)
        b = tep.load_predictions(os.path.join(jdir, "predictions.h5"), name)
        assert a.keys() == b.keys() and all(a[k].dtype == b[k].dtype for k in a)
    if option[0] == "--inspect":
        assert got[0].replace(tdir, jdir) == want[0]
        drawn = sorted(os.listdir(os.path.join(tdir, "inspect")))
        assert drawn == sorted(os.listdir(os.path.join(jdir, "inspect"))) and drawn
        for f in drawn:
            np.testing.assert_array_equal(cv2.imread(os.path.join(tdir, "inspect", f)),
                                          cv2.imread(os.path.join(jdir, "inspect", f)))


@pytest.mark.parametrize("experiment,item", [("superpoint+lsd+gluestick", "7d"),
                                             ("deeplsd+gluestick", "7d")])
def test_unported_experiments_raise(experiment, item, tmp_path, monkeypatch, capsys):
    """The two line experiments, which raised until ROADMAP Queue 1 item 7d
    was ported, print JAX's row on the same pair with the same SuperPoint,
    DeepLSD and GlueStick weights (cut to 64 keypoints, 8 lines, depth 2,
    width 32; ``torch_port_line_helpers.line_experiment``), JAX's RANSAC
    samples replayed."""
    from torch_port_line_helpers import jax_draws as draws
    from torch_port_line_helpers import jit_jax_matching, line_experiment

    jit_jax_matching(monkeypatch)
    draws(monkeypatch)
    ckpt = line_experiment(monkeypatch, tmp_path, experiment, SIZE)
    argv = ["match", "--experiment", experiment, "--n-pairs", "1", "--image-size", str(SIZE),
            "--load-experiment", ckpt]
    jcli.main(argv)
    want = capsys.readouterr().out.splitlines()
    tcli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0]
    row, jrow = json.loads(got[-1]), json.loads(want[-1])
    assert jrow["num_matches"] > 0
    _same_row(row, jrow)


def test_match_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["match", "--experiment", "sift+nn", "--n-pairs", "1"])


def test_superpoint_seeding_matches_jax(sp_params):
    """seed_query_points(backend="superpoint", superpoint_params=...) on a
    normalized frame: the same query points as JAX's."""
    rgb = np.stack([tbench.synthetic_texture(np.random.default_rng(s), SIZE, SIZE)[..., 0]
                    for s in (1, 2, 3)], -1)
    frame = (rgb - tkp._IMAGENET_MEAN) / tkp._IMAGENET_STD
    mask = np.zeros((SIZE, SIZE), bool)
    mask[8:56, 10:60] = True
    kw = dict(track_num=64, min_pts=32, backend="superpoint", superpoint_params=sp_params)
    want = jkp.seed_query_points(frame, mask, rng=np.random.default_rng(4), **kw)
    got = tkp.seed_query_points(frame, mask, rng=np.random.default_rng(4), device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    sp = tkp.detect_superpoint(tkp.denormalize_image(frame), 64, sp_params, device="cpu")
    np.testing.assert_array_equal(sp, jkp.detect_superpoint(tkp.denormalize_image(frame), 64,
                                                            sp_params))
    assert len(sp) > 0
