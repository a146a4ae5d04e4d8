"""The port's point-matching modules against ``comet_tpu.matching`` and
``comet_tpu.models.superpoint``, on the CPU, on the same numpy inputs from a
seed and the same weights (JAX's flax trees carried across by
``weights.module_params_from_jax``), at small sizes: 64 x 96 images, 32-64
keypoints, LightGlue and SuperGlue at depth 2 and width 64.

Tolerances (f32):

- ``EXACT``: integer outputs (keypoint positions, matches, labels, stop
  layers, prune counts, tie orders) are equal;
- ``OP``: 1e-5 for a few elementwise or small-sum ops (blur, sampling,
  metrics, texture, warps);
- ``NET``: 1e-4 for network outputs through several f32 matmuls and
  convolutions (descriptors, heatmaps, log assignments, Sinkhorn).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu.matching import benchmarks as jbench
from comet_tpu.matching import eval as jeval
from comet_tpu.matching import gt_generation as jgt
from comet_tpu.matching import lightglue as jlg
from comet_tpu.matching import matchers as jmatchers
from comet_tpu.matching import registry as jreg
from comet_tpu.matching import sift as jsift
from comet_tpu.matching import superglue as jsg
from comet_tpu.models import superpoint as jsp
from comet_tpu.ops import bilinear as jbil
from comet_tpu_torch import matching as tm
from comet_tpu_torch.matching import benchmarks as tbench
from comet_tpu_torch.matching import eval as teval
from comet_tpu_torch.matching import gt_generation as tgt
from comet_tpu_torch.matching import lightglue as tlg
from comet_tpu_torch.matching import sift as tsift
from comet_tpu_torch.matching import superglue as tsg
from comet_tpu_torch.models import superpoint as tsp
from comet_tpu_torch.ops import bilinear as tbil
from comet_tpu_torch.weights import module_params_from_jax

REPO = Path(__file__).resolve().parents[1]
OP = 1e-5
NET = 1e-4
H, W = 64, 96


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _n(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol):
    got, want = _n(got).astype(np.float64), _n(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * max(np.abs(want).max(), 1.0), rtol=0)


def _equal(got, want):
    np.testing.assert_array_equal(_n(got), _n(want))


def _port(jax_vars, module):
    module.load_state_dict(module_params_from_jax(jax_vars, module))
    return module.eval()


@pytest.fixture(scope="module")
def texture():
    return tbench.synthetic_texture(np.random.default_rng(5), H, W)[..., 0]


# ------------------------------------------------------------ tie orders

def test_top_k_keeps_jax_tie_order():
    """Equal scores: the lowest index first, as jax.lax.top_k, where
    torch.topk's order is unspecified."""
    flat = np.zeros(1024, np.float32)
    flat[[3, 5, 700]] = [0.9, 0.5, 0.5]
    flat[::97] = np.maximum(flat[::97], 0.25)
    values, idx = tsp.top_k(_t(flat), 64)
    jv, ji = jax.lax.top_k(jnp.asarray(flat), 64)
    _equal(idx, ji)
    _equal(values, jv)


def test_matcher_metrics_argsort_is_stable():
    """matcher_metrics ranks by a stable descending sort (jnp.argsort):
    scores made of ties give JAX's AP."""
    rng = np.random.default_rng(0)
    m = rng.integers(-1, 8, (3, 40))
    gt = np.where(rng.random((3, 40)) < 0.6, m, rng.integers(-2, 8, (3, 40)))
    scores = rng.integers(0, 3, (3, 40)).astype(np.float32) / 2  # three levels: ties
    got = teval.matcher_metrics(_t(m, torch.long), _t(gt, torch.long), _t(scores), "v/")
    want = jeval.matcher_metrics(jnp.asarray(m), jnp.asarray(gt), jnp.asarray(scores), "v/")
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], OP)


# ------------------------------------------------------------ the ops

@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_bilinear_sample_matches_jax(padding_mode):
    rng = np.random.default_rng(1)
    fmap = rng.normal(size=(9, 13, 5)).astype(np.float32)
    pts = rng.uniform(-3, 15, (4, 7, 2)).astype(np.float32)
    got = tbil.bilinear_sample(_t(fmap), _t(pts), padding_mode)
    _close(got, jbil.bilinear_sample(jnp.asarray(fmap), jnp.asarray(pts), padding_mode), OP)


def test_mutual_nearest_neighbor_and_rotary_match_jax():
    rng = np.random.default_rng(2)
    d0 = rng.normal(size=(40, 16)).astype(np.float32)
    d1 = rng.normal(size=(50, 16)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d1[7] = d1[3]  # an exact tie: the lowest index wins on both sides
    v0, v1 = rng.random(40) > 0.2, rng.random(50) > 0.2
    for kw in (dict(), dict(valid0=v0, valid1=v1), dict(threshold=0.3)):
        got = tm.mutual_nearest_neighbor(_t(d0), _t(d1), **{
            k: (_t(v, torch.bool) if k.startswith("valid") else v) for k, v in kw.items()})
        want = jmatchers.mutual_nearest_neighbor(jnp.asarray(d0), jnp.asarray(d1), **{
            k: (jnp.asarray(v) if k.startswith("valid") else v) for k, v in kw.items()})
        _equal(got["matches0"], want["matches0"])
        _close(got["scores0"], want["scores0"], OP)
    kp = rng.uniform(-1, 1, (40, 2)).astype(np.float32)
    _close(tm.rotary_encode(_t(d0), _t(kp), 4), jmatchers.rotary_encode(jnp.asarray(d0),
                                                                         jnp.asarray(kp), 4), OP)


def test_matcher_nn_ignores_valid_like_jax():
    """The registered matcher_nn passes no validity masks (the reference's
    quirk, copied): an invalid keypoint is matched like any other."""
    rng = np.random.default_rng(3)
    d = rng.normal(size=(20, 8)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    valid = np.ones(20, bool)
    valid[:5] = False
    f = {"descriptors": _t(d), "valid": _t(valid, torch.bool)}
    jf = {"descriptors": jnp.asarray(d), "valid": jnp.asarray(valid)}
    got = tm.get_model("matcher_nn")(f, f)
    want = jreg.get_model("matcher_nn")(jf, jf)
    _equal(got["matches0"], want["matches0"])
    assert (got["matches0"][:5] == torch.arange(5)).all()  # invalid points matched to themselves


# ------------------------------------------------------------ SuperPoint

@pytest.fixture(scope="module")
def superpoint(texture):
    model = jsp.SuperPoint(max_keypoints=512)
    jvars = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(texture))
    port = _port(jvars, tsp.SuperPoint(max_keypoints=512))
    return model, jvars, port


def test_superpoint_matches_jax(texture, superpoint):
    """512 keypoints on a 64 x 96 image: every position equal, including the
    ~400 zero-score slots that JAX's top-k fills in index order; scores and
    descriptors within NET."""
    model, jvars, port = superpoint
    want = jax.jit(model.apply)(jvars, jnp.asarray(texture))
    with torch.no_grad():
        got = port(_t(texture))
    assert int((np.asarray(want.scores) == 0).sum()) > 300
    _equal(got.keypoints, want.keypoints)
    _close(got.scores, want.scores, NET)
    _close(got.descriptors, want.descriptors, NET)


def test_superpoint_pieces_match_jax(texture, superpoint):
    model, jvars, port = superpoint
    backbone = jsp.SuperPointBackbone()
    bvars = {"params": jvars["params"]["backbone"]}
    semi, desc = jax.jit(backbone.apply)(bvars, jnp.asarray(texture)[None, ..., None])
    with torch.no_grad():
        tsemi, tdesc = port.backbone(_t(texture)[None, None])
    _close(tsemi, semi, NET)
    _close(tdesc, desc, NET)
    heat = np.asarray(jsp.scores_from_semi(semi))
    _close(tsp.scores_from_semi(tsemi), heat, NET)
    _equal(tsp.simple_nms(_t(heat), 3), jsp.simple_nms(jnp.asarray(heat), 3))
    kps, sc = tsp.extract_keypoints(_t(heat[0]), 40, 0.01, 3, 6)
    jk, js = jsp.extract_keypoints(jnp.asarray(heat[0]), 40, 0.01, 3, 6)
    _equal(kps, jk)
    _equal(sc, js)
    pts = np.random.default_rng(4).uniform(0, 60, (30, 2)).astype(np.float32)
    _close(tsp.sample_descriptors(tdesc[0], _t(pts)),
           jsp.sample_descriptors(desc[0], jnp.asarray(pts)), NET)


# ------------------------------------------------------------ SIFT

def test_sift_matches_jax(texture):
    """The DoG detector and upright SIFT descriptors: keypoints equal,
    descriptors within NET (each a normalized histogram of ~10^3 terms)."""
    got = tsift.extract_sift(_t(texture), 128)
    want = jax.jit(lambda x: jsift.extract_sift(x, 128))(jnp.asarray(texture))
    _equal(got["keypoints"], want["keypoints"])
    _close(got["scores"], want["scores"], OP)
    _equal(got["valid"], want["valid"])
    _close(got["descriptors"], want["descriptors"], NET)
    rgb = np.stack([texture, texture ** 2, 1 - texture], -1)
    _equal(tm.get_model("extractor_sift", max_keypoints=64)(_t(rgb))["keypoints"],
           jax.jit(jreg.get_model("extractor_sift", max_keypoints=64))(
               jnp.asarray(rgb))["keypoints"])


def test_sift_pieces_match_jax(texture):
    """The blur (edge padding), the gradient's one-sided edges and the
    truncating cast of the keypoint position."""
    for sigma in (0.5, 1.6, 4.5):
        _close(tsift.gaussian_blur(_t(texture), sigma),
               jax.jit(jsift.gaussian_blur, static_argnums=1)(jnp.asarray(texture), sigma), OP)
    kps, sc = tsift.dog_keypoints(_t(texture), 200, num_scales=4, threshold=0.002, border=5)
    jk, js = jax.jit(lambda x: jsift.dog_keypoints(x, 200, num_scales=4, threshold=0.002,
                                                   border=5))(jnp.asarray(texture))
    _equal(kps, jk)
    _close(sc, js, OP)
    pts = np.random.default_rng(6).uniform(-4, 100, (30, 2)).astype(np.float32)
    pts[:4] = [[0.9, 0.2], [95.7, 63.9], [3.5, 60.0], [10.0, 10.0]]
    _close(tsift.sift_descriptors(_t(texture), _t(pts)),
           jax.jit(jsift.sift_descriptors)(jnp.asarray(texture), jnp.asarray(pts)), NET)


# ------------------------------------------------------------ GT and metrics

@pytest.fixture(scope="module")
def two_views():
    rng = np.random.default_rng(7)
    hmat = tbench.random_homography(rng, H, W).astype(np.float32)
    k0 = rng.uniform(0, [W, H], (48, 2)).astype(np.float32)
    proj = np.asarray(jgt.warp_homography(jnp.asarray(k0), jnp.asarray(hmat)))
    k1 = np.concatenate([proj[:30] + rng.normal(0, 1.5, (30, 2)),
                         rng.uniform(0, [W, H], (20, 2))]).astype(np.float32)
    m0 = np.where(rng.random(48) < 0.7, rng.integers(0, 50, 48), -1)
    m0[:30] = np.where(rng.random(30) < 0.8, np.arange(30), m0[:30])
    return hmat, k0, k1, m0


def test_gt_generation_matches_jax(two_views):
    hmat, k0, k1, _ = two_views
    got = tgt.gt_matches_from_homography(_t(k0), _t(k1), _t(hmat), 3.0, 6.0)
    want = jgt.gt_matches_from_homography(jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(hmat))
    _equal(got["matches0"], want["matches0"])
    _equal(got["matches1"], want["matches1"])
    _close(got["distances"], want["distances"], OP)
    e = np.array([[0, -0.2, 0.1], [0.2, 0, -1.0], [-0.1, 1.0, 0]], np.float32)
    kk = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
    got = tgt.gt_matches_from_pose(_t(k0), _t(k1), _t(e), _t(kk), _t(kk), 0.05, 0.2)
    want = jgt.gt_matches_from_pose(*(jnp.asarray(a) for a in (k0, k1, e, kk, kk)), 0.05, 0.2)
    _equal(got["matches0"], want["matches0"])
    _equal(got["matches1"], want["matches1"])
    _close(got["distances"], want["distances"], OP)
    assert set(np.unique(_n(got["matches0"]))) & {-2, -1}


def test_eval_metrics_match_jax(two_views):
    hmat, k0, k1, m0 = two_views
    got = teval.eval_matches_homography(_t(k0), _t(k1), _t(m0, torch.long), _t(hmat), 3.0)
    want = jeval.eval_matches_homography(jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(m0),
                                         jnp.asarray(hmat), 3.0)
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], OP)
    gt = np.asarray(jgt.gt_matches_from_homography(jnp.asarray(k0), jnp.asarray(k1),
                                                   jnp.asarray(hmat))["matches0"])
    scores = np.random.default_rng(8).random(48).astype(np.float32)
    tp, fp, sc, npos = teval.get_tp_fp_pts(_t(m0, torch.long), _t(gt, torch.long), _t(scores))
    for g, w in zip((tp, fp, sc, npos), jeval.get_tp_fp_pts(m0, gt, scores)):
        _equal(g, w)
    results = {"tp": [tp, tp[:3]], "fp": [fp, fp[:3]], "scores": [sc, sc[:3]], "num_pos": 2 * npos}
    got, want = teval.aggregate_pr_results(results), jeval.aggregate_pr_results(results)
    for k in want:
        _close(got[k], want[k], 0)
    assert teval.average_precision(got["curve_recall"], got["curve_precision"]) == \
        jeval.average_precision(got["curve_recall"], got["curve_precision"])


# ------------------------------------------------------------ the benchmark's data

def test_synthetic_texture_matches_jax_cubic():
    """The texture's cubic upsampling (Keys a = -0.5, renormalized at the
    borders: jax.image.resize, not torch's bicubic) within OP of JAX's
    whole texture; the rng stream stays in step (the blobs land alike)."""
    for h, w in ((H, W), (120, 160), (48, 48)):
        got = tbench.synthetic_texture(np.random.default_rng(11), h, w)
        want = jbench.synthetic_texture(np.random.default_rng(11), h, w)
        assert got.dtype == want.dtype == np.float32
        _close(got, want, OP)
    base = np.random.default_rng(12).normal(size=(8, 8, 1)).astype(np.float32)
    _close(tbench.resize_cubic(base, 64, 64),
           jax.image.resize(jnp.asarray(base), (64, 64, 1), "cubic"), OP)
    bicubic = torch.nn.functional.interpolate(_t(base).permute(2, 0, 1)[None], (64, 64),
                                              mode="bicubic")[0].permute(1, 2, 0)
    assert np.abs(_n(bicubic) - np.asarray(
        jax.image.resize(jnp.asarray(base), (64, 64, 1), "cubic"))).max() > 1e-2


def test_synthetic_pairs_match_jax():
    """make_synthetic_pairs: the same homographies, images and warps as
    JAX's for the seed, within OP (an f32 inverse and bilinear taps)."""
    got = tbench.make_synthetic_pairs(3, (H, W), seed=4, device="cpu")
    want = jbench.make_synthetic_pairs(3, (H, W), seed=4)
    for (g0, g1, gh), (w0, w1, wh) in zip(got, want):
        _close(gh, wh, 0)
        _close(g0, w0, OP)
        _close(g1, w1, OP)
    hest = _n(got[0][2]) + np.float32(1e-3)
    _close(tbench.homography_corner_error(_t(hest), got[0][2], (H, W)),
           jbench.homography_corner_error(jnp.asarray(hest), want[0][2], (H, W)), OP)


# ------------------------------------------------------------ LightGlue

def _lg_inputs(seed, m=40, n=36, d=32):
    rng = np.random.default_rng(seed)
    k0 = rng.uniform(-1, 1, (m, 2)).astype(np.float32)
    k1 = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    d0 = rng.normal(size=(m, d)).astype(np.float32)
    d1 = np.concatenate([d0[:20] + 0.1 * rng.normal(size=(20, d)),
                         rng.normal(size=(n - 20, d))]).astype(np.float32)
    v0 = np.ones(m, bool)
    v1 = np.ones(n, bool)
    v0[-4:] = False
    v1[-3:] = False
    return k0, d0, k1, d1, v0, v1


def _adaptive_biases(jvars, depth):
    """Token-confidence and matchability biases that make the adaptive path
    act: layer 0 partly confident, layer 1 all confident (stop), and
    matchabilities near 1 - width_confidence (prune)."""
    p = jax.tree_util.tree_map(np.array, jvars["params"])
    for i in range(depth - 1):
        p[f"token_confidence_{i}"]["token"]["bias"][:] = 1.8 if i == 0 else 12.0
        p[f"log_assignment_{i}"]["matchability"]["bias"][:] = -4.6
    return {"params": p}


@pytest.fixture(scope="module")
def lightglue():
    k0, d0, k1, d1, v0, v1 = _lg_inputs(9)
    jm = jlg.LightGlueMatcher(depth=3, dim=64, num_heads=4)
    return jax.jit(jm.init)(jax.random.PRNGKey(2), *(jnp.asarray(a) for a in (k0, d0, k1, d1)))


LG_KEYS = ("matches0", "matches1", "stop_layer", "prune0", "prune1")


@pytest.mark.parametrize("adaptive", [None, (0.95, -1.0), (-1.0, 0.99), (0.95, 0.99)],
                         ids=["off", "depth", "width", "both"])
def test_lightglue_matches_jax(lightglue, adaptive):
    """The whole matcher, adaptivity off and at depth / width confidence
    0.95 / 0.99 with biases that stop it and prune points: matches,
    stop_layer and prune0/1 equal, scores and the log assignment within NET."""
    k0, d0, k1, d1, v0, v1 = _lg_inputs(9)
    conf = dict(depth=3, dim=64, num_heads=4)
    jvars = lightglue
    if adaptive:
        conf.update(depth_confidence=adaptive[0], width_confidence=adaptive[1])
        jvars = _adaptive_biases(jvars, 3)
    jm = jlg.LightGlueMatcher(**conf)
    want = jax.jit(jm.apply)(jvars, *(jnp.asarray(a) for a in (k0, d0, k1, d1)),
                             valid0=jnp.asarray(v0), valid1=jnp.asarray(v1))
    port = _port(jvars, tlg.LightGlueMatcher(**conf, in_dim=32))
    with torch.no_grad():
        got = port(*(_t(a) for a in (k0, d0, k1, d1)), valid0=_t(v0, torch.bool),
                   valid1=_t(v1, torch.bool))
    assert set(got) == set(want)
    for k in LG_KEYS:
        _equal(got[k], want[k])
    for k in ("scores0", "scores1", "log_assignment", "assignment", "matchability0",
              "matchability1"):
        _close(got[k], want[k], NET)
    if adaptive and adaptive[0] > 0:
        assert int(want["stop_layer"]) == 2
    if adaptive and adaptive[1] > 0:
        assert (np.asarray(want["prune0"])[v0] < int(want["stop_layer"])).any()


def test_lightglue_pieces_match_jax():
    rng = np.random.default_rng(10)
    kp = rng.uniform(0, 90, (10, 2)).astype(np.float32)
    _close(tlg.normalize_keypoints(_t(kp), (96, 64)),
           jlg.normalize_keypoints(jnp.asarray(kp), (96, 64)), OP)
    x = rng.normal(size=(5, 2, 8)).astype(np.float32)
    _close(tlg.rotate_half(_t(x)), jlg.rotate_half(jnp.asarray(x)), 0)
    sim = rng.normal(size=(6, 7)).astype(np.float32)
    z0, z1 = rng.normal(size=(6, 1)).astype(np.float32), rng.normal(size=(7, 1)).astype(np.float32)
    v0, v1 = np.arange(6) < 5, np.arange(7) != 2
    la = tlg.sigmoid_log_double_softmax(_t(sim), _t(z0), _t(z1), _t(v0, torch.bool),
                                        _t(v1, torch.bool))
    jla = jlg.sigmoid_log_double_softmax(*(jnp.asarray(a) for a in (sim, z0, z1, v0, v1)))
    _close(la, jla, OP)
    for g, w in zip(tlg.filter_matches(la, 0.01, _t(v0, torch.bool), _t(v1, torch.bool)),
                    jlg.filter_matches(jla, 0.01, jnp.asarray(v0), jnp.asarray(v1))):
        _close(g, w, OP)
    assert all(tlg.confidence_threshold(i, 9) == jlg.confidence_threshold(i, 9) for i in range(9))


# ------------------------------------------------------------ SuperGlue

def test_superglue_matches_jax():
    """SuperGlue at depth 2, width 64, 50 Sinkhorn iterations, with and
    without detector scores (the pipeline passes none: scores of 1)."""
    k0, d0, k1, d1, v0, v1 = _lg_inputs(12)
    rng = np.random.default_rng(13)
    s0, s1 = rng.random(40).astype(np.float32), rng.random(36).astype(np.float32)
    conf = dict(depth=2, dim=64, sinkhorn_iters=50, filter_threshold=0.01)
    jm = jsg.SuperGlueMatcher(**conf)
    args = [jnp.asarray(a) for a in (k0, d0, k1, d1)]
    jvars = jax.jit(jm.init)(jax.random.PRNGKey(3), *args)
    port = _port(jvars, tsg.SuperGlueMatcher(**conf, in_dim=32))
    targs = [_t(a) for a in (k0, d0, k1, d1)]
    for kw in (dict(valid0=v0, valid1=v1), dict(scores0=s0, scores1=s1, valid0=v0, valid1=v1)):
        want = jax.jit(jm.apply)(jvars, *args, **{k: jnp.asarray(v) for k, v in kw.items()})
        with torch.no_grad():
            got = port(*targs, **{k: _t(v, torch.bool if k.startswith("valid") else torch.float32)
                                  for k, v in kw.items()})
        _equal(got["matches0"], want["matches0"])
        for k in ("scores0", "assignment", "log_assignment"):
            _close(got[k], want[k], NET)
    sim = rng.normal(size=(6, 5)).astype(np.float32)
    got = tsg.log_sinkhorn(_t(sim), torch.tensor(0.5), 20, _t(np.arange(6) < 4, torch.bool))
    _close(got, jsg.log_sinkhorn(jnp.asarray(sim), jnp.asarray(0.5), 20,
                                 jnp.asarray(np.arange(6) < 4)), OP)


# ------------------------------------------------------------ weights, registry, imports

def test_module_params_from_jax_fills_every_parameter(lightglue):
    """Every parameter of SuperPoint, LightGlue, SuperGlue and PoseEmbedding
    comes from JAX's tree; an extra leaf or a wrong shape raises."""
    from comet_tpu.models import blocks as jblocks
    from comet_tpu_torch.models import blocks as tblocks

    def tree(module, *args):  # shapes only: zeros in the shapes init would give
        shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
        return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)

    x = jnp.zeros((4, 8))
    sg = tree(jsg.SuperGlueMatcher(depth=1, dim=32), x[:, :2], x, x[:, :2], x)
    pe = tree(jblocks.PoseEmbedding(target_dim=16), x)
    sp = tree(jsp.SuperPoint(max_keypoints=8), jnp.zeros((16, 16)))
    for tree, module in ((lightglue, tlg.LightGlueMatcher(depth=3, dim=64, in_dim=32)),
                         (sg, tsg.SuperGlueMatcher(depth=1, dim=32, in_dim=8)),
                         (pe, tblocks.PoseEmbedding(8, target_dim=16)),
                         (sp, tsp.SuperPoint())):
        sd = module_params_from_jax(tree, module)
        assert set(sd) == set(module.state_dict())
    bad = jax.tree_util.tree_map(np.array, lightglue)
    bad["params"]["extra"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="no such port parameter"):
        module_params_from_jax(bad, tlg.LightGlueMatcher(depth=3, dim=64, in_dim=32))
    with pytest.raises(ValueError, match="shape"):
        module_params_from_jax(lightglue, tlg.LightGlueMatcher(depth=3, dim=64, in_dim=16))


@pytest.mark.parametrize("name", ["extractor_wireframe", "matcher_gluestick"])
def test_unported_models_keep_their_names_and_raise(name, monkeypatch):
    """The two models that raised until the line slice keep their names,
    take JAX's default configuration and now run as JAX's do: the wireframe
    (SIFT and the LSD stand-in, 32 keypoints, 8 lines) on a 48 x 48 image,
    the JAX side given the port's segments (the detector is held to JAX in
    ``test_torch_port_lines.py``), every output within 1e-5; GlueStick
    (depth 1, width 16) with JAX's weights, its log assignments within 1e-4
    and its matches equal."""
    from comet_tpu.matching import gluestick as jgs
    from comet_tpu.matching import lines as jlines
    from comet_tpu_torch.matching import lines as tlines

    assert name in tm.list_models() and tm.registry._DEFAULTS[name] == jreg._DEFAULTS[name]
    rng = np.random.default_rng(3)
    if name == "extractor_wireframe":
        gray = tbench.synthetic_texture(rng, 48, 48)[..., 0]
        gray[10:30, 12:40] = 0.8

        def port_segments(g, max_lines):
            segs = tlines.detect_line_segments(torch.as_tensor(np.asarray(g)), max_lines=max_lines)
            return jlines.LineSegments(*(jnp.asarray(a.numpy()) for a in segs))

        monkeypatch.setattr(jlines, "detect_line_segments", port_segments)
        monkeypatch.setattr(jsift, "extract_sift", jax.jit(
            jsift.extract_sift, static_argnames=("max_keypoints", "threshold")))
        conf = dict(point_conf={"max_keypoints": 32}, max_lines=8)
        want = jreg.get_model(name, **conf)(jnp.asarray(gray))
        got = tm.get_model(name, **conf, device="cpu")(gray)
        assert set(got) == set(want) and int(want["line_valid"].sum()) >= 1
        for k, w in want.items():
            w = np.asarray(w, np.float64)
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                       atol=1e-5 * max(np.abs(w).max(initial=0), 1), err_msg=k)
        return
    conf = dict(depth=1, dim=16, filter_threshold=0.0)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    inp = dict(kpts0=f32(rng.uniform(-1, 1, (12, 2))), desc0=f32(rng.normal(size=(12, 8))),
               kpts1=f32(rng.uniform(-1, 1, (10, 2))), desc1=f32(rng.normal(size=(10, 8))),
               lines0=f32(rng.uniform(-1, 1, (4, 2, 2))), ldesc0=f32(rng.normal(size=(4, 3, 3))),
               lines1=f32(rng.uniform(-1, 1, (3, 2, 2))), ldesc1=f32(rng.normal(size=(3, 3, 3))))
    jm = jreg.get_model(name, **conf)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), **inp)
    want = jax.jit(jm.apply)(variables, **inp)
    m = tm.get_model(name, **conf)
    m = type(m)(**m.conf, in_dim=8, line_in_dim=3)
    m.load_state_dict(module_params_from_jax(variables, m))
    with torch.no_grad():
        got = m(**{k: torch.as_tensor(v) for k, v in inp.items()})
    assert isinstance(jm, jgs.GlueStickMatcher) and set(got) == set(want)
    for k in ("log_assignment", "line_log_assignment"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1))
    for k in ("matches0", "line_matches0"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_matching_imports_no_jax_flax_optax_or_the_jax_package():
    """The new modules (and the package with them) import none of jax,
    flax, optax or comet_tpu."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'comet_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import comet_tpu_torch.matching, comet_tpu_torch.models.superpoint\n"
        "import comet_tpu_torch.cli, comet_tpu_torch.data.keypoints, comet_tpu_torch.weights\n"
        "print('imported')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "imported", proc.stderr


def test_grid_extractor_and_experiments_match_jax():
    """The dense grid detector, and EXPERIMENTS (every named experiment's
    config) as the JAX package's."""
    from comet_tpu.matching import configs as jconfigs
    from comet_tpu_torch.matching import configs as tconfigs

    img = np.zeros((50, 73, 3), np.float32)
    got = tm.get_model("extractor_grid", cell_size=14)(_t(img))
    want = jreg.get_model("extractor_grid", cell_size=14)(jnp.asarray(img))
    assert set(got) == set(want) and got["grid_shape"] == want["grid_shape"]
    for k in ("keypoints", "scores", "valid"):
        _equal(got[k], want[k])
    assert tconfigs.EXPERIMENTS == jconfigs.EXPERIMENTS
    assert tconfigs.get_experiment("superpoint+superglue") == jconfigs.get_experiment(
        "superpoint+superglue")
