"""The port's modules and the whole COMET forward against the JAX package.

Both sides run in f32 on the CPU (JAX with ``highest`` matmul precision, set
by conftest.py) on the same numpy inputs and the same parameters: one flax
tree of random numpy values, handed to JAX as it is and to the port through
the weight bridge. The tree's shapes come from ``jax.eval_shape`` of the JAX
model on the tiny configuration of ``__graft_entry__.py`` (the real
architecture at small widths), so no JAX initialisation runs. The JAX
forwards are shared through module-scoped fixtures.

Tolerances: 1e-5 for the pure tensor ops, 2e-5 to 5e-5 for single modules
(float reassociation through a few f32 matmuls), 5e-3 px on tracker
coordinates (the random weights move points by tens of pixels in each
iteration, which amplifies that reassociation; 2e-3 px observed), and for
the whole forward those of the reference-torch parity test
(tests/test_torch_parity_full.py): 2e-2 px on tracks, 5e-3 on scores and
poses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comet_tpu.config as jcfg
import comet_tpu_torch.config as tcfg
from comet_tpu.geometry import cameras as jcam
from comet_tpu.geometry import codecs as jcodecs
from comet_tpu.geometry import embeddings as jemb
from comet_tpu.geometry import quaternions as jquat
from comet_tpu.models import COMET as JaxCOMET
from comet_tpu.models import camera_predictor as jcp
from comet_tpu.models import encoders as jenc
from comet_tpu.models import refine as jrefine
from comet_tpu.models import tracker as jtracker
from comet_tpu.models import update_former as juf
from comet_tpu.models import vit as jvit
from comet_tpu.models.comet import decode_predictions as jax_decode_predictions
from comet_tpu.ops import bilinear as jbil
from comet_tpu.ops import corr as jcorr
from comet_tpu_torch.geometry import cameras as tcam
from comet_tpu_torch.geometry import codecs as tcodecs
from comet_tpu_torch.geometry import embeddings as temb
from comet_tpu_torch.geometry import quaternions as tquat
from comet_tpu_torch.models import build_comet, decode_predictions
from comet_tpu_torch.models.camera_predictor import CameraPredictor
from comet_tpu_torch.models.encoders import BasicEncoder, ShallowEncoder
from comet_tpu_torch.models.refine import compute_score_fn
from comet_tpu_torch.models.tracker import BaseTracker, tracker_transformer_dim
from comet_tpu_torch.models.update_former import EfficientUpdateFormer
from comet_tpu_torch.models.vit import DinoViT
from comet_tpu_torch.ops import bilinear as tbil
from comet_tpu_torch.ops import corr as tcorr
from comet_tpu_torch.weights import params_from_jax, state_dict_from_flax

_TRACKER = dict(
    coarse_stride=4, coarse_down_ratio=2, coarse_corr_levels=2,
    coarse_corr_radius=2, coarse_latent_dim=16, coarse_hidden_size=32,
    coarse_depth=2, coarse_iters=2, fine_corr_levels=3,
    fine_corr_radius=2, fine_latent_dim=8, fine_hidden_size=16,
    fine_depth=2, fine_iters=2, fine_pradius=7, fine_sradius=2,
)
_CAMERA = dict(
    hidden_size=32, num_heads=2, att_depth=1, trunk_depth=1,
    down_size=28, backbone_depth=2, backbone_dim=32, backbone_heads=2,
)
_TOP = dict(seqlen=2, img_size=64, track_num=8, compute_dtype="float32")


def _tiny(pkg, **camera):
    return pkg.get_config("ours").replace(
        **_TOP, tracker=pkg.TrackerConfig(**_TRACKER),
        camera=pkg.CameraConfig(**{**_CAMERA, **camera}),
    )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _close(got, want, atol, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _random_tree(shapes, seed):
    """A parameter tree of the given shapes with values that keep every
    layer active: kernels ~ N(0, 1/fan_in), biases and tokens ~ N(0, 0.1^2),
    norm scales ~ 1 + N(0, 0.1^2), LayerScale gammas ~ U(0.2, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        shape = x.shape
        if name in ("kernel", "in_proj_kernel"):
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(size=shape).astype(np.float32) / np.sqrt(fan_in)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "gamma":
            return rng.uniform(0.2, 1.0, size=shape).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs(cfg, seed=0, b=1):
    rng = np.random.default_rng(seed)
    s, hw, n = cfg.seqlen, cfg.img_size, cfg.track_num
    images = rng.normal(size=(b, s, hw, hw, 3)).astype(np.float32)
    queries = (rng.random((b, n, 2)) * (hw - 20) + 10).astype(np.float32)
    return images, queries


def _jax_params(cfg, images, queries, seed):
    shapes = jax.eval_shape(
        JaxCOMET(cfg).init, jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(queries)
    )
    return _random_tree(shapes, seed)["params"]


def _load(module, flax_tree):
    module.load_state_dict(state_dict_from_flax(flax_tree, module.state_dict()))
    return module.eval()


@pytest.fixture(scope="module")
def tiny():
    """The tiny config (both packages), inputs, params and the JAX forward."""
    jc, tc = _tiny(jcfg), _tiny(tcfg)
    images, queries = _inputs(jc)
    params = _jax_params(jc, images, queries, seed=1)
    out = jax.jit(JaxCOMET(jc).apply)({"params": params}, jnp.asarray(images), jnp.asarray(queries))
    out = {k: np.asarray(v) for k, v in out.items()}
    return dict(jc=jc, tc=tc, images=images, queries=queries, params=params, out=out)


# ---------------------------------------------------------------- geometry


def test_embeddings_match_jax():
    rng = np.random.default_rng(0)
    _close(temb.sincos_time_embed(48, 16), jemb.sincos_time_embed(48, 16), 1e-5)
    _close(temb.sincos_2d_pos_embed(64, (5, 7)), jemb.sincos_2d_pos_embed(64, (5, 7)), 1e-5)
    _close(
        temb.sincos_2d_pos_embed_grid(36, (6, 4)), jemb.sincos_2d_pos_embed_grid(36, (6, 4)), 1e-5
    )
    xy = rng.normal(size=(2, 5, 3, 2)).astype(np.float32) * 3
    for cat in (True, False):
        _close(
            temb.embed_2d_coords(_t(xy), 8, cat_coords=cat),
            jemb.embed_2d_coords(jnp.asarray(xy), 8, cat_coords=cat), 1e-5,
        )


def test_quaternions_match_jax():
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(6, 4)).astype(np.float32) for _ in range(2))
    _close(tquat.quat_multiply(_t(a), _t(b)), jquat.quat_multiply(jnp.asarray(a), jnp.asarray(b)), 1e-6)
    _close(tquat.quat_standardize(_t(a)), jquat.quat_standardize(jnp.asarray(a)), 0)


def _cameras(seed, s=4):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(s, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t_xyz = rng.normal(size=(s, 3)).astype(np.float32)
    t_uvz = rng.normal(size=(s, 3)).astype(np.float32) * 50
    t_uvz[:, 2] = np.abs(t_uvz[:, 2]) + 2.0
    return dict(q=q, t_xyz=t_xyz, t_uvz=t_uvz, ratio=np.float32(0.8))


@pytest.mark.parametrize("use_gapr", [True, False])
def test_decode_predictions_matches_jax(use_gapr):
    cams = _cameras(2)
    enc = np.random.default_rng(3).normal(size=(4, 7)).astype(np.float32)
    jc = _tiny(jcfg, use_gapr=use_gapr)
    tc = _tiny(tcfg, use_gapr=use_gapr)
    want = jax_decode_predictions(jc, jnp.asarray(enc), jcam.make_camera_set(**cams))
    got = decode_predictions(tc, _t(enc), tcam.make_camera_set(**cams))
    for g, w in zip(got, want):
        _close(g, w, 1e-5, 1e-6)
    # and the uvz decoder directly, on an encoding batch [2, 4, 7]
    enc2 = np.stack([enc, enc[::-1]])
    intr = jcodecs.INTRINSICS_TABLE["AMD_test"]
    want = jcodecs.decode_relative_uvz(jnp.asarray(enc2), jcam.make_camera_set(**cams), intr)
    got = tcodecs.decode_relative_uvz(
        _t(enc2), tcam.make_camera_set(**cams), tcodecs.INTRINSICS_TABLE["AMD_test"]
    )
    for g, w in zip(got, want):
        _close(g, w, 1e-4, 1e-6)


# ------------------------------------------------------------------- ops


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_sample_features_matches_jax(padding_mode):
    rng = np.random.default_rng(4)
    fmaps = rng.normal(size=(2, 9, 11, 5)).astype(np.float32)
    pts = (rng.random((2, 30, 2)) * 14 - 2).astype(np.float32)  # some taps off the map
    want = jbil.sample_features(jnp.asarray(fmaps), jnp.asarray(pts), padding_mode)
    _close(tbil.sample_features(_t(fmaps), _t(pts), padding_mode), want, 1e-5)


@pytest.mark.parametrize("out_hw", [(31, 31), (7, 5), (1, 4)])
def test_resize_matches_jax(out_hw):
    x = np.random.default_rng(5).normal(size=(2, 3, 16, 12, 4)).astype(np.float32)
    want = jbil.resize_bilinear_align_corners(jnp.asarray(x), *out_hw)
    _close(tbil.resize_bilinear_align_corners(_t(x), *out_hw), want, 1e-5)


@pytest.mark.parametrize(
    "n,h0,levels,radius,out_size",
    [
        (6, 16, 3, 2, None),  # coarse form: several tracks per frame
        (1, 8, 3, 2, (15, 15)),  # fine form: one track, the fnet upsample folded in
        (3, 5, 4, 1, None),  # a map that bottoms out below 2 pixels
    ],
)
def test_corr_volume_pyramid_sample_matches_jax(n, h0, levels, radius, out_size):
    rng = np.random.default_rng(6)
    b, s, c = 2, 3, 8
    fmaps = rng.normal(size=(b, s, h0, h0, c)).astype(np.float32)
    side = out_size[0] if out_size else h0
    coords = (rng.random((b, s, n, 2)) * (side + 6) - 3).astype(np.float32)  # some off the map
    feats = rng.normal(size=(b, s, n, c)).astype(np.float32)
    want = jcorr.corr_volume_pyramid_sample(
        jnp.asarray(fmaps), jnp.asarray(coords), jnp.asarray(feats), radius, levels,
        out_size=out_size,
    )
    got = tcorr.corr_volume_pyramid_sample(
        _t(fmaps), _t(coords), _t(feats), radius, levels, out_size=out_size
    )
    _close(got, want, 2e-5)


@pytest.mark.parametrize("track_major", [True, False])
@pytest.mark.parametrize("hw,psize", [(40, 15), (96, 31)])
def test_extract_patches_matches_jax(track_major, hw, psize):
    rng = np.random.default_rng(7)
    images = rng.normal(size=(3, hw, hw, 3)).astype(np.float32)
    topleft = rng.integers(-5, hw - psize + 5, size=(3, 10, 2)).astype(np.int32)
    want = jcorr.extract_patches_ex(jnp.asarray(images), jnp.asarray(topleft), psize, track_major)
    got = tcorr.extract_patches_ex(_t(images), torch.from_numpy(topleft), psize, track_major)
    _close(got, want, 0)


# --------------------------------------------------------------- modules


def test_basic_encoder_matches_jax(tiny):
    p = tiny["params"]["coarse_fnet"]
    x = np.random.default_rng(8).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = jenc.BasicEncoder(output_dim=16, stride=4).apply({"params": p}, jnp.asarray(x))
    with torch.no_grad():
        got = _load(BasicEncoder(16, 4), p)(_t(x))
    _close(got, want, 5e-5)


def test_shallow_encoder_matches_jax(tiny):
    p = tiny["params"]["fine_fnet"]
    x = np.random.default_rng(9).normal(size=(4, 15, 15, 3)).astype(np.float32)
    for resize in (False, True):
        want = jenc.ShallowEncoder(output_dim=8, stride=1, resize_output=resize).apply(
            {"params": p}, jnp.asarray(x)
        )
        with torch.no_grad():
            got = _load(ShallowEncoder(8, 1, resize_output=resize), p)(_t(x))
        _close(got, want, 5e-5)


def test_update_former_matches_jax(tiny):
    p = tiny["params"]["coarse_tracker"]["updateformer"]
    tdim = tracker_transformer_dim(2, 2, 16, False)
    x = np.random.default_rng(10).normal(size=(1, 8, 2, tdim)).astype(np.float32)
    want = juf.EfficientUpdateFormer(
        space_depth=2, time_depth=2, hidden_size=32, output_dim=18
    ).apply({"params": p}, jnp.asarray(x))
    port = EfficientUpdateFormer(tdim, space_depth=2, time_depth=2, hidden_size=32, output_dim=18)
    with torch.no_grad():
        got = _load(port, p)(_t(x))
    _close(got, want, 5e-5)


def test_coarse_tracker_matches_jax(tiny):
    p = tiny["params"]["coarse_tracker"]
    rng = np.random.default_rng(11)
    fmaps = rng.normal(size=(1, 2, 8, 8, 16)).astype(np.float32)
    queries = (rng.random((1, 8, 2)) * 50 + 5).astype(np.float32)
    kw = dict(stride=4, corr_levels=2, corr_radius=2, latent_dim=16, hidden_size=32, depth=2)
    want = jtracker.BaseTracker(**kw).apply(
        {"params": p}, jnp.asarray(queries), jnp.asarray(fmaps), iters=2, down_ratio=2
    )
    with torch.no_grad():
        got = _load(BaseTracker(**kw), p)(_t(queries), _t(fmaps), iters=2, down_ratio=2)
    _close(got.coord_preds, want.coord_preds, 5e-3)
    _close(got.vis, want.vis, 2e-5)
    _close(got.track_feats, want.track_feats, 2e-4)  # follows the coordinates
    _close(got.query_feats, want.query_feats, 1e-5)
    # the frame-0 pin: every iteration returns the queries on frame 0
    _close(got.coord_preds[:, :, 0], np.broadcast_to(queries, (2, 1, 8, 2)), 1e-6)


def test_fine_tracker_matches_jax(tiny):
    p = tiny["params"]["fine_tracker"]
    rng = np.random.default_rng(12)
    fmaps = rng.normal(size=(8, 2, 8, 8, 8)).astype(np.float32)  # native 8x8, read at 15x15
    queries = (rng.random((8, 1, 2)) + 7).astype(np.float32)
    kw = dict(stride=1, corr_levels=3, corr_radius=2, latent_dim=8, hidden_size=16,
              use_space_attn=False, depth=2, fine=True, corr_size=(15, 15))
    want = jtracker.BaseTracker(**kw).apply(
        {"params": p}, jnp.asarray(queries), jnp.asarray(fmaps), iters=2
    )
    with torch.no_grad():
        got = _load(BaseTracker(**kw), p)(_t(queries), _t(fmaps), iters=2)
    assert got.vis is None and want.vis is None
    _close(got.coord_preds, want.coord_preds, 5e-3)
    _close(got.query_feats, want.query_feats, 1e-5)


def test_compute_score_fn_matches_jax():
    rng = np.random.default_rng(13)
    b, n, s, hp, c = 2, 5, 3, 8, 4
    query = rng.normal(size=(b, n, c)).astype(np.float32)
    patches = rng.normal(size=(b, n, s, hp, hp, c)).astype(np.float32)
    pred = (rng.random((b, n, s, 2)) * 17 - 1).astype(np.float32)
    want = jrefine.compute_score_fn(
        jnp.asarray(query), jnp.asarray(patches), jnp.asarray(pred), 2, 15
    )
    _close(compute_score_fn(_t(query), _t(patches), _t(pred), 2, 15), want, 1e-5)


def test_vit_matches_jax(tiny):
    p = tiny["params"]["camera_predictor"]["backbone"]
    x = np.random.default_rng(14).normal(size=(2, 28, 28, 3)).astype(np.float32)
    want = jvit.DinoViT(img_size=28, embed_dim=32, depth=2, num_heads=2).apply(
        {"params": p}, jnp.asarray(x)
    )
    with torch.no_grad():
        got = _load(DinoViT(img_size=28, embed_dim=32, depth=2, num_heads=2), p)(_t(x))
    _close(got, want, 5e-5)


@pytest.mark.parametrize(
    "flags",
    [
        dict(),
        dict(use_trajectory=False, use_time=False, use_gapr=False),
        dict(use_trajectory=False),
        dict(use_time=False),
        dict(use_gapr=False),
    ],
    ids=["ours", "abl_all", "abl_track", "abl_time", "abl_uvz"],
)
def test_camera_predictor_matches_jax(flags):
    kw = dict(hidden_size=32, num_heads=2, att_depth=1, trunk_depth=1, down_size=28,
              backbone_depth=2, backbone_dim=32, backbone_heads=2, **flags)
    rng = np.random.default_rng(15)
    images = rng.normal(size=(1, 3, 40, 40, 3)).astype(np.float32)
    traj = (rng.random((1, 3, 6, 2)) * 40).astype(np.float32)
    conf = rng.random((1, 3, 6)).astype(np.float32)
    args = [jnp.asarray(a) for a in (images, traj, conf)]
    shapes = jax.eval_shape(jcp.CameraPredictor(**kw).init, jax.random.PRNGKey(0), *args)
    p = _random_tree(shapes, seed=16)["params"]
    want = jax.jit(jcp.CameraPredictor(**kw).apply)({"params": p}, *args)
    with torch.no_grad():
        got = _load(CameraPredictor(**kw), p)(_t(images), _t(traj), _t(conf))
    _close(got.pred_pose_enc, want.pred_pose_enc, 5e-5)
    _close(got.pre_head_feat, want.pre_head_feat, 5e-5)
    _close(got.pred_pose_enc[:, 0], [[0, 0, 0, 1, 0, 0, 0]], 0)


# ----------------------------------------------------------- whole forward


@pytest.fixture(scope="module")
def tiny_port(tiny):
    model = build_comet(tiny["tc"], device="cpu")
    model.load_state_dict(params_from_jax({"params": tiny["params"]}, tiny["tc"]))
    with torch.no_grad():
        out = model(_t(tiny["images"]), _t(tiny["queries"]))
    return model, out


def test_forward_matches_jax(tiny, tiny_port):
    _, got = tiny_port
    want = tiny["out"]
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert torch.isfinite(got[key]).all(), key
    _close(got["coarse_track"], want["coarse_track"], 2e-2, 2e-2)
    _close(got["pred_track"], want["pred_track"], 2e-2, 2e-2)
    _close(got["track_vis"], want["track_vis"], 5e-3, 5e-3)
    _close(got["track_score"], want["track_score"], 5e-3, 5e-3)
    _close(got["pred_pose_enc"], want["pred_pose_enc"], 5e-3, 5e-3)
    # the served invariants: frame 0 is the query and the identity pose
    _close(got["pred_track"][:, 0], tiny["queries"], 1e-6)
    _close(got["pred_pose_enc"][:, 0], [[0, 0, 0, 1, 0, 0, 0]], 0)


def test_forward_then_decode_matches_jax(tiny, tiny_port):
    cams = _cameras(17, s=tiny["jc"].seqlen)
    want = jax_decode_predictions(
        tiny["jc"], jnp.asarray(tiny["out"]["pred_pose_enc"][0]), jcam.make_camera_set(**cams)
    )
    got = decode_predictions(tiny["tc"], tiny_port[1]["pred_pose_enc"][0], tcam.make_camera_set(**cams))
    for g, w in zip(got, want):
        _close(g, w, 5e-3, 5e-3)


def test_bf16_forward_on_cpu_is_finite(tiny):
    model = build_comet(tiny["tc"].replace(compute_dtype="bfloat16"), device="cpu")
    with torch.no_grad():
        out = model(_t(tiny["images"]), _t(tiny["queries"]))
    for key, value in out.items():
        assert torch.isfinite(value).all(), key
    _close(out["pred_track"][:, 0], tiny["queries"], 1e-6)


def test_build_comet_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_comet(_tiny(tcfg))


def test_build_comet_follows_the_jax_initialisers():
    model = build_comet(_tiny(tcfg), device="cpu", seed=3)
    sd = model.state_dict()
    gamma = sd["camera_predictor.backbone.blocks.0.ls1.gamma"]
    assert torch.all(gamma == 1e-5)
    assert torch.all(sd["coarse_tracker.updateformer.flow_head.bias"] == 0)
    assert sd["camera_predictor.pose_token"].abs().max() < 1e-5
    virtual = sd["coarse_tracker.updateformer.virtual_tracks"]
    assert 0.7 < virtual.std() < 1.3
    w = sd["coarse_tracker.updateformer.time_blocks.0.attn.in_proj_weight"]  # [3E, E]
    assert abs(w.std().item() * w.shape[1] ** 0.5 - 1.0) < 0.1  # lecun_normal: var 1/fan_in
    again = build_comet(_tiny(tcfg), device="cpu", seed=3).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


# ------------------------------------------ pieces no JAX model calls

from comet_tpu.models import blocks as jblocks  # noqa: E402
from comet_tpu_torch.models import blocks as tblocks  # noqa: E402
from comet_tpu_torch.weights import module_params_from_jax  # noqa: E402


def _port_of(jax_vars, module):
    module.load_state_dict(module_params_from_jax(jax_vars, module))
    return module


@pytest.mark.parametrize("learned", [True, False])
def test_pose_embedding_matches_jax(learned):
    """PoseEmbedding, learned (fc, GELU, LayerNorm eps 1e-5, fc, LayerNorm)
    within 2e-5, or harmonic within 1e-5."""
    x = np.random.default_rng(0).normal(size=(2, 5, 9)).astype(np.float32)
    jm = jblocks.PoseEmbedding(target_dim=32, learned=learned, n_harmonic_functions=4)
    jvars = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tm = tblocks.PoseEmbedding(9, target_dim=32, learned=learned, n_harmonic_functions=4)
    if learned:
        tm = _port_of(jvars, tm)
        assert tm.emb.norm1.eps == 1e-5 and tm.emb.norm2.eps == 1e-5
    else:
        assert not jvars.get("params") and not list(tm.parameters())
    _close(tm(_t(x)), jm.apply(jvars, jnp.asarray(x)), 2e-5 if learned else 1e-5)


@pytest.mark.parametrize("self_attention", [True, False])
def test_masked_multi_head_attention_matches_jax(self_attention):
    """The masked path of MultiHeadAttention (plain ops, not K1), with a
    padding mask over keys broadcast against [..., heads, Lq, Lk], within 2e-5."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(3, 6, 32)).astype(np.float32)
    kv = q if self_attention else rng.normal(size=(3, 9, 32)).astype(np.float32)
    mask = rng.random((3, 1, 1, kv.shape[1])) > 0.3
    mask[..., 0] = True
    jm = jblocks.MultiHeadAttention(num_heads=4)
    jq, jkv = jnp.asarray(q), jnp.asarray(kv)
    jkv = jq if self_attention else jkv
    jvars = jm.init(jax.random.PRNGKey(0), jq, jkv, jkv, mask=jnp.asarray(mask))
    want = jm.apply(jvars, jq, jkv, jkv, mask=jnp.asarray(mask))
    tm = _port_of(jvars, tblocks.MultiHeadAttention(32, 4))
    tq = _t(q)
    tkv = tq if self_attention else _t(kv)
    _close(tm(tq, tkv, tkv, mask=torch.from_numpy(mask)), want, 2e-5)
    # no key masked: the same values as the mask-free path (K1's plain version)
    full = torch.ones(mask.shape, dtype=torch.bool)
    _close(tm(tq, tkv, tkv, mask=full), tm(tq, tkv, tkv).detach().numpy(), 2e-5)


@pytest.mark.parametrize("norm_fn,stride", [("group", 1), ("group", 2), ("none", 2),
                                            ("instance", 2)])
def test_residual_block_norms_match_jax(norm_fn, stride):
    """ResidualBlock with each norm_fn (GroupNorm of planes // 8 groups, eps
    1e-6; none; instance), NHWC in JAX against NCHW in the port, within 2e-5."""
    cin = 32 if stride == 1 else 16  # the shortcut adds the input unprojected at stride 1
    x = np.random.default_rng(3).normal(size=(2, 12, 10, cin)).astype(np.float32)
    jm = jblocks.ResidualBlock(planes=32, norm_fn=norm_fn, stride=stride)
    jvars = jm.init(jax.random.PRNGKey(4), jnp.asarray(x))
    tm = _port_of(jvars, tblocks.ResidualBlock(cin, 32, stride, norm_fn=norm_fn))
    got = tm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, jm.apply(jvars, jnp.asarray(x)), 2e-5)
