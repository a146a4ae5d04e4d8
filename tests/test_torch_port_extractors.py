"""The port's ALIKED, DISK and KeyNet extractors, the dense and mixed
extractors and the DINOv2 backbone against ``comet_tpu``'s, on the CPU, on
the same numpy inputs and weights: each JAX model's flax variables (their
BatchNorm statistics and scales drawn at random, so the statistics' mapping
counts) written to a ``.msgpack`` that both packages load as ``params_path``.
Images are 60 x 90 (padded to 64 x 96: ALIKED's edge padding to 32, DISK's
zeros to 16) with 64 keypoints, ALIKED at ``aliked-t16``; the backbone is a
ViT of depth 2, width 64 and 2 heads (head dimension 32).

Tolerances (f32):

- keypoints of the detectors on a pixel grid (DISK, KeyNet), ``valid`` masks
  and every tie order (a flat map): equal; ALIKED's sub-pixel keypoints
  within 1e-5 pixels;
- scores, dispersity, descriptors, score maps, patches and the pieces
  (``deform_conv2d``, ``handcrafted_block``, ``dkd_detect``): within 1e-5 of
  the largest |value| (at least 1);
- the backbone's features, global descriptor and descriptors, and
  ``resize_bicubic_torch``: within 1e-5; the main path's ``DinoViT`` at its
  own size: bit for bit the forward it had before the resample was added;
- the ``match`` rows: as ``test_torch_port_match_cli.py`` holds them (match
  counts and buckets equal, precision and recall within 1e-6, the H error
  within 1e-3 relative), JAX's RANSAC samples replayed.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comet_tpu.models.aliked as jaliked
import comet_tpu.models.disk as jdisk
import comet_tpu.models.keynet as jkeynet
from comet_tpu import cli as jcli
from comet_tpu.matching import backbones as jbackbones
from comet_tpu.matching import configs as jconfigs
from comet_tpu.matching import experiments as jexp
from comet_tpu.matching import lightglue as jlg
from comet_tpu.matching import registry as jreg
from comet_tpu.models import vit as jvit
from comet_tpu.ops import bilinear as jbil
from comet_tpu.ops import corr as jcorr
from comet_tpu.utils.serialization import save_params_msgpack
from comet_tpu_torch import cli as tcli
from comet_tpu_torch import matching as tm
from comet_tpu_torch.matching import configs as tconfigs
from comet_tpu_torch.models import aliked as taliked
from comet_tpu_torch.models import disk as tdisk
from comet_tpu_torch.models import keynet as tkeynet
from comet_tpu_torch.models.vit import DinoViT
from comet_tpu_torch.ops import bilinear as tbil
from comet_tpu_torch.ops import corr as tcorr
from comet_tpu_torch.utils.serialization import read_msgpack
from comet_tpu_torch.weights import module_params_from_jax
from test_torch_port_match_cli import _Jitted, _same_row, jax_draws, jax_jitted  # noqa: F401

H, W = 60, 90
KP = 64
TOL = 1e-5
# the JAX class itself (the autouse fixture below puts jitted wrappers
# in their modules' namespaces)
JAX_ALIKED = jaliked.ALIKED


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _n(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol=TOL):
    got, want = _n(got).astype(np.float64), _n(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * max(np.abs(want).max(), 1.0), rtol=0)


def _equal(got, want):
    np.testing.assert_array_equal(_n(got), _n(want))


def _image(seed, h=H, w=W, c=3):
    rng = np.random.default_rng(seed)
    tex = tm.synthetic_texture(rng, h, w)[..., 0]
    return np.stack([np.roll(tex, 3 * i, axis=1) for i in range(c)], -1).astype(np.float32)


def _random_variables(module, arg, seed, score_bias=None):
    """Random flax variables of ``module`` in the shapes its ``init`` gives
    (``jax.eval_shape``: nothing is compiled): kernels normal with variance
    1 / fan_in, every BatchNorm's scale, bias, mean and variance drawn (flax
    leaves them 1, 0, 0, 1, so the statistics' mapping would not count),
    biases small, PReLU slopes 0.25; SDDH's aggregation weights signed
    (flax draws them from [0, 1), which makes every descriptor nearly
    parallel: cosines within f32 rounding of each other, so a nearest
    neighbour is a toss of the last bit)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), arg)

    def fill(path, leaf):
        names = [getattr(p, "key", str(p)) for p in path]
        name, shape = names[-1], leaf.shape
        if name in ("kernel", "weight", "agg_weights"):
            return rng.normal(0.0, np.prod(shape[:-1]) ** -0.5, shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "prelu_alpha":
            return np.full(shape, 0.25, np.float32)
        return rng.normal(0.0, 0.1, shape).astype(np.float32)  # biases, means

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    if score_bias is not None:
        v["params"]["learned"]["score"]["bias"][...] = score_bias
    return v


def _save(tmp_path_factory, name, variables):
    path = str(tmp_path_factory.mktemp(name) / f"{name}.msgpack")
    save_params_msgpack(path, variables)
    return path


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """params_path of each JAX model (ALIKED t16, DISK, KeyNet, dense DISK);
    "aliked1" and "disk1" are the networks JAX builds for one-channel images
    (the benchmark's pairs)."""
    x = jnp.zeros((1, 64, 96, 3))
    out = {}
    specs = {
        "aliked": (jaliked.ALIKED(model_name="aliked-t16", max_keypoints=KP), x, {}),
        "aliked1": (jaliked.ALIKED(model_name="aliked-t16", max_keypoints=KP), x[..., :1], {}),
        "disk": (jdisk.DISK(max_keypoints=KP), x, {}),
        "disk1": (jdisk.DISK(max_keypoints=KP), x[..., :1], {}),
        # the score bias lifts part of the summed score maps above 0
        "keynet": (jkeynet.KeyNetHardNet(max_keypoints=KP), jnp.zeros((H, W, 3)),
                   {"score_bias": 0.3}),
        "dense": (jdisk.DISKUnet(up=(64, 64, 64, 129)), x, {}),
    }
    for i, (name, (module, arg, kw)) in enumerate(specs.items()):
        out[name] = _save(tmp_path_factory, name, _random_variables(module, arg, 10 + i, **kw))
    return out


_JITTED = {}


def _jitted(cls, **kw):
    """One ``_Jitted`` per model and configuration, so that its compiles
    serve every test of the module."""
    key = (cls, tuple(sorted(kw.items())))
    if key not in _JITTED:
        _JITTED[key] = _Jitted(cls(**kw))
    return _JITTED[key]


@pytest.fixture(autouse=True)
def jax_models_jitted(monkeypatch):
    """JAX's extractor models with ``init`` and ``apply`` under ``jax.jit``
    (the same functions, compiled once per shape)."""
    for mod, name in ((jaliked, "ALIKED"), (jdisk, "DISK"), (jkeynet, "KeyNetHardNet")):
        cls = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda cls=cls, **kw: _jitted(cls, **kw))


# ------------------------------------------------------------ the pieces

def test_deform_conv2d_matches_jax():
    """Offsets that reach outside the map (zero padding) and between pixels,
    with a bias."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 9, 5)).astype(np.float32)
    off = (rng.normal(size=(2, 7, 9, 18)) * 2.5).astype(np.float32)
    k = rng.normal(size=(3, 3, 5, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    got = taliked.deform_conv2d(_t(x), _t(off), _t(k), _t(b))
    _close(got, jaliked.deform_conv2d(*(jnp.asarray(a) for a in (x, off, k, b))))
    # zero offsets: a plain 3 x 3 convolution with zero padding
    conv = torch.nn.functional.conv2d(_t(x).permute(0, 3, 1, 2), _t(k).permute(3, 2, 0, 1),
                                      padding=1).permute(0, 2, 3, 1)
    _close(taliked.deform_conv2d(_t(x), torch.zeros(2, 7, 9, 18), _t(k)), conv)


@pytest.mark.parametrize("flat", [False, True], ids=["random", "flat"])
def test_dkd_detect_matches_jax(flat):
    """DKD on a random score map, and on a flat one (every NMS value ties:
    the top-k must keep the index order, as ``jax.lax.top_k``)."""
    rng = np.random.default_rng(1)
    s = np.full((2, 24, 30), 0.5, np.float32) if flat else rng.random((2, 24, 30), np.float32)
    got = taliked.dkd_detect(_t(s), 40, 2)
    want = jax.jit(jaliked.dkd_detect, static_argnums=(1, 2))(jnp.asarray(s), 40, 2)
    _close(got[0], want[0])  # sub-pixel keypoints
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)
    if flat:
        _equal(got[0], want[0])


def test_simple_nms_and_patch_corners_match_jax():
    s = np.random.default_rng(2).random((2, 20, 26)).astype(np.float32)
    s[:, 5:9, 5:9] = 0.7  # a plateau
    _equal(taliked.simple_nms(_t(s), 2), jaliked.simple_nms(jnp.asarray(s), 2))
    kp = np.random.default_rng(3).uniform(-3, 40, (2, 30, 2)).astype(np.float32)
    _equal(taliked.sddh_patch_corners(_t(kp), (20, 26), 3),
           jaliked.sddh_patch_corners(jnp.asarray(kp), (20, 26), 3))


@pytest.mark.parametrize("kernel,n_pos", [(3, 16), (3, 32), (1, 8)])
def test_sddh_matches_jax(kernel, n_pos):
    """The descriptor head alone at ALIKED's (K, M) and the K = 1 branch."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 20, 32)).astype(np.float32)
    kp = rng.uniform(0, 19, (2, 12, 2)).astype(np.float32)
    m = jaliked.SDDH(32, kernel, n_pos)
    variables = jax.jit(m.init)(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(kp))
    port = taliked.SDDH(32, kernel, n_pos)
    port.load_state_dict(module_params_from_jax(jax.tree_util.tree_map(np.asarray, variables),
                                                port))
    with torch.no_grad():
        got = port(_t(x), _t(kp))
    _close(got, jax.jit(m.apply)(variables, jnp.asarray(x), jnp.asarray(kp)))


@pytest.mark.parametrize("case", ["random", "flat", "few_peaks"])
def test_heatmap_to_keypoints_matches_jax(case):
    """DISK's selection: a random heatmap; a flat one (no peak above the
    threshold: every slot -inf, filled in index order); and a map with
    fewer peaks than slots."""
    rng = np.random.default_rng(6)
    hm = rng.normal(size=(32, 40)).astype(np.float32)
    if case == "flat":
        hm[:] = -1.0
    elif case == "few_peaks":
        hm = np.full((32, 40), -1.0, np.float32)
        hm[[4, 10, 20], [5, 30, 7]] = [2.0, 1.0, 2.0]
    got = tdisk.heatmap_to_keypoints(_t(hm), 50, 5, 0.0)
    want = jax.jit(jdisk.heatmap_to_keypoints, static_argnums=(1, 2, 3))(jnp.asarray(hm), 50, 5,
                                                                         0.0)
    for g, w in zip(got, want):
        _equal(g, w)


def test_handcrafted_block_and_extract_patches_match_jax():
    rng = np.random.default_rng(7)
    x = rng.random((2, 19, 23, 1)).astype(np.float32)
    got = tkeynet.handcrafted_block(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, jkeynet.handcrafted_block(jnp.asarray(x)))
    img = rng.normal(size=(2, 70, 96, 3)).astype(np.float32)
    tl = rng.integers(-5, 100, (2, 9, 2)).astype(np.int32)  # some out of range: clamped
    _equal(tcorr.extract_patches(_t(img), _t(tl, torch.int32), 32),
           jcorr.extract_patches(jnp.asarray(img), jnp.asarray(tl), 32))


# ------------------------------------------------------------ the extractors

def _compare(got, want, subpixel=False):
    assert set(got) == set(want), (sorted(got), sorted(want))
    if subpixel:
        _close(got["keypoints"], want["keypoints"])
    else:
        _equal(got["keypoints"], want["keypoints"])
    _equal(got["valid"], want["valid"])
    for k in set(want) - {"keypoints", "valid"}:
        _close(got[k], want[k])


@pytest.mark.parametrize("name", ["extractor_aliked", "extractor_disk", "extractor_keynet"])
def test_extractor_matches_jax(weights, name):
    """Each extractor on a 60 x 90 RGB image with JAX's weights: keypoints,
    valid (the padding's keypoints invalid), scores and descriptors."""
    key = name.split("_")[1]
    conf = dict(max_keypoints=KP, params_path=weights[key])
    if key == "aliked":
        conf["model_name"] = "aliked-t16"
    img = _image(8)
    want = jreg.get_model(name, **conf)(jnp.asarray(img))
    got = tm.get_model(name, **conf, device="cpu")(img)
    _compare(got, want, subpixel=key == "aliked")
    assert 8 < int(np.asarray(want["valid"]).sum()) <= KP
    # a gray image [H, W] takes the same path as its RGB repeat (KeyNet: its
    # luma weights), and a tensor stays on its device
    g = tm.get_model(name, **conf, device="cpu")(torch.as_tensor(img[..., 0]))
    w = jreg.get_model(name, **conf)(jnp.asarray(img[..., 0]))
    _compare(g, w, subpixel=key == "aliked")


def test_aliked_outputs_match_jax(weights):
    """The ALIKED module's own outputs: score map and dispersity too."""
    img = np.pad(_image(9), ((0, 4), (0, 6), (0, 0)), mode="edge")
    jm = jaliked.ALIKED(model_name="aliked-t16", max_keypoints=KP)  # the jitted wrapper
    variables = read_msgpack(weights["aliked"])
    want = jm.apply(variables, jnp.asarray(img[None]))
    port = taliked.ALIKED("aliked-t16", max_keypoints=KP)
    port.load_state_dict(module_params_from_jax(variables, port))
    with torch.no_grad():
        got = port.eval()(_t(img[None]))
    for k in ("keypoints", "scores", "descriptors", "dispersity", "score_map"):
        _close(getattr(got, k), getattr(want, k))
    _equal(got.valid, want.valid)


def test_dense_and_mixed_extractors_match_jax(weights, monkeypatch):
    """dense_disk's map, and extractor_mixed: the grid detector's keypoints
    with descriptors sampled from that map."""
    unet = jdisk.DISKUnet  # jitted here only: JAX's DISK builds one inside its own call
    monkeypatch.setattr(jdisk, "DISKUnet", lambda **kw: _jitted(unet, **kw))
    img = _image(10)
    conf = dict(params_path=weights["dense"])
    want = jreg.get_model("dense_disk", **conf)(jnp.asarray(img))
    got = tm.get_model("dense_disk", **conf, device="cpu")(img)
    _close(got, want)
    assert got.shape == (H, W, 128)
    mixed = dict(detector="extractor_grid", detector_conf={"cell_size": 8},
                 descriptor="dense_disk", descriptor_conf=conf)
    want = jreg.get_model("extractor_mixed", **mixed)(jnp.asarray(img))
    got = tm.get_model("extractor_mixed", **mixed, device="cpu")(img)
    assert got["grid_shape"] == want["grid_shape"]
    del got["grid_shape"], want["grid_shape"]
    _compare(got, want)


# ------------------------------------------------------------ upstream checkpoints

def _zeros(module, arg):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), arg)
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)


def _upstream_aliked(template, rng):
    """A torch ALIKED state dict of random tensors, in upstream names and
    layouts, for every entry of the converter's map, and one stray key."""
    params = template["params"]
    sd = {"stray.weight": rng.normal(size=3)}

    def at(path):
        node = params
        for part in path.split("/"):
            node = node[part]
        return node

    for prefix, (dst, kind) in jaliked.ALIKED_TORCH_MAP.items():
        node = at(dst)
        if kind == "raw":
            sd[prefix] = rng.normal(size=node.shape)
        elif kind == "bn":
            c = node["scale"].shape
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                sd[f"{prefix}.{leaf}"] = rng.random(c) + 0.5
            sd[f"{prefix}.num_batches_tracked"] = np.array(3)
        else:
            k = node["weight"] if kind == "dcn_weight" else node["kernel"]
            k = k[None, None] if k.ndim == 2 else k  # the 1 x 1 sf_conv
            sd[f"{prefix}.weight"] = rng.normal(size=k.shape).transpose(3, 2, 0, 1)
            if "bias" in node:
                sd[f"{prefix}.bias"] = rng.normal(size=node["bias"].shape)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("model", ["aliked", "disk", "hardnet"])
def test_upstream_checkpoint_converters_match_jax(model):
    """The converters of upstream checkpoints (ALIKED's map, kornia's DISK
    and HardNet) on a random upstream state dict and the port's own
    variables as the template: JAX's result exactly, loadable into the
    port's module."""
    import comet_tpu_torch.models.keynet as tkn
    from comet_tpu_torch.weights import module_params_to_jax

    rng = np.random.default_rng(12)
    if model == "aliked":
        port = taliked.ALIKED("aliked-t16")
        template = module_params_to_jax(port)
        sd = _upstream_aliked(_zeros(JAX_ALIKED(model_name="aliked-t16"),
                                     jnp.zeros((1, 32, 32, 3))), rng)
        got, unmapped = taliked.convert_aliked_state_dict(sd, template)
        want, junmapped = jaliked.convert_aliked_state_dict(sd, template)
        assert unmapped == junmapped == ["stray.weight"]
    elif model == "disk":
        port = tdisk.DISK()
        template = module_params_to_jax(port)
        sd = {}
        for side, n in (("path_down", 5), ("path_up", 4)):
            blocks = template["params"]["unet"]
            for i in range(n):
                k = blocks[f"{'down' if side == 'path_down' else 'up'}_{i}"]["conv"]["kernel"]
                sd[f"unet.{side}.{i}.conv.weight"] = rng.normal(size=k.shape).transpose(3, 2, 0, 1)
                sd[f"unet.{side}.{i}.conv.bias"] = rng.normal(size=k.shape[-1:])
                sd[f"unet.{side}.{i}.act.weight"] = rng.random(1)
        sd["other.weight"] = rng.normal(size=2)
        sd = {k: v.astype(np.float32) for k, v in sd.items()}
        got = tdisk.convert_disk_state_dict(sd, template)
        want = jdisk.convert_disk_state_dict(sd, template)
    else:
        port = tkn.HardNet()
        template = module_params_to_jax(port)
        sd = {}
        for j, i in enumerate((0, 3, 6, 9, 12, 15, 18)):
            k = template["params"][f"conv{j}"]["kernel"]
            sd[f"features.{i}.weight"] = rng.normal(size=k.shape).transpose(3, 2, 0, 1)
            c = k.shape[-1]
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                sd[f"features.{i + 1}.{leaf}"] = rng.random(c) + 0.5
        sd = {k: v.astype(np.float32) for k, v in sd.items()}
        got = tkn.convert_hardnet_state_dict(sd, template)
        want = jkeynet.convert_hardnet_state_dict(sd, jax.tree_util.tree_map(np.asarray, template))
    assert _flat_equal(got, want)
    port.load_state_dict(module_params_from_jax(got, port))
    assert _flat_equal(module_params_to_jax(port), got)


def _flat_equal(a, b):
    fa = dict(jax.tree_util.tree_leaves_with_path(a))
    fb = dict(jax.tree_util.tree_leaves_with_path(b))
    return fa.keys() == fb.keys() and all(np.array_equal(np.asarray(fa[k]), np.asarray(fb[k]))
                                          for k in fa)


# ------------------------------------------------------------ the experiments

def _experiment_conf(weights, name, monkeypatch, lg_dir=None):
    key = name.split("+")[0]
    key = key + "1" if key + "1" in weights else key  # the pairs are one-channel
    for configs in (jconfigs, tconfigs):
        exp = copy.deepcopy(configs.EXPERIMENTS[name])
        exp["extractor"].update(params_path=weights[key], max_keypoints=KP)
        if key.startswith("aliked"):
            exp["extractor"]["model_name"] = "aliked-t16"
        if lg_dir:
            exp["matcher"].update(depth=2, dim=64, filter_threshold=0.0)
        monkeypatch.setitem(configs.EXPERIMENTS, name, exp)


COSINE = 50.0


@pytest.fixture(scope="module")
def aliked_lg(tmp_path_factory):
    """A JAX save_experiment directory of a depth-2 LightGlue over
    aliked-t16's 64-d descriptors whose layers pass the descriptors through
    (every update zeroed) and whose assignment scores a pair by COSINE x
    their cosine, matchabilities near 1 (random weights match next to
    nothing)."""
    import optax

    m = jlg.LightGlueMatcher(depth=2, dim=64, filter_threshold=0.0)
    k, d = jnp.zeros((8, 2)), jnp.zeros((8, 64))
    params = jax.tree_util.tree_map(np.array, jax.jit(m.init)(jax.random.PRNGKey(3), k, d, k, d))
    p = params["params"]
    p["input_proj"] = {"kernel": np.eye(64, dtype=np.float32), "bias": np.zeros(64, np.float32)}
    for i in range(2):
        for block in ("self_attn", "cross_attn"):
            for leaf in p[f"transformers_{i}"][block]["ffn_lin2"].values():
                leaf[...] = 0.0
        la = p[f"log_assignment_{i}"]
        la["final_proj"]["kernel"][...] = np.eye(64) * (COSINE ** 0.5 * 64 ** 0.25)
        la["final_proj"]["bias"][...] = 0.0
        la["matchability"]["kernel"][...] = 0.0
        la["matchability"]["bias"][...] = 8.0
    exp_dir = str(tmp_path_factory.mktemp("aliked_lg"))
    jexp.save_experiment(exp_dir, 1, params, optax.adam(1e-3).init(params), loss=0.5)
    return exp_dir


@pytest.mark.parametrize("name", ["aliked+nn", "disk+nn", "keynet+nn",
                                  "aliked+lightglue_homography"])
def test_match_experiment_row_matches_jax(weights, aliked_lg, jax_draws, monkeypatch, capsys,
                                          name):
    """``match --experiment NAME --n-pairs 2 --image-size 64`` (the
    LightGlue experiment with ``--load-experiment``): JAX's row."""
    lg = name.endswith("homography")
    _experiment_conf(weights, name, monkeypatch, aliked_lg if lg else None)
    argv = ["match", "--experiment", name, "--n-pairs", "2", "--image-size", "64"]
    if lg:
        argv += ["--load-experiment", aliked_lg]
    jcli.main(argv)
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    tcli.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert want["num_matches"] > 3
    _same_row(got, want)


# ------------------------------------------------------------ the backbone

BB = dict(depth=2, embed_dim=64, num_heads=2, size=56)


class _JittedViT:
    """JAX's DinoViT with ``init`` and ``apply`` under ``jax.jit``."""

    def __init__(self, **kw):
        self.module = jvit.DinoViT(**kw)
        self.init = jax.jit(self.module.init)
        self.apply = jax.jit(self.module.apply, static_argnames="return_cls")


@pytest.fixture(scope="module")
def vit_weights(tmp_path_factory):
    """A tiny ViT's variables, every leaf random (the cls token and
    LayerScales too, which flax initializes as constants)."""
    m = jvit.DinoViT(img_size=56, patch_size=14, embed_dim=64, depth=2, num_heads=2,
                     num_register_tokens=0)
    v = jax.tree_util.tree_map(np.array, jax.jit(m.init)(jax.random.PRNGKey(0),
                                                         jnp.zeros((1, 56, 56, 3))))
    rng = np.random.default_rng(1)
    for leaf in jax.tree_util.tree_leaves(v):
        leaf[...] = rng.normal(size=leaf.shape) * 0.3
    return _save(tmp_path_factory, "vit", v)


@pytest.mark.parametrize("shape,resize", [((56, 56, 3), False), ((75, 100, 3), True),
                                          ((2, 3, 56, 70), True)],
                         ids=["at_size", "rectangular_resized", "batch_nchw"])
def test_backbone_matches_jax(vit_weights, monkeypatch, shape, resize):
    """``backbone_dinov2`` at its size, at a rectangular input that is not a
    multiple of 14 (shrunk to 70 x 98 with the antialiased bilinear, the
    position embedding resampled to a 5 x 7 grid), and on an NCHW batch."""
    monkeypatch.setattr(jbackbones, "DinoViT", _JittedViT)
    conf = dict(BB, allow_resize=resize, params_path=vit_weights)
    img = np.random.default_rng(2).random(shape).astype(np.float32)
    want = jreg.get_model("backbone_dinov2", **conf)(jnp.asarray(img))
    got = tm.get_model("backbone_dinov2", **conf, device="cpu")(img)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        _close(got[k], want[k])


def test_backbone_refuses_another_size():
    bb = tm.get_model("backbone_dinov2", **BB, device="cpu")
    with pytest.raises(ValueError, match="configured for 56x56 inputs, got 60x56; set "
                                         "allow_resize=True"):
        bb(np.zeros((60, 56, 3), np.float32))


@pytest.mark.parametrize("n_in,n_out", [(16, 7), (16, 31), (24, 24), (37, 24), (5, 1)])
def test_resize_bicubic_torch_matches_jax(n_in, n_out):
    _close(tbil.interp_matrix_bicubic_torch(n_in, n_out),
           jbil.interp_matrix_bicubic_torch(n_in, n_out))
    x = np.random.default_rng(n_out).normal(size=(n_in, n_in + 3, 4)).astype(np.float32)
    _close(tbil.resize_bicubic_torch(_t(x), n_out, n_out + 2),
           jbil.resize_bicubic_torch(jnp.asarray(x), n_out, n_out + 2))


def test_dinovit_at_its_size_is_the_forward_it_was():
    """The main path's DinoViT (registers, its configured size): bit for bit
    the forward without the resample, which never runs there."""
    from comet_tpu_torch.models.blocks import init_params

    m = DinoViT(img_size=56, embed_dim=64, depth=2, num_heads=2, num_register_tokens=4)
    init_params(m, torch.Generator().manual_seed(3))
    img = torch.randn(2, 56, 56, 3, generator=torch.Generator().manual_seed(4))
    assert m.pos_embed_for(4, 4) is m.pos_embed
    with torch.no_grad():
        x = m.patch_embed(img.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        x = torch.cat([m.cls_token.expand(2, 1, 64), x], dim=1) + m.pos_embed
        x = torch.cat([x[:, :1], m.register_tokens.expand(2, 4, 64), x[:, 1:]], dim=1)
        for blk in m.blocks:
            x = blk(x)
        want = m.norm(x)[:, 5:]
        got = m(img)
        patches, cls = m(img, return_cls=True)
    assert torch.equal(got, want) and torch.equal(patches, want)
    assert torch.equal(cls, m.norm(x)[:, 0])
