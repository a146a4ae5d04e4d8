"""The weight bridge at full width, and the port's independence from JAX.

The bridge test takes the JAX COMET's parameter shapes for each of the five
presets at full width from ``jax.eval_shape`` (no parameter is allocated) and
the port's from a model built on the ``meta`` device, and checks that every
flax leaf maps to exactly one port parameter of the converted shape and that
every port parameter is filled.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import comet_tpu.config as jcfg
import comet_tpu_torch.config as tcfg
from comet_tpu.models import COMET as JaxCOMET
from comet_tpu_torch.models import build_comet
from comet_tpu_torch.weights import (
    convert_leaf,
    module_params_from_jax,
    module_params_to_jax,
    params_from_jax,
    state_dict_from_flax,
)

REPO = Path(__file__).resolve().parent.parent


def _flax_shapes(name):
    """The JAX COMET's parameter tree for a preset, with zero-stride numpy
    leaves of the right shapes (no memory behind them)."""
    cfg = jcfg.get_config(name)
    # parameter shapes do not depend on the image size or the track count
    shapes = jax.eval_shape(
        JaxCOMET(cfg).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 2, 64, 64, 3), jnp.float32),
        jax.ShapeDtypeStruct((1, 8, 2), jnp.float32),
    )
    zero = np.zeros(1, np.float32)
    return jax.tree_util.tree_map(
        lambda x: np.lib.stride_tricks.as_strided(
            zero, x.shape, strides=(0,) * len(x.shape), writeable=True
        ),
        shapes,
    )


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_bridge_maps_every_leaf_of_every_preset_at_full_width(name):
    tree = _flax_shapes(name)
    expected = build_comet(tcfg.get_config(name), device="meta").state_dict()
    assert len(jax.tree_util.tree_leaves(tree)) == len(expected)
    sd = params_from_jax(tree, tcfg.get_config(name))  # raises on any unmatched leaf
    assert set(sd) == set(expected)
    for key, value in sd.items():
        assert tuple(value.shape) == tuple(expected[key].shape), key


def test_bridge_transposes_and_renames():
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(3, 5)).astype(np.float32)
    conv = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)  # HWIO
    name, w = convert_leaf(("coarse_tracker", "updateformer", "time_blocks_2", "mlp", "fc1", "kernel"), dense)
    assert name == "coarse_tracker.updateformer.time_blocks.2.mlp.fc1.weight"
    np.testing.assert_array_equal(w, dense.T)
    name, w = convert_leaf(("coarse_fnet", "layer2_0", "conv1", "kernel"), conv)
    assert name == "coarse_fnet.layer2.0.conv1.weight"
    np.testing.assert_array_equal(w, conv.transpose(3, 2, 0, 1))
    name, w = convert_leaf(("a", "attn", "in_proj_kernel"), dense)
    assert name == "a.attn.in_proj_weight"
    np.testing.assert_array_equal(w, dense.T)
    assert convert_leaf(("a", "ffeat_norm", "scale"), dense[0])[0] == "a.ffeat_norm.weight"
    assert convert_leaf(("camera_predictor", "backbone", "blocks_3", "ls1", "gamma"), dense[0])[0] == (
        "camera_predictor.backbone.blocks.3.ls1.gamma"
    )


def test_bridge_refuses_a_missing_an_extra_or_a_misshapen_leaf():
    expected = {"fc.weight": (5, 3), "fc.bias": (5,)}
    good = {"fc": {"kernel": np.zeros((3, 5), np.float32), "bias": np.zeros(5, np.float32)}}
    sd = state_dict_from_flax(good, expected)
    assert sd["fc.weight"].shape == (5, 3)
    with pytest.raises(KeyError, match="not filled"):
        state_dict_from_flax({"fc": {"kernel": good["fc"]["kernel"]}}, expected)
    with pytest.raises(KeyError, match="no such port parameter"):
        state_dict_from_flax({**good, "other": {"bias": np.zeros(2)}}, expected)
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_flax({"fc": {"kernel": np.zeros((5, 3)), "bias": np.zeros(5)}}, expected)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "comet_tpu_torch").rglob("*.py")
    )
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'comet_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ------------------------------------------------------------ batch_stats and the way back

def test_bridge_maps_batch_stats_to_the_running_statistics():
    """flax's ``batch_stats`` collection: ``mean`` -> ``running_mean``,
    ``var`` -> ``running_var``; ``num_batches_tracked`` (which flax does not
    keep) is filled with 0; a statistic of no BatchNorm, or one missing,
    raises."""
    import torch

    from comet_tpu_torch.models.blocks import BatchNorm, Conv2d

    module = torch.nn.Module()
    module.conv0 = Conv2d(3, 4, 3, bias=False)
    module.bn0 = BatchNorm(4)
    rng = np.random.default_rng(1)
    tree = {
        "params": {"conv0": {"kernel": rng.normal(size=(3, 3, 3, 4)).astype(np.float32)},
                   "bn0": {"scale": rng.random(4, np.float32), "bias": rng.random(4, np.float32)}},
        "batch_stats": {"bn0": {"mean": rng.random(4, np.float32),
                                "var": rng.random(4, np.float32)}},
    }
    sd = module_params_from_jax(tree, module)
    np.testing.assert_array_equal(sd["bn0.running_mean"], tree["batch_stats"]["bn0"]["mean"])
    np.testing.assert_array_equal(sd["bn0.running_var"], tree["batch_stats"]["bn0"]["var"])
    np.testing.assert_array_equal(sd["bn0.weight"], tree["params"]["bn0"]["scale"])
    assert int(sd["bn0.num_batches_tracked"]) == 0
    module.load_state_dict(sd)
    back = module_params_to_jax(module)
    assert _paths(back) == _paths(tree)
    np.testing.assert_array_equal(back["batch_stats"]["bn0"]["var"], tree["batch_stats"]["bn0"]["var"])
    bad = {**tree, "batch_stats": {"bn0": {**tree["batch_stats"]["bn0"], "count": np.zeros(4)}}}
    with pytest.raises(KeyError, match="not a BatchNorm statistic"):
        module_params_from_jax(bad, module)
    with pytest.raises(KeyError, match="not filled"):
        module_params_from_jax({"params": tree["params"]}, module)


def _paths(tree, prefix=""):
    """path -> shape of every leaf of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = tuple(np.shape(v))
    return out


def _slice_modules():
    """(name, JAX module and init arguments, port module) of every matcher,
    extractor and backbone of the matching slice, at full width."""
    from comet_tpu.matching import lightglue as jlg
    from comet_tpu.matching import superglue as jsg
    from comet_tpu.models import aliked as jal
    from comet_tpu.models import disk as jdisk
    from comet_tpu.models import keynet as jkn
    from comet_tpu.models import vit as jvit
    from comet_tpu_torch.matching import lightglue as tlg
    from comet_tpu_torch.matching import superglue as tsg
    from comet_tpu_torch.models import aliked as tal
    from comet_tpu_torch.models import disk as tdisk
    from comet_tpu_torch.models import keynet as tkn
    from comet_tpu_torch.models.vit import DinoViT

    k, d = jnp.zeros((8, 2)), jnp.zeros((8, 256))
    img = jnp.zeros((1, 64, 64, 3))
    out = {
        "lightglue": (jlg.LightGlueMatcher(), (k, d, k, d), lambda: tlg.LightGlueMatcher(in_dim=256)),
        "superglue": (jsg.SuperGlueMatcher(), (k, d, k, d), lambda: tsg.SuperGlueMatcher(in_dim=256)),
        "disk": (jdisk.DISK(), (img,), lambda: tdisk.DISK()),
        "dense_disk": (jdisk.DISKUnet(up=(64, 64, 64, 129)), (img,), lambda: tdisk.DISKUnet()),
        "keynet": (jkn.KeyNetHardNet(), (img[0],), lambda: tkn.KeyNetHardNet()),
        "dinov2_vits14": (jvit.DinoViT(img_size=224, embed_dim=384, depth=12, num_heads=6,
                                       num_register_tokens=0), (jnp.zeros((1, 224, 224, 3)),),
                          lambda: DinoViT(img_size=224, embed_dim=384, depth=12, num_heads=6,
                                          num_register_tokens=0)),
    }
    for cfg in jal.ALIKED_CFGS:
        out[cfg] = (jal.ALIKED(model_name=cfg), (img,), lambda cfg=cfg: tal.ALIKED(cfg))
    return out


SLICE = ["lightglue", "superglue", "aliked-t16", "aliked-n16", "aliked-n16rot", "aliked-n32",
         "disk", "dense_disk", "keynet", "dinov2_vits14"]


@pytest.mark.parametrize("name", SLICE)
def test_module_params_to_jax_is_the_inverse_of_the_bridge(name):
    """For every module of the matching slice: the port's state dict as a
    flax tree has exactly the JAX module's variables (paths and shapes, from
    ``jax.eval_shape``), and the bridge carries it back bit for bit."""
    import torch

    from comet_tpu_torch.models.blocks import init_params

    jmod, args, make = _slice_modules()[name]
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)
    module = make()
    init_params(module, torch.Generator().manual_seed(0))
    tree = module_params_to_jax(module)
    assert _paths(tree) == _paths(jax.tree_util.tree_map(lambda a: np.zeros(a.shape), shapes))
    sd = module_params_from_jax(tree, module)
    want = module.state_dict()
    assert set(sd) == set(want)
    for key, value in want.items():
        assert torch.equal(sd[key], value), key
    # numpy f32 leaves, every map's keys in order (as JAX's tree utilities give it)
    leaves = jax.tree_util.tree_leaves(tree)
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float32 for a in leaves)
