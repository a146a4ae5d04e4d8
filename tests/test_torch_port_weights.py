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
from comet_tpu_torch.weights import convert_leaf, params_from_jax, state_dict_from_flax

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
