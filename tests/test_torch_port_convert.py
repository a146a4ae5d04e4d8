"""The port's checkpoint converter (``comet_tpu_torch/utils/convert_torch_weights.py``)
against the JAX package's tool (``tools/convert_torch_weights.py``).

The reference checkpoints are made here from a seed, in the reference's
layout (torch's Conv2d / Linear / packed in_proj layouts, DINOv2's stored
1 + 37 x 37 ``pos_embed`` rows, a ``module.`` prefix and a ``{"model": ...}``
wrapper), as the inverse of a random flax tree of
``tests/test_torch_port_models.py``. Both converters take the same state
dict: the tool with its template from ``jax.eval_shape`` of the JAX COMET,
the port with its own (``comet_template``, a ``device="meta"`` model), and
their trees must be equal leaf for leaf, bit for bit and dtype for dtype.
The mappings and the template are compared at full width (no arrays: names,
shapes and dtypes), the conversions at the tiny config of
``test_torch_port_models``.

The slice as a whole: the port's COMET loaded from the ``.msgpack`` that the
port's ``main()`` wrote runs against the JAX COMET on the tool's tree, with
the tolerances of ``test_torch_port_models.test_forward_matches_jax``:
2e-2 px on tracks, 5e-3 on visibilities, scores and poses.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comet_tpu.config as jcfg
import comet_tpu_torch.config as tcfg
from comet_tpu.matching.lightglue import LightGlueMatcher as JaxLightGlue
from comet_tpu.models import COMET as JaxCOMET
from comet_tpu.models.superpoint import SuperPointBackbone as JaxSuperPoint
from comet_tpu.utils.serialization import load_params_msgpack as jax_load_msgpack
from comet_tpu_torch import cli as tcli
from comet_tpu_torch.matching.lightglue import LightGlueMatcher
from comet_tpu_torch.models import build_comet
from comet_tpu_torch.models.blocks import init_params
from comet_tpu_torch.models.superpoint import SuperPointBackbone
from comet_tpu_torch.utils import convert_torch_weights as port
from comet_tpu_torch.utils.serialization import load_params_msgpack
from comet_tpu_torch.weights import module_params_from_jax, module_params_to_jax
from test_torch_port_models import _inputs, _random_tree, _tiny

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tools"))
import convert_torch_weights as tool  # noqa: E402

# each preset's camera switches (config.PRESETS)
_SWITCHES = {
    "ours": {},
    "abl_all": dict(use_trajectory=False, use_time=False, use_gapr=False),
    "abl_track": dict(use_trajectory=False),
    "abl_time": dict(use_time=False),
    "abl_uvz": dict(use_gapr=False),
}
_STORED_GRID = 37  # DINOv2's stored pos_embed grid (518 px / 14)
_LG = dict(depth=2, dim=32, num_heads=4, filter_threshold=0.0)


def _zeros(shapes):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _inverse(mapping, flat, rng, prefix="module."):
    """The reference-layout state dict (torch tensors) whose conversion by
    ``mapping`` gives ``flat``, but for the ``pos_embed``, drawn at the
    stored grid."""
    sd = {}
    for path, value in flat.items():
        tk, tf = mapping[path]
        value = np.asarray(value)
        if tf.__name__ == "t_conv":
            value = value.transpose(3, 2, 0, 1)
        elif tf.__name__ == "t_linear":
            value = value.T
        elif tf.__name__ == "resample_pos_embed":
            value = 0.1 * rng.normal(size=(1, 1 + _STORED_GRID ** 2, value.shape[-1]))
        sd[prefix + tk] = torch.from_numpy(np.ascontiguousarray(value, np.float32))
    return sd


@pytest.fixture(scope="module")
def presets():
    """Per preset at the tiny config: both configs, the JAX template (zeros,
    as the tool's ``main`` makes it), a seeded reference state dict (with
    its ``module.`` prefix) and the tool's tree of it."""
    out = {}
    for i, (name, switches) in enumerate(_SWITCHES.items()):
        jc, tc = _tiny(jcfg, **switches), _tiny(tcfg, **switches)
        images, queries = _inputs(jc)
        shapes = jax.eval_shape(JaxCOMET(jc).init, jax.random.PRNGKey(0), jnp.asarray(images),
                                jnp.asarray(queries))
        flat = tool.flatten_params(_random_tree(shapes, seed=20 + i)["params"])
        sd = _inverse(tool.build_mapping(jc), flat, np.random.default_rng(30 + i))
        template = _zeros(shapes)
        want, missing, unmapped = tool.convert(sd, template, jc)
        assert not missing and not unmapped
        out[name] = dict(jc=jc, tc=tc, sd=sd, template=template, want=want, images=images,
                         queries=queries)
    return out


def _assert_same_tree(got, want):
    got, want = tool.flatten_params(got), tool.flatten_params(want)
    assert sorted(got) == sorted(want)
    for path in want:
        g, w = np.asarray(got[path]), np.asarray(want[path])
        assert g.dtype == w.dtype, path
        assert g.shape == w.shape and np.array_equal(g, w), path


@pytest.mark.parametrize("preset", list(_SWITCHES))
def test_build_mapping_matches_the_tool(preset):
    """Full width: the same flax paths, torch keys and transforms."""
    want = tool.build_mapping(jcfg.get_config(preset))
    got = port.build_mapping(tcfg.get_config(preset))
    assert sorted(got) == sorted(want)
    for path, (tk, tf) in want.items():
        assert got[path][0] == tk, path
        assert got[path][1].__name__ == tf.__name__, path


def test_template_matches_jax_eval_shape():
    """Full width: the port's ``ours`` template has the paths, shapes and
    dtypes of ``jax.eval_shape(COMET(cfg).init)``, and holds no memory."""
    shapes = jax.eval_shape(JaxCOMET(jcfg.get_config("ours")).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, 64, 64, 3)), jnp.full((1, 8, 2), 32.0))
    want = tool.flatten_params(shapes["params"])
    template = port.comet_template(tcfg.get_config("ours"))
    assert set(template) == set(shapes) == {"params"}
    got = port.flatten_params(template["params"])
    assert sorted(got) == sorted(want)
    for path, s in want.items():
        assert got[path].shape == s.shape and got[path].dtype == s.dtype, path
        assert got[path].strides == (0,) * got[path].ndim, path
    assert sum(v.size for v in got.values()) == 250_714_797


@pytest.mark.parametrize("preset", list(_SWITCHES))
def test_convert_matches_the_tool(preset, presets, tmp_path, monkeypatch, capsys):
    """A seeded reference checkpoint converts exactly as the tool converts
    it, in memory and through ``main()``: its ``.msgpack`` read by the JAX
    package's reader is the tool's tree."""
    p = presets[preset]
    got, missing, unmapped = port.convert(p["sd"], port.comet_template(p["tc"]), p["tc"])
    assert not missing and not unmapped
    _assert_same_tree(got, p["want"])

    path, out = str(tmp_path / "best.bin"), str(tmp_path / "best.msgpack")
    torch.save({"model": p["sd"], "epoch": 3}, path)
    monkeypatch.setattr(tcfg, "get_config", lambda name="ours": p["tc"])
    port.main(["--bin", path, "--preset", preset, "--out", out])
    assert capsys.readouterr().out.strip() == f"wrote {out} (0 missing, 0 unmapped)"
    _assert_same_tree(jax_load_msgpack(out, p["template"]), p["want"])


def test_strict_missing_and_shape_errors_match_the_tool(presets):
    p = presets["ours"]
    template = port.comet_template(p["tc"])
    dropped = dict(p["sd"])
    dropped.pop("module.camera_predictor.pose_branch.fc1.weight")
    dropped.pop("module.track_predictor.fine_fnet.conv1.bias")
    for strict_raises in (tool.convert, port.convert):
        with pytest.raises(KeyError, match="missing torch keys for 2 leaves"):
            strict_raises(dropped, p["template"] if strict_raises is tool.convert else template,
                          p["jc"] if strict_raises is tool.convert else p["tc"])
    want = tool.convert(dropped, p["template"], p["jc"], strict=False)
    got = port.convert(dropped, template, p["tc"], strict=False)
    assert got[1] == want[1] and len(got[1]) == 2 and got[2] == want[2] == []
    _assert_same_tree(got[0], want[0])  # the missing leaves keep the template's zeros

    bad = dict(p["sd"])
    key = "module.camera_predictor.pose_branch.fc1.weight"
    bad[key] = bad[key][:, :-1]
    for fn, tmpl, cfg in ((tool.convert, p["template"], p["jc"]), (port.convert, template,
                                                                     p["tc"])):
        with pytest.raises(ValueError, match="shape mismatch for camera_predictor/pose_branch"):
            fn(bad, tmpl, cfg)


def test_self_test_passes_for_every_preset(monkeypatch, capsys):
    """``--self-test`` (at the tiny config here; phase 19 of chip_smoke.py
    runs it at full width) reports every leaf mapped for the five presets."""
    tiny = {name: _tiny(tcfg, **switches) for name, switches in _SWITCHES.items()}
    monkeypatch.setattr(tcfg, "get_config", lambda name="ours": tiny[name])
    with pytest.raises(SystemExit) as done:
        port.main(["--self-test"])
    assert done.value.code == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split("]")[0] for ln in lines] == [f"self-test[{p}" for p in _SWITCHES]
    assert all(ln.endswith("0 missing, 0 unmapped") for ln in lines)


def test_a_checkpoint_torch_refuses_raises_naming_it(tmp_path):
    """``torch.load`` with its default ``weights_only``: a pickled object it
    will not load raises naming the file, and is never loaded unsafely."""
    path = str(tmp_path / "unsafe.bin")
    torch.save({"model": {"w": torch.zeros(2)}, "extra": _Unsafe()}, path)
    with pytest.raises(ValueError, match="unsafe.bin: torch.load refused"):
        port.load_reference(path)
    assert not _Unsafe.loaded
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="junk.bin"):
        port.load_reference(str(junk))


class _Unsafe:
    loaded = False

    def __setstate__(self, state):
        type(self).loaded = True


def test_converted_forward_matches_jax(presets, tmp_path, monkeypatch, capsys):
    """The slice as a whole: the ``.msgpack`` that ``main()`` wrote, through
    the port's reader into its COMET, against the JAX COMET on the tool's
    tree; then ``cli.py eval --checkpoint`` on a fixture prints a finite
    row."""
    from comet_tpu_torch.data.fixtures import generate_amd_fixture

    p = presets["ours"]
    path, out = str(tmp_path / "best.bin"), str(tmp_path / "best.msgpack")
    torch.save({"model": p["sd"]}, path)
    monkeypatch.setattr(tcfg, "get_config", lambda name="ours": p["tc"])
    port.main(["--bin", path, "--out", out])
    model = load_params_msgpack(out, build_comet(p["tc"], device="cpu", seed=9))
    with torch.no_grad():
        got = model(torch.from_numpy(p["images"]), torch.from_numpy(p["queries"]))
    want = jax.jit(JaxCOMET(p["jc"]).apply)(p["want"], jnp.asarray(p["images"]),
                                             jnp.asarray(p["queries"]))
    tol = dict(coarse_track=2e-2, pred_track=2e-2, track_vis=5e-3, track_score=5e-3,
               pred_pose_enc=5e-3)
    assert set(got) == set(want) == set(tol)
    for key, t in tol.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=t, rtol=t,
                                   err_msg=key)

    root = generate_amd_fixture(str(tmp_path / "AMD_eval"), n_seqs=1, n_frames=4,
                                img_hw=(96, 128), seed=2)
    capsys.readouterr()
    tcli.main(["eval", "--data-root", root, "--keypoints", "grid", "--max-sequences", "1",
               "--checkpoint", out, "--device", "cpu", "--output-dir", str(tmp_path / "eval")])
    assert "sequences/sec:" in capsys.readouterr().out
    with open(tmp_path / "eval" / "test_results.csv") as f:
        header, row = f.read().splitlines()[:2]
    values = dict(zip(header.split(","), row.split(",")))
    assert values and all(np.isfinite(float(v)) for k, v in values.items() if k != "sec/it")


def _lightglue_release(rng, prefix="matcher."):
    """A seeded official-layout LightGlue state dict (depth 2, width 32, the
    release's ``self_attn.{i}`` / ``cross_attn.{i}`` names, no
    ``input_proj``: its input width is its width)."""
    mapping = tool.build_lightglue_mapping(_LG["depth"])
    flat = tool.flatten_params(module_params_to_jax(_port_lightglue(0))["params"])
    sd = {}
    for path, value in flat.items():
        if path.startswith("input_proj"):
            continue
        tk, tf = mapping[path]
        value = (value.T if tf.__name__ == "t_linear" else value) + 0.05 * rng.normal(
            size=value.shape[::-1] if tf.__name__ == "t_linear" else value.shape)
        tk = re.sub(r"^transformers\.(\d+)\.(self_attn|cross_attn)\.", r"\2.\1.", tk)
        sd[prefix + tk] = torch.from_numpy(np.ascontiguousarray(value, np.float32))
    return sd


def _port_lightglue(seed):
    m = LightGlueMatcher(**_LG)
    init_params(m, torch.Generator().manual_seed(seed))
    return m.eval()


def test_lightglue_matches_the_tool_and_jax():
    """``convert_lightglue``: the release renames, the prefixes, the Identity
    ``input_proj`` (identity kernel, zero bias) and ``strict``, as the tool
    does; the converted matcher's matches on a pair equal JAX's."""
    rng = np.random.default_rng(5)
    sd = _lightglue_release(rng)
    assert any(k.startswith("matcher.self_attn.1.") for k in sd)
    assert not any("transformers" in k or "input_proj" in k for k in sd)
    m = _port_lightglue(1)
    template = module_params_to_jax(m)
    want, w_missing, w_unmapped = tool.convert_lightglue(sd, template, depth=_LG["depth"])
    got, missing, unmapped = port.convert_lightglue(sd, template, depth=_LG["depth"])
    assert (missing, unmapped) == (w_missing, w_unmapped) == ([], [])
    _assert_same_tree(got, want)
    assert np.array_equal(got["params"]["input_proj"]["kernel"], np.eye(32, dtype=np.float32))
    assert not got["params"]["input_proj"]["bias"].any()

    dropped = dict(sd)
    dropped.pop("matcher.cross_attn.0.to_v.bias")
    for fn in (tool.convert_lightglue, port.convert_lightglue):
        with pytest.raises(KeyError, match="missing torch keys for 1 leaves"):
            fn(dropped, template, depth=_LG["depth"])
    w = tool.convert_lightglue(dropped, template, depth=_LG["depth"], strict=False)
    g = port.convert_lightglue(dropped, template, depth=_LG["depth"], strict=False)
    assert g[1] == w[1] == [("transformers_0/cross_attn/to_v/bias",
                             "transformers.0.cross_attn.to_v.bias")]
    _assert_same_tree(g[0], w[0])

    # the converted matcher on a pair: port against JAX, both from the tree
    r = np.random.default_rng(6)
    k0, k1 = (r.uniform(-1, 1, (n, 2)).astype(np.float32) for n in (24, 20))
    d0, d1 = (r.normal(size=(n, 32)).astype(np.float32) for n in (24, 20))
    m.load_state_dict(module_params_from_jax(got, m))
    with torch.no_grad():
        out = m(*(torch.from_numpy(a) for a in (k0, d0, k1, d1)))
    jm = JaxLightGlue(**_LG)
    ref = jax.jit(jm.apply)(want, *(jnp.asarray(a) for a in (k0, d0, k1, d1)))
    assert (np.asarray(ref["matches0"]) >= 0).sum() > 0
    np.testing.assert_array_equal(out["matches0"].numpy(), np.asarray(ref["matches0"]))
    np.testing.assert_array_equal(out["matches1"].numpy(), np.asarray(ref["matches1"]))
    np.testing.assert_allclose(out["log_assignment"].numpy(), np.asarray(ref["log_assignment"]),
                               atol=1e-4, rtol=1e-4)


def test_superpoint_matches_the_tool_and_its_errors():
    """``convert_superpoint`` on a seeded ``superpoint_v1`` layout (``model.``
    prefix): the tool's tree; a layer the template lacks and a key the state
    dict lacks raise KeyError, a wrong shape ValueError, in both."""
    rng = np.random.default_rng(7)
    template = module_params_to_jax(SuperPointBackbone())
    flat = tool.flatten_params(template["params"])
    sd = {}
    for name in tool.SUPERPOINT_LAYERS:
        kernel = flat[f"{name}/kernel"]
        sd[f"model.{name}.weight"] = torch.from_numpy(
            rng.normal(size=kernel.shape[::-1][:2] + kernel.shape[:2]).astype(np.float32))
        sd[f"model.{name}.bias"] = torch.from_numpy(
            rng.normal(size=flat[f"{name}/bias"].shape).astype(np.float32))
    jax_template = _zeros(jax.eval_shape(JaxSuperPoint().init, jax.random.PRNGKey(0),
                                         jnp.zeros((1, 16, 16, 1))))
    want = tool.convert_superpoint(sd, jax_template)
    _assert_same_tree(port.convert_superpoint(sd, template), want)
    _assert_same_tree(port.convert_superpoint(sd, jax_template), want)

    no_leaf = {"params": {k: v for k, v in template["params"].items() if k != "convDb"}}
    no_key = {k: v for k, v in sd.items() if k != "model.conv3a.bias"}
    bad = dict(sd, **{"model.convPa.weight": sd["model.convPa.weight"][:, :-1]})
    for fn in (tool.convert_superpoint, port.convert_superpoint):
        with pytest.raises(KeyError, match="template has no leaf convDb/kernel"):
            fn(sd, no_leaf)
        with pytest.raises(KeyError, match="state_dict has no key conv3a.bias"):
            fn(no_key, template)
        with pytest.raises(ValueError, match="shape mismatch for convPa/kernel"):
            fn(bad, template)
    model = SuperPointBackbone()
    model.load_state_dict(module_params_from_jax(want, model))


def test_the_converter_imports_no_jax():
    code = ("import sys; import comet_tpu_torch.utils.convert_torch_weights; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'comet_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
