"""The one-time inference cast (``utils.serialization``) against the JAX
package's ``cast_params_for_inference``, and where the port uses it.

JAX casts the whole parameter tree to the compute dtype once before it
times or serves inference (``bench_lib.run_benchmark``,
``run_eval_data_benchmark``, the CLI's ``_init_model(inference=True)``);
training keeps f32 masters. The port casts every floating parameter in
place; its norms then read their bf16 scale and bias in f32, as JAX's do.

Both packages run bf16 on the CPU on the same weights, cast. Tolerances:
the port's forward on cast parameters equals, bit for bit, its forward on
f32 masters that hold the same bf16 values (the cast moves the rounding,
not the numbers); modules against JAX within 3e-2 of the output's largest
value (chip_smoke.py's REF_RTOL for bf16: PyTorch and XLA round at
different points, and a stack of bf16 blocks drifts by ~1 % of its range;
a parameter read at the wrong precision moves a norm's output by its
scale's bf16 step, 2^-8 of it, in every row). The whole forward is chaotic
in bf16 with random weights (the trackers amplify a rounding step into
pixels: 8-13 px between the two packages here, and as much between each
package's own f32-master and cast forwards), so it is held to its
invariants and its poses only to 0.1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comet_tpu.config as jcfg
import comet_tpu_torch.config as tcfg
from comet_tpu.models import COMET as JaxCOMET
from comet_tpu.models import camera_predictor as jcp
from comet_tpu.models import tracker as jtracker
from comet_tpu.models import update_former as juf
from comet_tpu.utils import cast_params_for_inference as jax_cast
from comet_tpu_torch import bench_lib, cli
from comet_tpu_torch.models import build_comet
from comet_tpu_torch.models.tracker import tracker_transformer_dim
from comet_tpu_torch.utils.serialization import cast_params_for_inference, load_params, save_params
from comet_tpu_torch.weights import params_from_jax
from test_torch_port_models import _inputs, _jax_params, _t, _tiny
from test_torch_port_route import _on_fused_route

REF_RTOL = 3e-2
ROUTES = {"default": tcfg.KernelRoute(), "fused": tcfg.FUSED_ROUTE}


@pytest.fixture(scope="module")
def bf16():
    """The tiny config in bf16 on both sides, its weights and inputs."""
    jc = _tiny(jcfg).replace(compute_dtype="bfloat16")
    tc = _tiny(tcfg).replace(compute_dtype="bfloat16")
    images, queries = _inputs(jc)
    params = _jax_params(jc, images, queries, seed=1)
    cast = jax_cast({"params": params}, jnp.bfloat16)
    return dict(jc=jc, tc=tc, images=images, queries=queries, params=params, cast=cast)


def _cast_port(bf16, route):
    model = build_comet(bf16["tc"], device="cpu", route=ROUTES[route])
    model.load_state_dict(params_from_jax({"params": bf16["params"]}, bf16["tc"]))
    return cast_params_for_inference(model, torch.bfloat16)


def _run_jax(route, fn, *args):
    return _on_fused_route(fn, *args) if route == "fused" else fn(*args)


def test_cast_makes_every_floating_tensor_the_compute_dtype():
    cfg = _tiny(tcfg)
    model = build_comet(cfg, device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.float32}  # build keeps f32 masters
    assert cast_params_for_inference(model, torch.bfloat16) is model
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert all(not b.is_floating_point() or b.dtype == torch.bfloat16 for b in model.buffers())
    again = build_comet(cfg, device="cpu")
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q.bfloat16()), name


@pytest.mark.parametrize("route", list(ROUTES))
def test_cast_forward_equals_the_rounded_masters(bf16, route):
    sd = params_from_jax({"params": bf16["params"]}, bf16["tc"])
    masters = build_comet(bf16["tc"], device="cpu", route=ROUTES[route])
    masters.load_state_dict({k: v.bfloat16().float() for k, v in sd.items()})
    cast = _cast_port(bf16, route)
    with torch.no_grad():
        want = masters(_t(bf16["images"]), _t(bf16["queries"]))
        got = cast(_t(bf16["images"]), _t(bf16["queries"]))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


def _module_cases(bf16):
    """(name, JAX call, port call): the modules that read parameters in f32
    (LayerNorm scales and biases, GroupNorm, LayerScale, tokens, position
    embeddings), each on inputs of its own."""
    cast, jc = bf16["cast"]["params"], bf16["jc"]
    rng = np.random.default_rng(10)
    tdim = tracker_transformer_dim(2, 2, 16, False)
    xu = rng.normal(size=(1, 128, 4, tdim)).astype(np.float32)  # rows over the K2-K4 gates
    images = rng.normal(size=(1, 2, 40, 40, 3)).astype(np.float32)
    traj = (rng.random((1, 2, 6, 2)) * 40).astype(np.float32)
    conf = rng.random((1, 2, 6)).astype(np.float32)
    fmaps = rng.normal(size=(1, 2, 8, 8, 16)).astype(np.float32)
    queries = (rng.random((1, 8, 2)) * 50 + 5).astype(np.float32)
    cc = jc.camera
    ckw = dict(hidden_size=cc.hidden_size, num_heads=cc.num_heads, att_depth=cc.att_depth,
               trunk_depth=cc.trunk_depth, down_size=cc.down_size,
               backbone_depth=cc.backbone_depth, backbone_dim=cc.backbone_dim,
               backbone_heads=cc.backbone_heads)
    tkw = dict(stride=4, corr_levels=2, corr_radius=2, latent_dim=16, hidden_size=32, depth=2)
    bf = jnp.bfloat16
    return {
        "update-former": (
            lambda: juf.EfficientUpdateFormer(space_depth=2, time_depth=2, hidden_size=32,
                                              output_dim=18, dtype=bf).apply(
                {"params": cast["coarse_tracker"]["updateformer"]}, jnp.asarray(xu)),
            lambda m: m.coarse_tracker.updateformer(_t(xu))),
        "camera predictor": (
            lambda: jcp.CameraPredictor(**ckw, dtype=bf).apply(
                {"params": cast["camera_predictor"]},
                *map(jnp.asarray, (images, traj, conf))).pred_pose_enc,
            lambda m: m.camera_predictor(_t(images), _t(traj), _t(conf)).pred_pose_enc),
        "coarse tracker": (
            lambda: jtracker.BaseTracker(**tkw, dtype=bf).apply(
                {"params": cast["coarse_tracker"]}, jnp.asarray(queries),
                jnp.asarray(fmaps, bf), iters=1, down_ratio=2).coord_preds,
            lambda m: m.coarse_tracker(_t(queries), _t(fmaps).bfloat16(), iters=1,
                                       down_ratio=2).coord_preds),
    }


@pytest.mark.parametrize("module", ["update-former", "camera predictor", "coarse tracker"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_cast_modules_match_jax(bf16, route, module):
    jax_fn, port_fn = _module_cases(bf16)[module]
    want = np.asarray(_run_jax(route, jax.jit(jax_fn)).astype(jnp.float32))
    with torch.no_grad():
        got = port_fn(_cast_port(bf16, route)).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= REF_RTOL * scale


@pytest.mark.parametrize("route", list(ROUTES))
def test_cast_forward_matches_jax(bf16, route):
    want = _run_jax(route, jax.jit(JaxCOMET(bf16["jc"]).apply), bf16["cast"],
                    jnp.asarray(bf16["images"]), jnp.asarray(bf16["queries"]))
    with torch.no_grad():
        got = _cast_port(bf16, route)(_t(bf16["images"]), _t(bf16["queries"]))
    assert set(got) == set(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key
        assert torch.isfinite(got[key].float()).all(), key
    np.testing.assert_allclose(got["pred_track"][:, 0].numpy(), bf16["queries"], atol=1e-6)
    np.testing.assert_array_equal(got["pred_pose_enc"][:, 0].numpy(), [[0, 0, 0, 1, 0, 0, 0]])
    np.testing.assert_allclose(got["pred_pose_enc"].numpy(),
                               np.asarray(want["pred_pose_enc"], np.float32), atol=0.1)


# ------------------------------------------------ where the cast is used


def _spy_build(monkeypatch, module):
    built = []
    real = module.build_comet

    def spy(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(module, "build_comet", spy)
    return built


def test_run_benchmark_times_the_cast_model(monkeypatch):
    built = _spy_build(monkeypatch, bench_lib)
    cfg = _tiny(tcfg).replace(compute_dtype="bfloat16")
    out = bench_lib.run_benchmark(cfg, warmup=0, reps=1, device="cpu")
    assert out["value"] > 0
    assert len(built) == 1 and {p.dtype for p in built[0].parameters()} == {torch.bfloat16}


def test_run_eval_data_benchmark_times_the_cast_model(monkeypatch):
    built = _spy_build(monkeypatch, bench_lib)
    cfg = _tiny(tcfg).replace(compute_dtype="bfloat16", track_num=16, min_track_num=8)
    out = bench_lib.run_eval_data_benchmark(cfg, max_sequences=1, eval_batch=1, device="cpu")
    assert out["value"] > 0 and out["n_sequences"] == 1
    assert len(built) == 1 and {p.dtype for p in built[0].parameters()} == {torch.bfloat16}


@pytest.mark.parametrize("inference,dtype", [(True, torch.bfloat16), (False, torch.float32)])
def test_the_cli_casts_for_inference_only(inference, dtype):
    cfg = _tiny(tcfg).replace(compute_dtype="bfloat16")
    model = cli._init_model(cfg, seed=2, inference=inference, device="cpu")
    assert {p.dtype for p in model.parameters()} == {dtype}


def test_save_and_load_params(tmp_path):
    cfg = _tiny(tcfg)
    model = build_comet(cfg, device="cpu", seed=3)
    path = save_params(str(tmp_path / "w" / "best.pt"), model)
    other = load_params(path, build_comet(cfg, device="cpu", seed=4))
    for (name, p), q in zip(model.state_dict().items(), other.state_dict().values()):
        assert torch.equal(p, q), name
    with pytest.raises(ValueError, match="params_from_jax"):
        load_params(str(tmp_path / "best.msgpack"), model)
    with pytest.raises(ValueError, match="params_from_jax"):
        save_params(str(tmp_path / "best.msgpack"), model)
