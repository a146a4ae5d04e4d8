"""The port's other kernel route (``FUSED_ROUTE``: block off, cross on,
LayerNorm on) and its kernels K3, K4 and K5 against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode, with its switches
``COMET_FUSED_BLOCK=0 COMET_FUSED_CROSS=1 COMET_FUSED_LN=1`` set around the
JAX call only (JAX reads them when it traces). Both run in f32 on the same
numpy inputs unless a test says bf16. The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_port_cuda.py and
chip_smoke.py.

Tolerances: 2e-5 for attention and 3e-5 for a whole block, as the K1 and K2
tests (float reassociation in a few f32 products); 1e-5 for LayerNorm in
f32 and 3e-2 in bf16 (one bf16 rounding of values up to ~4), as
tests/test_pallas_norm.py; 5e-5 for the update-former, and the
whole-forward tolerances, as the default route's tests in
tests/test_torch_port_models.py.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comet_tpu.config as jcfg
import comet_tpu_torch.config as tcfg
from comet_tpu.geometry import cameras as jcam
from comet_tpu.models import COMET as JaxCOMET
from comet_tpu.models import update_former as juf
from comet_tpu.models.blocks import CrossAttnBlock as JaxCrossAttnBlock
from comet_tpu.models.comet import decode_predictions as jax_decode_predictions
from comet_tpu.ops.pallas_attn import fused_attention as jax_fused_attention
from comet_tpu.ops.pallas_block import fused_cross_block as jax_fused_cross_block
from comet_tpu.ops.pallas_norm import _ln as jax_ln
from comet_tpu_torch.config import FUSED_ROUTE, KernelRoute
from comet_tpu_torch.geometry import cameras as tcam
from comet_tpu_torch.models import blocks as tblocks
from comet_tpu_torch.models import build_comet, decode_predictions
from comet_tpu_torch.models.blocks import CrossAttnBlock
from comet_tpu_torch.models.update_former import EfficientUpdateFormer
from comet_tpu_torch.ops import attn as tattn
from comet_tpu_torch.ops.attn import fused_attention, is_short, short_attention
from comet_tpu_torch.ops.block import fused_cross_block
from comet_tpu_torch.ops.norm import fused_layer_norm
from comet_tpu_torch.weights import params_from_jax, state_dict_from_flax
from test_torch_port_models import _cameras, _close, _inputs, _jax_params, _random_tree, _t, _tiny

JAX_FUSED_ROUTE = dict(COMET_FUSED_BLOCK="0", COMET_FUSED_CROSS="1", COMET_FUSED_LN="1")


def _on_fused_route(fn, *args, **kwargs):
    """Run a JAX function with the switches of the fused route set."""
    with pytest.MonkeyPatch.context() as mp:
        for key, value in JAX_FUSED_ROUTE.items():
            mp.setenv(key, value)
        return fn(*args, **kwargs)


# ------------------------------------------------------------------- K3


def _qkv(b, lq, lk, c, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, c)).astype(np.float32) for n in (lq, lk, lk)]


@pytest.mark.parametrize(
    "b,lq,lk,c,h",
    [
        (32, 16, 16, 64, 4),  # JAX packed Pallas kernel, D 16
        (48, 16, 16, 96, 2),  # packed, batch padded and cropped
        (40, 12, 12, 48, 3),  # packed, L not a multiple of 8
    ],
)
def test_k3_matches_jax_packed_kernel(b, lq, lk, c, h):
    assert is_short(b, lq, lk)
    q, k, v = _qkv(b, lq, lk, c)
    want = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h))
    for fn in (short_attention, fused_attention):
        got = fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_k3_keeps_sequences_apart():
    q, k, v = (torch.from_numpy(a) for a in _qkv(64, 16, 16, 64, seed=1))
    for t in (q, k, v):
        t[1] = t[0]
    out = short_attention(q, k, v, 4)
    torch.testing.assert_close(out[1], out[0], atol=1e-6, rtol=0)
    k2 = k.clone()
    k2[1] += 10.0
    out2 = short_attention(q, k2, v, 4)
    torch.testing.assert_close(out2[0], out[0], atol=1e-6, rtol=0)
    assert not torch.allclose(out2[1], out[1])


@pytest.mark.parametrize(
    "b,lq,lk,short",
    [
        (576, 16, 16, True),  # coarse time blocks, unfused
        (16, 64, 64, True),  # coarse virtual blocks, unfused
        (512, 16, 16, True),  # fine time blocks, unfused
        (1, 16, 16, False),  # the camera trunk: 16 rows, K1
        (16, 64, 512, False),  # virtual<-point, K1 when unfused
        (16, 512, 64, False),  # point<-virtual
        (16, 1, 512, False),  # trajectory cross
    ],
)
def test_attention_regime_split_follows_jax(b, lq, lk, short):
    assert is_short(b, lq, lk) is short


# ------------------------------------------------------------------- K4


def _cross_params(c, hidden, seed):
    """The JAX kernel's arguments after x and ctx, in its [in, out] layout."""
    rng = np.random.default_rng(seed)
    s = 0.1
    return dict(
        gamma=1.0 + rng.normal(size=(c,)) * s, beta=rng.normal(size=(c,)) * s,
        wq=rng.normal(size=(c, c)) * s, bq=rng.normal(size=(c,)) * s,
        wkv=rng.normal(size=(c, 2 * c)) * s, bkv=rng.normal(size=(2 * c,)) * s,
        wout=rng.normal(size=(c, c)) * s, bout=rng.normal(size=(c,)) * s,
        w1=rng.normal(size=(c, hidden)) * s, b1=rng.normal(size=(hidden,)) * s,
        w2=rng.normal(size=(hidden, c)) * s, b2=rng.normal(size=(c,)) * s,
    )


@pytest.mark.parametrize(
    "b,lq,lk,c,h",
    [
        (37, 16, 48, 64, 4),  # several sequences per JAX block, batch padded
        (8, 32, 128, 64, 4),  # context longer than the queries
        (4, 128, 32, 64, 4),  # queries longer than the context
        # Lq 16 and 32 (several sequences per 64-row CUDA tile) against Lk 1,
        # 63 and 65 (one key; one key tile short of 64; one key past it)
        (16, 16, 1, 64, 4),
        (16, 16, 63, 64, 4),
        (16, 16, 65, 64, 4),
        (8, 32, 1, 64, 4),
        (8, 32, 63, 64, 4),
        (8, 32, 65, 64, 4),
    ],
)
def test_k4_matches_jax_cross_kernel(b, lq, lk, c, h):
    p = _cross_params(c, 4 * c, seed=3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(b, lq, c)).astype(np.float32)
    ctx = rng.normal(size=(b, lk, c)).astype(np.float32)
    want = np.asarray(jax_fused_cross_block(
        jnp.asarray(x), jnp.asarray(ctx), *(jnp.asarray(a, jnp.float32) for a in p.values()),
        num_heads=h,
    ))
    # the port's weights are [out, in]
    port = [torch.from_numpy(np.ascontiguousarray(a.T).astype(np.float32)) for a in p.values()]
    got = fused_cross_block(torch.from_numpy(x), torch.from_numpy(ctx), *port, h)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)


@pytest.mark.parametrize("b,lq,lk", [(8, 32, 128), (16, 64, 96)])
def test_cross_attn_block_on_the_route_matches_jax(b, lq, lk):
    c, h = 64, 4
    rng = np.random.default_rng(5)
    x = rng.normal(size=(b, lq, c)).astype(np.float32)
    ctx = rng.normal(size=(b, lk, c)).astype(np.float32)
    blk = JaxCrossAttnBlock(num_heads=h)
    shapes = jax.eval_shape(blk.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ctx))
    params = _random_tree(shapes, seed=6)
    want = np.asarray(_on_fused_route(blk.apply, params, jnp.asarray(x), jnp.asarray(ctx)))
    port = CrossAttnBlock(c, h)
    port.load_state_dict(state_dict_from_flax(params, port.state_dict()))
    tblocks.set_route(port, FUSED_ROUTE)
    calls = []
    real = tblocks.fused_cross_block
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tblocks, "fused_cross_block", lambda *a: calls.append(1) or real(*a))
        with torch.no_grad():
            got = port(torch.from_numpy(x), torch.from_numpy(ctx))
    assert calls == [1]  # the module's gate sent it to K4
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)


# ------------------------------------------------------------------- K5


@pytest.mark.parametrize("m,c", [(256, 384), (300, 768), (7, 48)])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_matches_jax_ln_kernel(m, c, affine, dtype):
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(m, c)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=(c,)).astype(np.float32) if affine else np.ones(c, np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32) if affine else np.zeros(c, np.float32)
    want = np.asarray(
        jax_ln(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(scale), jnp.asarray(bias), 1e-6),
        np.float32,
    )
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = fused_layer_norm(xt, *((_t(scale), _t(bias)) if affine else (None, None)), eps=1e-6)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-5 if dtype == "float32" else 3e-2)


def test_k5_takes_scale_and_bias_together():
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="together"):
        fused_layer_norm(x, torch.ones(16), None)


# ------------------------------------------- the route through the models


class _Census:
    """Counts the calls of each kernel wrapper as the models reach them."""

    def __init__(self, mp):
        self.calls = dict(k2=0, k3=0, k4=0, k5=0)
        for mod, name, key in (
            (tblocks, "fused_attn_block", "k2"), (tattn, "short_attention", "k3"),
            (tblocks, "fused_cross_block", "k4"), (tblocks, "fused_layer_norm", "k5"),
        ):
            real = getattr(mod, name)
            mp.setattr(mod, name, self._spy(real, key))

    def _spy(self, real, key):
        def spy(*args, **kwargs):
            self.calls[key] += 1
            return real(*args, **kwargs)
        return spy


@pytest.fixture(scope="module")
def update_former():
    """A coarse update-former at a size where every JAX gate passes: 128
    tracks and 64 virtual tracks over 4 frames at hidden 32, so time rows
    768, virtual rows 256 and both cross blocks >= 256 rows."""
    kw = dict(space_depth=2, time_depth=2, hidden_size=32, output_dim=18)
    x = np.random.default_rng(8).normal(size=(1, 128, 4, 20)).astype(np.float32)
    jmod = juf.EfficientUpdateFormer(**kw)
    params = _random_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)), 9)
    want = np.asarray(_on_fused_route(jax.jit(jmod.apply), params, jnp.asarray(x)))
    port = EfficientUpdateFormer(20, **kw)
    port.load_state_dict(state_dict_from_flax(params["params"], port.state_dict()))
    return port.eval(), x, want


def test_update_former_on_the_fused_route_matches_jax(update_former):
    port, x, want = update_former
    tblocks.set_route(port, FUSED_ROUTE)
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        census = _Census(mp)
        got = port(_t(x))
    # each of the 2 rounds: a time and a virtual AttnBlock unfused (K3 and
    # 2 LayerNorms each) and 2 cross blocks (K4)
    assert census.calls == dict(k2=0, k3=4, k4=4, k5=8)
    _close(got, want, 5e-5)


def test_update_former_on_the_default_route_takes_k2(update_former):
    port, x, _ = update_former
    tblocks.set_route(port, KernelRoute())
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        census = _Census(mp)
        port(_t(x))
    assert census.calls == dict(k2=4, k3=0, k4=0, k5=0)


@pytest.fixture(scope="module")
def tiny_fused():
    """The tiny `ours` forward on the fused route, on both sides."""
    jc, tc = _tiny(jcfg), _tiny(tcfg)
    images, queries = _inputs(jc, seed=2)
    params = _jax_params(jc, images, queries, seed=3)
    out = _on_fused_route(
        jax.jit(JaxCOMET(jc).apply), {"params": params}, jnp.asarray(images), jnp.asarray(queries)
    )
    want = {k: np.asarray(v) for k, v in out.items()}
    model = build_comet(tc, device="cpu", route=FUSED_ROUTE)
    model.load_state_dict(params_from_jax({"params": params}, tc))
    with torch.no_grad():
        got = model(_t(images), _t(queries))
    return dict(jc=jc, tc=tc, queries=queries, want=want, got=got)


def test_forward_on_the_fused_route_matches_jax(tiny_fused):
    got, want = tiny_fused["got"], tiny_fused["want"]
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert torch.isfinite(got[key]).all(), key
    _close(got["coarse_track"], want["coarse_track"], 2e-2, 2e-2)
    _close(got["pred_track"], want["pred_track"], 2e-2, 2e-2)
    _close(got["track_vis"], want["track_vis"], 5e-3, 5e-3)
    _close(got["track_score"], want["track_score"], 5e-3, 5e-3)
    _close(got["pred_pose_enc"], want["pred_pose_enc"], 5e-3, 5e-3)
    _close(got["pred_track"][:, 0], tiny_fused["queries"], 1e-6)
    _close(got["pred_pose_enc"][:, 0], [[0, 0, 0, 1, 0, 0, 0]], 0)


def test_forward_on_the_fused_route_then_decode_matches_jax(tiny_fused):
    cams = _cameras(18, s=tiny_fused["jc"].seqlen)
    want = jax_decode_predictions(
        tiny_fused["jc"], jnp.asarray(tiny_fused["want"]["pred_pose_enc"][0]),
        jcam.make_camera_set(**cams),
    )
    got = decode_predictions(
        tiny_fused["tc"], tiny_fused["got"]["pred_pose_enc"][0], tcam.make_camera_set(**cams)
    )
    for g, w in zip(got, want):
        _close(g, w, 5e-3, 5e-3)


def test_the_route_changes_no_parameter():
    cfg = _tiny(tcfg)
    default = build_comet(cfg, device="cpu", seed=4)
    fused = build_comet(cfg, device="cpu", seed=4, route=FUSED_ROUTE)
    sd, sf = default.state_dict(), fused.state_dict()
    assert list(sd) == list(sf)
    assert all(sd[k].shape == sf[k].shape and torch.equal(sd[k], sf[k]) for k in sd)
    routed = [m for m in default.modules() if hasattr(m, "route")]
    assert routed and all(m.route == KernelRoute() for m in routed)
    assert all(m.route == FUSED_ROUTE for m in fused.modules() if hasattr(m, "route"))
    # one built model switches between routes
    default.set_route(FUSED_ROUTE)
    assert all(m.route == FUSED_ROUTE for m in routed)


def test_the_defaults_are_the_jax_defaults():
    assert KernelRoute() == KernelRoute(fused_block=True, fused_cross=False, fused_ln=False)
    assert FUSED_ROUTE == KernelRoute(fused_block=False, fused_cross=True, fused_ln=True)


def test_no_port_module_reads_the_environment_to_choose_a_kernel():
    # the route is an argument; the nvcc lookup (CUDA_HOME) is the only read;
    # matching.tools.set_num_threads writes the thread-count variables, as
    # the JAX package's does, and reads none
    root = Path(tblocks.__file__).resolve().parents[1]
    readers = sorted(
        str(p.relative_to(root)) for p in root.rglob("*.py")
        if "os.environ" in p.read_text() or "getenv" in p.read_text()
    )
    assert readers == ["matching/tools.py", "ops/kernels.py"]
    tools = (root / "matching" / "tools.py").read_text()
    assert "getenv" not in tools
    assert tools.count("os.environ") == len(re.findall(r"os\.environ\[\w+\] = ", tools)) == 1
