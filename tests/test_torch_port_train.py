"""The port's training path against the JAX package's, on the CPU.

The schedule, the trainable mask, the gradient of every kernel wrapper
(through its registered ``comet::`` operator's backward, whose forward on
the CPU is the plain version), the losses, three train steps, the stop-gradients of the
frozen tracker and backbone, checkpoints, the CSV logger and the anomaly
monitor, ``fit_epoch``, ``run_train_benchmark``, and the overfit check of
tests/test_overfit.py. Both packages get the same numpy inputs and the same
weights (``params_from_jax``); both run in f32.

The model is ``tests/test_models.py::tiny_config`` with the parity tests'
ViT (depth 2, width 32, 2 heads) in place of its full-width ViT-B (12 x
768, 86 M parameters): that ViT is frozen and only feeds the camera
predictor, and at full width JAX's initialisation alone takes ~30 s here.

Tolerances: the schedule within 1e-5 relative (JAX computes it in f32);
each Function's gradients within 1e-4 of the largest |g| of each tensor (f32
reassociation; bf16e rounds its exponents and their row sums to bf16 in the
forward, and the backward rounds their products again, so there two bf16
steps, 2^-6 of it); the losses within 1e-6 (a few f32
operations); the train steps' losses within 1e-4 relative, and the camera
parameters within 1e-2 x the sum of the step sizes (Adam moves an element by
about lr per step, so this is 1 % of the largest motion); a checkpointed
and resumed run equal to a straight one bit for bit (the same operations).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comet_tpu_torch.config as tcfg
from comet_tpu.geometry import cameras as jcam
from comet_tpu.models import COMET as JaxCOMET
from comet_tpu.models import losses as jlosses
from comet_tpu.ops import pallas_attn, pallas_block, pallas_norm
from comet_tpu.training import loop as jloop
from comet_tpu.training import optim as joptim
from comet_tpu.training import stats as jstats
from comet_tpu_torch import bench_lib
from comet_tpu_torch.data import datasets as tds
from comet_tpu_torch.data import fixtures as tfix
from comet_tpu_torch.data import keypoints as tkp
from comet_tpu_torch.geometry import cameras as tcam
from comet_tpu_torch.models import build_comet
from comet_tpu_torch.models import losses as tlosses
from comet_tpu_torch.ops import attn, block, library, norm
from comet_tpu_torch.training import (
    CsvLogger, TrainingMonitor, auto_resume, batch_metrics, build_batch, build_optimizer,
    build_train_step, camera_only_mask, fit_epoch,
    process_local_order, save_checkpoint, start_metric_fetch, trainable_labels,
    warmup_cosine_restarts,
)
from comet_tpu_torch.weights import convert_leaf, params_from_jax
from test_models import tiny_config
from test_torch_port_kernels import _block_params, _torch_layout
from test_torch_port_models import _cameras, _jax_params
from test_torch_port_softmax_forms import tool  # noqa: F401 (a fixture)

# the parity tests' ViT in place of tiny_config's full-width one
_VIT = dict(backbone_depth=2, backbone_dim=32, backbone_heads=2)
# the optimizer of the train steps: 10 steps per period, the first a warmup
# step at 1e-7, then 1e-3 and the cosine
_OPT = dict(base_lr=1e-3, steps_per_epoch=10, restart_epochs=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny model's ops are too small to share between threads, and with
    several test workers on one machine torch's thread pool only contends
    (the overfit test's 120 steps took 45x longer with the default pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**top):
    """tiny_config (with _VIT) as the JAX and the port's config."""
    jc = tiny_config()
    jc = jc.replace(camera=dataclasses.replace(jc.camera, **_VIT), **top)
    tc = tcfg.CometConfig(**{
        f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
        if f.name not in ("tracker", "camera", "train")},
        tracker=tcfg.TrackerConfig(**dataclasses.asdict(jc.tracker)),
        camera=tcfg.CameraConfig(**dataclasses.asdict(jc.camera)),
        train=tcfg.TrainConfig(**dataclasses.asdict(jc.train)))
    return jc, tc


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    s, hw, n = cfg.seqlen, cfg.img_size, cfg.track_num
    images = rng.normal(size=(1, s, hw, hw, 3)).astype(np.float32)
    queries = (rng.random((1, n, 2)) * (hw - 20) + 10).astype(np.float32)
    return images, queries, _cameras(seed + 1, s)


def _port_model(tc, params):
    model = build_comet(tc, device="cpu")
    model.load_state_dict(params_from_jax({"params": params}, tc))
    return model


def _port_steps(model, tc, batch, n, **opt):
    optimizer, scheduler = build_optimizer(model, **{**_OPT, **opt})
    step = build_train_step(model, tc, optimizer, scheduler)
    images, queries, gt = _torch_batch(batch)
    return [step(images, queries, gt) for _ in range(n)]


def _torch_batch(batch):
    images, queries, cams = batch
    gt = tcam.make_camera_set(**{k: torch.from_numpy(np.asarray(v)) for k, v in cams.items()})
    gt = tcam.CameraSet(*(f[None] for f in gt))  # a batch of one sequence
    return torch.from_numpy(images), torch.from_numpy(queries), gt


@pytest.fixture(scope="module")
def train():
    """The tiny config, its weights, a batch, and 3 JAX train steps."""
    jc, tc = _configs()
    batch = _batch(jc, seed=3)
    images, queries, cams = batch
    params = _jax_params(jc, images, queries, seed=5)
    tx, schedule = joptim.build_optimizer({"params": params}, **_OPT)
    step = jloop.build_train_step(JaxCOMET(jc), jc, tx)
    state = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    opt_state = tx.init(state)
    gt = jax.tree_util.tree_map(lambda f: f[None], jcam.make_camera_set(**cams))
    auxes = []
    for _ in range(3):
        state, opt_state, aux = step(state, opt_state, jnp.asarray(images),
                                     jnp.asarray(queries), gt)
        auxes.append({k: np.asarray(v) for k, v in aux.items()})
    return dict(jc=jc, tc=tc, batch=batch, params=params, after=state["params"],
                auxes=auxes, lrs=[float(schedule(i)) for i in range(3)])


# ------------------------------------------------------------ optimizer


@pytest.mark.parametrize("period,warmup_ratio", [(20, 0.1), (7, 0.3), (10, 0.0)])
def test_schedule_matches_jax(period, warmup_ratio):
    want = joptim.warmup_cosine_restarts(1e-3, period, warmup_ratio, 1e-7)
    got = warmup_cosine_restarts(1e-3, period, warmup_ratio, 1e-7)
    for step in range(2 * period + 1):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-5, abs=1e-12), step


def test_scheduler_reads_the_count_before_the_step():
    model = torch.nn.Linear(2, 2)
    model.camera_predictor = torch.nn.Linear(2, 2)
    optimizer, scheduler = build_optimizer(model, base_lr=1e-3, steps_per_epoch=10,
                                           restart_epochs=1)
    schedule = warmup_cosine_restarts(1e-3, 10, 0.1, 1e-7)
    for step in range(12):
        assert optimizer.param_groups[0]["lr"] == schedule(step)
        optimizer.step()
        scheduler.step()


def test_mask_and_labels_match_jax(train):
    tree = {"params": train["params"]}
    flat = jax.tree_util.tree_flatten_with_path(joptim.camera_only_mask(tree))[0]
    want = {convert_leaf(tuple(str(k.key) for k in path[1:]), value)[0]: m
            for (path, m), value in zip(flat, jax.tree_util.tree_leaves(tree))}
    model = _port_model(train["tc"], train["params"])
    assert camera_only_mask(model) == want
    assert camera_only_mask(model.state_dict()) == want
    assert set(trainable_labels(model).values()) == {"train", "freeze"}
    assert any(want.values()) and not all(want.values())
    optimizer, _ = build_optimizer(model)
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    assert held == {id(p) for n, p in model.named_parameters() if want[n]}
    assert optimizer.defaults["weight_decay"] == 1e-4 and optimizer.defaults["eps"] == 1e-8


def test_clip_and_adamw_match_optax():
    """One update of the optimizer against optax's chain on the same
    gradients, with the norm above the clip (scaled) and below it."""
    import optax

    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    for scale in (10.0, 0.01):
        g = (rng.normal(size=(3, 4)) * scale).astype(np.float32)
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-2))
        upd, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(w)), jnp.asarray(w))
        want = np.asarray(optax.apply_updates(jnp.asarray(w), upd))
        model = torch.nn.Module()
        model.camera_predictor = torch.nn.Module()
        model.camera_predictor.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        optimizer, _ = build_optimizer(model, base_lr=1e-2, warmup_ratio=0.0)
        model.camera_predictor.w.grad = torch.from_numpy(g)
        optimizer.step()
        np.testing.assert_allclose(model.camera_predictor.w.detach().numpy(), want,
                                   rtol=1e-6, atol=1e-7)


# ------------------------------------------------- kernel Functions


def _grads_jax(fn, arrays, cot):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _grads_port(fn, arrays, cot):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    assert type(out.grad_fn).__name__.startswith("GeneratedBackwardFor_comet_")
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _check_grads(got, want, rtol=1e-4):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=rtol * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize("name,b,lq,lk,c,h", [
    ("K1", 2, 16, 128, 64, 2),  # JAX's blocked Pallas kernel
    ("K1", 3, 9, 130, 96, 2),  # blocked, Lk padded and masked
    ("K3", 16, 16, 16, 64, 2),  # JAX's packed Pallas kernel
])
def test_attention_gradients_match_jax(name, b, lq, lk, c, h):
    rng = np.random.default_rng(b + lq)
    arrays = [rng.normal(size=(b, n, c)).astype(np.float32) for n in (lq, lk, lk)]
    cot = rng.normal(size=(b, lq, c)).astype(np.float32)
    assert attn.is_short(b, lq, lk) == (name == "K3")
    out_w, want = _grads_jax(lambda q, k, v: pallas_attn.fused_attention(q, k, v, h), arrays, cot)
    out_g, got = _grads_port(lambda q, k, v: attn.fused_attention(q, k, v, h), arrays, cot)
    np.testing.assert_allclose(out_g, out_w, atol=2e-5)
    _check_grads(got, want)


@pytest.mark.parametrize("form", ["nomax", "bf16e"])
def test_softmax_form_gradients_match_the_tool(tool, form):  # noqa: F811
    """The forms' gradients against jax.grad of the TPU tool's whole-row
    form (its Pallas kernel has no VJP), vmapped over the batch."""
    b, lq, lk, c, h = 2, 9, 13, 128, 2
    rng = np.random.default_rng(1)
    arrays = [rng.normal(size=(b, n, c)).astype(np.float32) for n in (lq, lk, lk)]
    cot = rng.normal(size=(b, lq, c)).astype(np.float32)
    d = c // h
    jfn = jax.vmap(lambda q, k, v: tool["_heads_attend_variant"](q, k, v, h, d, d ** -0.5, None,
                                                                 form))
    _, want = _grads_jax(jfn, arrays, cot)
    _, got = _grads_port(lambda q, k, v: attn.fused_attention(q, k, v, h, softmax=form),
                         arrays, cot)
    _check_grads(got, want, 1e-4 if form == "nomax" else 2.0 ** -6)


def test_k2_gradients_match_jax():
    b, l, c, h = 16, 16, 64, 4
    p = _block_params(c, 4 * c, seed=7)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(b, l, c)).astype(np.float32)
    cot = rng.normal(size=(b, l, c)).astype(np.float32)
    out_w, want = _grads_jax(lambda *a: pallas_block.fused_attn_block(*a, num_heads=h),
                             [x, *(np.float32(a) for a in p.values())], cot)
    out_g, got = _grads_port(lambda *a: block.fused_attn_block(*a, h),
                             [x, *(t.numpy() for t in _torch_layout(p))], cot)
    np.testing.assert_allclose(out_g, out_w, atol=3e-5)
    _check_grads(got[:1] + [g.T for g in got[1:]], want)


def test_k4_gradients_match_jax():
    b, lq, lk, c, h = 16, 16, 24, 64, 4
    rng = np.random.default_rng(9)
    s = 0.1
    x, ctx = (rng.normal(size=(b, n, c)).astype(np.float32) for n in (lq, lk))
    gamma, beta = (1 + s * rng.normal(size=c)).astype(np.float32), (s * rng.normal(size=c))
    shapes = [(c, c), (c,), (c, 2 * c), (2 * c,), (c, c), (c,), (c, 4 * c), (4 * c,), (4 * c, c),
              (c,)]
    ws = [(s * rng.normal(size=sh)).astype(np.float32) for sh in shapes]
    cot = rng.normal(size=(b, lq, c)).astype(np.float32)
    arrays = [x, ctx, gamma, beta.astype(np.float32), *ws]
    out_w, want = _grads_jax(lambda *a: pallas_block.fused_cross_block(*a, num_heads=h),
                             arrays, cot)
    port = arrays[:4] + [np.ascontiguousarray(w.T) for w in ws]
    out_g, got = _grads_port(lambda *a: block.fused_cross_block(*a, h), port, cot)
    np.testing.assert_allclose(out_g, out_w, atol=3e-5)
    _check_grads(got[:4] + [g.T for g in got[4:]], want)


@pytest.mark.parametrize("affine", [True, False])
def test_k5_gradients_match_jax(monkeypatch, affine):
    monkeypatch.setenv("COMET_FUSED_LN", "1")  # JAX's Pallas LayerNorm
    rng = np.random.default_rng(10)
    x = rng.normal(size=(3, 100, 64)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    arrays = [x]
    if affine:
        arrays += [(1 + 0.1 * rng.normal(size=64)).astype(np.float32),
                   (0.1 * rng.normal(size=64)).astype(np.float32)]
    out_w, want = _grads_jax(lambda *a: pallas_norm.fused_layer_norm(*a), arrays, cot)
    out_g, got = _grads_port(lambda *a: norm.fused_layer_norm(*a), arrays, cot)
    np.testing.assert_allclose(out_g, out_w, atol=1e-5)
    _check_grads(got, want)


def test_function_backward_is_the_plain_versions_autograd():
    """The Function's gradients are the plain version's autograd on the
    same inputs, bit for bit (on the card, chip_smoke.py holds the kernels'
    Functions to the same)."""
    rng = np.random.default_rng(11)
    arrays = [rng.normal(size=(2, n, 64)).astype(np.float32) for n in (70, 90, 90)]
    cot = torch.from_numpy(rng.normal(size=(2, 70, 64)).astype(np.float32))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    attn.fused_attention(*ts, 4).backward(cot)
    got = [t.grad for t in ts]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    attn.attention_reference(*ts, 4, 0.25).backward(cot)
    assert all(torch.equal(g, t.grad) for g, t in zip(got, ts))


def test_no_autograd_node_without_a_gradient():
    q = torch.zeros(2, 8, 64, requires_grad=True)
    with torch.no_grad():
        assert attn.fused_attention(q, q, q, 4).grad_fn is None
    assert attn.fused_attention(q.detach(), q.detach(), q.detach(), 4).grad_fn is None


# ------------------------------------------------------------ losses


def test_losses_match_jax():
    rng = np.random.default_rng(12)
    preds = [rng.normal(size=(2, 3, 5, 2)).astype(np.float32) * 8 for _ in range(3)]
    gt = rng.normal(size=(2, 3, 5, 2)).astype(np.float32) * 8
    gt[0, 1, 2] = np.nan
    vis = rng.random((2, 3, 5)) > 0.5
    valid = rng.random((2, 3, 5)) > 0.2
    for kw in (dict(), dict(vis_aware=True), dict(use_huber=True)):
        want = jlosses.sequence_loss([jnp.asarray(p) for p in preds], jnp.asarray(gt),
                                     jnp.asarray(vis), jnp.asarray(valid), **kw)
        got = tlosses.sequence_loss([torch.from_numpy(p) for p in preds], torch.from_numpy(gt),
                                    torch.from_numpy(vis), torch.from_numpy(valid), **kw)
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    logits = rng.normal(size=(4, 7)).astype(np.float32) * 3
    labels = (rng.random((4, 7)) > 0.5).astype(np.float32)
    want = jlosses.balanced_ce_loss(jnp.asarray(logits), jnp.asarray(labels),
                                    jnp.asarray(valid.reshape(-1)[:28].reshape(4, 7)))
    got = tlosses.balanced_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                   torch.from_numpy(valid.reshape(-1)[:28].reshape(4, 7)))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    m = (rng.random((3, 1)) > 0.3).astype(np.float32)
    for dim in (None, 0, (0, 1)):
        np.testing.assert_allclose(
            tlosses.reduce_masked_mean(torch.from_numpy(x), torch.from_numpy(m), dim).numpy(),
            np.asarray(jlosses.reduce_masked_mean(jnp.asarray(x), jnp.asarray(m), dim)),
            rtol=1e-6)


# -------------------------------------------------------- train step


def test_three_train_steps_match_jax(train):
    """Loss per step within 1e-4, camera parameters within 1e-2 x the sum of
    the step sizes. Where an element's gradient is below 1e-5 of its
    tensor's largest, it is 0 (behind a ReLU that never fires), f32
    rounding (the key biases of attention, whose gradient is 0: softmax
    ignores a logit shift shared by every key; one framework may round such
    a sum to 0 and the other not) or near it, and Adam's normalized step
    follows that rounding's sign and size; such an element is held only to
    move by at most the sum of the step sizes, as any Adam step does. Those
    that are not 0 are at most 2 % of the camera's elements."""
    model = _port_model(train["tc"], train["params"])
    optimizer, scheduler = build_optimizer(model, **_OPT)
    step = build_train_step(model, train["tc"], optimizer, scheduler)
    auxes, unresolved = [], {}
    for i in range(3):
        auxes.append(step(*_torch_batch(train["batch"])))
        if i == 0:  # the clip scales a tensor's gradient as a whole
            unresolved = {n: p.grad.abs() < 1e-5 * p.grad.abs().max()
                          for n, p in model.named_parameters() if p.grad is not None}
            zero = sum(int((p.grad == 0).sum()) for p in model.parameters() if p.grad is not None)
    for i, (got, want) in enumerate(zip(auxes, train["auxes"])):
        assert set(got) == set(want)
        assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-4), i
        for k in got:
            assert not got[k].requires_grad, k
    after = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, train["after"])},
                            train["tc"])
    before = params_from_jax({"params": train["params"]}, train["tc"])
    mask = camera_only_mask(model)
    lr_sum = sum(train["lrs"])
    for name, p in model.state_dict().items():
        if not mask[name]:
            assert torch.equal(p, before[name].float()), name
            continue
        off = unresolved[name]
        np.testing.assert_allclose(p[~off].numpy(), after[name][~off].numpy(),
                                   atol=1e-2 * lr_sum, rtol=0, err_msg=name)
        for moved in (p[off], after[name][off].float()):
            assert ((moved - before[name][off].float()).abs() <= 1.01 * lr_sum).all(), name
    n_off = sum(int(unresolved[n].sum()) for n in unresolved)
    assert n_off - zero <= 0.02 * sum(unresolved[n].numel() for n in unresolved)
    assert any(not torch.equal(p, before[n].float()) for n, p in model.state_dict().items()
               if mask[n])


def test_frozen_parts_get_no_gradient(train):
    """After a step, no tracker or backbone parameter has a .grad; every
    camera parameter the mask selects has a finite, nonzero one."""
    model = _port_model(train["tc"], train["params"])
    _port_steps(model, train["tc"], train["batch"], 1)
    mask = camera_only_mask(model)
    for name, p in model.named_parameters():
        if mask[name]:
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
            assert (p.grad != 0).any(), name
        else:
            assert p.grad is None, name
    assert any(n.startswith("camera_predictor.backbone.") for n in mask)
    assert any(n.startswith(("coarse_", "fine_")) for n in mask)


@pytest.mark.parametrize("route", ["default", "fused"])
def test_unfrozen_tracker_runs_the_block_functions(monkeypatch, route):
    """With freeze_track=False (no preset sets it) the tracker is
    differentiated: its K2 (default route) or K3, K4 and K5 (FUSED_ROUTE)
    Functions run their backward, the tracker's parameters get gradients,
    and the step's loss and camera update are those of the frozen step."""
    jc, tc = _configs(seqlen=4, track_num=128)  # rows over the K2, K3, K4 gates
    batch = _batch(jc, seed=4)
    params = _jax_params(jc, batch[0], batch[1], seed=6)
    seen = []
    plain_vjp = library.plain_vjp

    def spy(name, *args):
        seen.append(name)
        return plain_vjp(name, *args)

    monkeypatch.setattr(library, "plain_vjp", spy)
    r = tcfg.KernelRoute() if route == "default" else tcfg.FUSED_ROUTE
    runs = {}
    for freeze in (True, False):
        model = _port_model(tc.replace(freeze_track=freeze), params).set_route(r)
        seen.clear()
        aux = _port_steps(model, model.cfg, batch, 1)[0]
        runs[freeze] = (aux, model, set(seen))
    (aux_f, frozen, seen_f), (aux_u, unfrozen, seen_u) = runs[True], runs[False]
    want = {"attn_block"} if route == "default" else {
        "short_attention", "cross_block", "layer_norm"}
    assert want <= seen_u and not want & seen_f - {"layer_norm"}
    assert torch.equal(aux_f["loss"], aux_u["loss"])
    for name, p in unfrozen.named_parameters():
        if name.startswith(("coarse_tracker.", "fine_tracker.")) and "updateformer" in name:
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
    for (name, p), q in zip(frozen.named_parameters(), unfrozen.parameters()):
        assert torch.equal(p, q), name


def test_checkpoint_resume_equals_a_straight_run(train, tmp_path):
    tc, batch = train["tc"], train["batch"]
    straight = _port_model(tc, train["params"])
    want = _port_steps(straight, tc, batch, 3)

    first = _port_model(tc, train["params"])
    optimizer, scheduler = build_optimizer(first, **_OPT)
    step = build_train_step(first, tc, optimizer, scheduler)
    images, queries, gt = _torch_batch(batch)
    for _ in range(2):
        step(images, queries, gt)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, 0, {"model": first, "optimizer": optimizer, "scheduler": scheduler,
                              "epoch": 0, "stats": {"loss": 1.5}})
    save_checkpoint(ckpt, 1, {"model": first, "optimizer": optimizer, "scheduler": scheduler,
                              "epoch": 1, "stats": {"loss": 2.5}})
    assert sorted(os.listdir(ckpt)) == ["ckpt_000000", "ckpt_000001"]

    resumed = build_comet(tc, device="cpu", seed=9)  # other weights until restored
    optimizer, scheduler = build_optimizer(resumed, **_OPT)
    start, state = auto_resume(ckpt, {"model": resumed, "optimizer": optimizer,
                                      "scheduler": scheduler, "epoch": -1, "stats": {}})
    assert start == 2 and state["epoch"] == 1 and state["stats"] == {"loss": 2.5}
    assert auto_resume(str(tmp_path / "none"), {"epoch": -1}) == (0, {"epoch": -1})
    got = build_train_step(resumed, tc, optimizer, scheduler)(images, queries, gt)
    assert torch.equal(got["loss"], want[2]["loss"])
    for (name, p), q in zip(straight.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(p, q), name


# ------------------------------------------------ logging and monitor


def test_csv_logger_and_monitor_match_jax(tmp_path):
    rows = [(0, {"Auc_30": 0.5, "R_avg": 3.25, "loss": 9.0}), (1, {"Auc_30": 0.625, "lr": 1e-5})]
    for pkg, logger_cls in (("jax", jstats.CsvLogger), ("port", CsvLogger)):
        logger = logger_cls(str(tmp_path / pkg / "results.csv"))
        for epoch, metrics in rows:
            logger.log(epoch, metrics)
    assert (tmp_path / "port" / "results.csv").read_text() == \
        (tmp_path / "jax" / "results.csv").read_text()
    assert tuple(jstats.TO_PLOT_METRICS) == tuple(CsvLogger(str(tmp_path / "x.csv")).fieldnames[1:])

    losses = [1.0, 2.0, 500.0, 5000.0, 4.0, 0.0, 1.0]
    flags = {}
    for pkg, cls in (("jax", jstats.TrainingMonitor), ("port", TrainingMonitor)):
        m = cls(str(tmp_path / f"anoms_{pkg}"), threshold=1000, ratio=100, window=3)
        flags[pkg] = [m.check(x, i, {"seq": "a"}) for i, x in enumerate(losses)]
        assert m.history == losses[-3:]
    assert flags["port"] == flags["jax"] == [False, False, True, True, False, False, False]
    dumps = [sorted(os.listdir(tmp_path / f"anoms_{pkg}")) for pkg in ("jax", "port")]
    assert len(dumps[0]) == len(dumps[1]) == 2
    for a, b in zip(*dumps):
        assert json.loads((tmp_path / "anoms_port" / b).read_text()) == \
            json.loads((tmp_path / "anoms_jax" / a).read_text())


# --------------------------------------------------------- fit_epoch


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_fixture") / "AMD_train")
    tfix.generate_amd_fixture(root, n_models=1, n_seqs=5, n_frames=6, img_hw=(96, 128))
    return root


def test_fit_epoch_equals_its_steps_run_by_hand(train, fixture_root):
    tc = train["tc"]
    ds = tds.AMDDataset(fixture_root, crop_size=tc.img_size, seq_len=tc.seqlen, use_augs=False)

    def seed_fn(sample):
        return tkp.grid_points(sample.first_mask, tc.track_num)

    order = process_local_order(np.random.default_rng(0), len(ds))
    assert sorted(order) == list(range(len(ds)))
    model = _port_model(tc, train["params"])
    optimizer, scheduler = build_optimizer(model, **_OPT)
    seen = []
    n = fit_epoch(build_train_step(model, tc, optimizer, scheduler), ds, seed_fn, 2, order,
                  device="cpu", on_metrics=lambda i, rows: seen.append((i, rows)))
    assert n == len(ds) // 2 == 2 and [i for i, _ in seen] == [0, 1]

    model = _port_model(tc, train["params"])
    optimizer, scheduler = build_optimizer(model, **_OPT)
    step = build_train_step(model, tc, optimizer, scheduler)
    for i in range(n):
        samples = [ds[int(j)] for j in order[2 * i:2 * i + 2]]
        images, q, gt_b, gt_list = build_batch(samples, [seed_fn(s) for s in samples], "cpu")
        rows = batch_metrics(start_metric_fetch(step(images, q, gt_b)), gt_list)
        assert len(rows) == 2 and rows == seen[i][1]
    # the mesh path trains on the rank's device (tests/test_torch_port_distributed.py);
    # a device that is not the mesh's is refused
    with pytest.raises(ValueError, match="mesh device is cpu"):
        fit_epoch(step, ds, seed_fn, 2, order, device="meta", mesh=_CpuMesh())


class _CpuMesh:
    """A 2-rank CPU mesh, as far as fit_epoch and evaluate look at one."""

    device_type = "cpu"

    def size(self, dim=None):
        return 2


# -------------------------------------------------------- benchmark


def test_run_train_benchmark_keys_on_the_cpu(train):
    out = bench_lib.run_train_benchmark(train["tc"], warmup=1, reps=2, device="cpu")
    assert set(out) == {"metric", "value", "unit", "ms_per_step", "device", "device_ms_per_step"}
    assert out["unit"] == "steps/s" and out["value"] > 0 and out["device_ms_per_step"] is None
    assert out["metric"] == "train steps/sec/chip (seqlen=3, 64px, N=8, batch=1)"


def test_run_train_benchmark_needs_a_card(train, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_lib.run_train_benchmark(train["tc"])


# ----------------------------------------------------------- overfit


def test_overfit_halves_the_loss_and_keeps_the_tracker(fixture_root):
    """tests/test_overfit.py on the port: 120 steps on 2 fixture sequences
    cut the pose loss by half and improve R_avg and Auc_30; the tracker
    stays bit for bit; the camera predictor moves."""
    jc, tc = _configs()
    ds = tds.AMDDataset(fixture_root, crop_size=tc.img_size, seq_len=tc.seqlen, use_augs=False)
    rng = np.random.default_rng(0)
    samples = [ds[i] for i in range(2)]
    queries = [tkp.seed_query_points(s.images[0], s.first_mask, tc.track_num, tc.min_track_num,
                                     backend="grid", rng=rng) for s in samples]
    images, q, gt_b, gt_list = build_batch(samples, queries, "cpu")
    model = build_comet(tc, device="cpu", seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, scheduler = build_optimizer(model, base_lr=3e-3, steps_per_epoch=20,
                                           restart_epochs=1, warmup_ratio=0.05)
    step = build_train_step(model, tc, optimizer, scheduler)
    auxes = [step(images, q, gt_b) for _ in range(120)]
    losses = [float(a["loss"]) for a in auxes]
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.5 * losses[0], losses[::24]
    first, last = (batch_metrics(start_metric_fetch(a), gt_list) for a in (auxes[0], auxes[-1]))
    mean = [{k: np.mean([r[k] for r in rows]) for k in rows[0]} for rows in (first, last)]
    assert mean[1]["R_avg"] < mean[0]["R_avg"]
    assert mean[1]["Auc_30"] >= mean[0]["Auc_30"]
    mask = camera_only_mask(model)
    after = model.state_dict()
    for name in after:
        if not mask[name]:
            assert torch.equal(after[name], before[name]), name
    assert any(not torch.equal(after[n], before[n]) for n in after if mask[n])
