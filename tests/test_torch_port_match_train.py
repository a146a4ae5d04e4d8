"""The port's matcher training against ``comet_tpu.matching``'s, on the CPU:
the losses and their gradients, the photometric augmentation, the batch
builder, the train steps, the checkpoints in both directions and ``match
--train``. LightGlue runs at depth 2, width 32; SuperGlue at depth 2, width
32 with 5 Sinkhorn iterations; 32 keypoints with 16-d descriptors, batch 2.
Both packages start from the same weights: JAX's initialization carried
across by ``weights.module_params_from_jax``.

JAX's augmentation draws from its keys and the port's from a
``torch.Generator``; the tests feed JAX's draws (of the key the batch builder
derives from the numpy stream) to the port's ``apply_photometric``.

Tolerances (f32):

- losses: 1e-5 relative; gradients: each tensor within 1e-5 of its largest
  |value| (``jax.value_and_grad`` against autograd), or, where the loss
  cannot see a weight (the key biases of SuperGlue's attention: a softmax
  over keys ignores a constant), both below 1e-6 of the largest gradient;
- augmentation: 1e-6; ``sample_homography_difficulty``: equal;
- the batch: labels equal, keypoints and descriptors within 1e-5;
- train steps (``optax.adam`` against ``torch.optim.Adam``): each step's
  loss within 1e-5 relative; after the last step each parameter within 1e-5
  of its tensor's range or largest |value| (a LayerNorm scale, all 1 at the
  start, and a single bias have almost no range), or within 1e-4 of lr x
  steps, the most Adam moves an entry (a bias that starts at 0 has no other
  range; Adam divides each entry's gradient by its own size, so an entry
  with a small gradient carries its relative rounding into the step),
  except the entries whose first gradient is
  rounding noise (below 1e-6 of the largest gradient: those key biases),
  where Adam
  moves each package by up to lr per step in a direction the noise picks:
  those are held to 2 lr per step;
- ``match --train``: the same lines and JSON keys, ``loss_first`` and
  ``loss_last`` within 1e-4, the same checkpoint files and sidecars (each
  sidecar's loss within 1e-4, its validation H error within 1e-3 relative).
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from comet_tpu import cli as jcli
from comet_tpu.matching import augmentations as jaug
from comet_tpu.matching import configs as jconfigs
from comet_tpu.matching import experiments as jexp
from comet_tpu.matching import lightglue as jlg
from comet_tpu.matching import superglue as jsg
from comet_tpu.matching import train as jtrain
from comet_tpu_torch import cli as tcli
from comet_tpu_torch.matching import augmentations as taug
from comet_tpu_torch.matching import configs as tconfigs
from comet_tpu_torch.matching import experiments as texp
from comet_tpu_torch.matching import lightglue as tlg
from comet_tpu_torch.matching import superglue as tsg
from comet_tpu_torch.matching import train as ttrain
from comet_tpu_torch.matching.gt_generation import IGNORE, UNMATCHED
from comet_tpu_torch.weights import module_params_from_jax, module_params_to_jax
from test_torch_port_match_cli import _Jitted, jax_draws, jax_jitted, sp_params  # noqa: F401

N, D, B = 32, 16, 2
LR = 1e-3
LG = dict(depth=2, dim=32, num_heads=4, filter_threshold=0.0)
SG = dict(depth=2, dim=32, num_heads=4, sinkhorn_iters=5, filter_threshold=0.0)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
NOISE = 1e-6
ADAM_TOL = 1e-4


def _t(a, dtype=None):
    a = np.asarray(a)
    return torch.as_tensor(np.array(a), dtype=dtype or (torch.long if a.dtype.kind == "i" else
                                                         torch.bool if a.dtype == bool else
                                                         torch.float32))


def _labels(rng, n0, n1):
    """Ground truth with matches, UNMATCHED and IGNORE on both sides."""
    gt0 = np.full(n0, UNMATCHED, np.int32)
    gt1 = np.full(n1, UNMATCHED, np.int32)
    pairs = rng.permutation(n1)[: n0 // 2]
    for i, j in enumerate(pairs):
        gt0[i], gt1[j] = j, i
    gt0[-4:] = IGNORE
    free = np.nonzero(gt1 == UNMATCHED)[0]
    gt1[free[:3]] = IGNORE
    return gt0, gt1


def _batch(seed):
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ttrain.BATCH_KEYS}
    for _ in range(B):
        d0 = rng.normal(size=(N, D)).astype(np.float32)
        d1 = np.concatenate([d0[: N // 2] + 0.3 * rng.normal(size=(N // 2, D)),
                             rng.normal(size=(N - N // 2, D))]).astype(np.float32)
        gt0, gt1 = _labels(rng, N, N)
        out["kpts0"].append(rng.uniform(-1, 1, (N, 2)).astype(np.float32))
        out["kpts1"].append(rng.uniform(-1, 1, (N, 2)).astype(np.float32))
        out["desc0"].append(d0)
        out["desc1"].append(d1)
        out["gt0"].append(gt0)
        out["gt1"].append(gt1)
    return {k: np.stack(v) for k, v in out.items()}


def _init(module, seed):
    b = _batch(0)
    args = [jnp.asarray(b[k][0]) for k in ("kpts0", "desc0", "kpts1", "desc1")]
    return jax.tree_util.tree_map(np.asarray, jax.jit(module.init)(jax.random.PRNGKey(seed), *args))


@pytest.fixture(scope="module")
def lg_vars():
    return _init(jlg.LightGlueMatcher(**LG), 3)


@pytest.fixture(scope="module")
def sg_vars():
    return _init(jsg.SuperGlueMatcher(**SG), 4)


def _port(cls, conf, jvars):
    m = cls(**conf, in_dim=D)
    m.load_state_dict(module_params_from_jax(jvars, m))
    return m


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _grads_close(module, jgrads, tol=GRAD_TOL):
    """Every parameter's gradient within ``tol`` of its largest |value|, or
    both below the noise floor (NOISE of the largest gradient of all); a
    parameter the loss does not reach has JAX's zero gradient."""
    want = module_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), module)
    floor = NOISE * max(np.abs(w.numpy()).max() for w in want.values())
    for name, p in module.named_parameters():
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = np.abs(g - w).max()
        assert err <= max(tol * np.abs(w).max(), floor), (name, err, np.abs(w).max(), floor)


# ------------------------------------------------------------ losses and gradients

def _lg_loss_pair(kind):
    """(JAX loss of (params, sample), port loss of (module, sample))."""
    if kind == "matcher_nll":
        def jloss(m, p, s):
            out = m.apply(p, *s[:4])
            return jtrain.matcher_nll_loss(out["assignment"], out["matchability0"],
                                           out["matchability1"], s[4], s[5])

        def tloss(m, s):
            out = m(*s[:4])
            return ttrain.matcher_nll_loss(out["assignment"], out["matchability0"],
                                           out["matchability1"], s[4], s[5])
    elif kind == "assignment_nll":
        def jloss(m, p, s):
            return jlg._assignment_nll(m.apply(p, *s[:4], training=True)["all_log_assignment"][0],
                                       s[4], s[5])

        def tloss(m, s):
            return tlg._assignment_nll(m(*s[:4], training=True)["all_log_assignment"][0], s[4],
                                       s[5])
    else:
        def jloss(m, p, s):
            return jlg.lightglue_loss(m.apply(p, *s[:4], training=True), s[4], s[5],
                                      gamma=0.5)["total"]

        def tloss(m, s):
            return tlg.lightglue_loss(m(*s[:4], training=True), s[4], s[5], gamma=0.5)["total"]
    return jloss, tloss


@pytest.mark.parametrize("kind", ["matcher_nll", "assignment_nll", "lightglue_loss"])
def test_lightglue_losses_and_gradients_match_jax(lg_vars, kind):
    """Each LightGlue loss on one sample, and its gradient with respect to
    every weight, against ``jax.value_and_grad``."""
    jm = jlg.LightGlueMatcher(**LG)
    jloss, tloss = _lg_loss_pair(kind)
    b = _batch(1)
    sample = [b[k][0] for k in ttrain.BATCH_KEYS]
    want, jgrads = jax.jit(jax.value_and_grad(lambda p: jloss(jm, p, [jnp.asarray(a)
                                                                       for a in sample])))(lg_vars)
    port = _port(tlg.LightGlueMatcher, LG, lg_vars)
    got = tloss(port, [_t(a) for a in sample])
    got.backward()
    assert abs(got.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    _grads_close(port, jgrads)


def test_lightglue_training_outputs_match_jax(lg_vars):
    """``training=True``: every layer's log assignment and the confidence
    logits (1e-5 of their range), the loss's parts, and no early exit."""
    conf = dict(LG, depth_confidence=0.95, width_confidence=0.99)
    b = _batch(2)
    s = [b[k][0] for k in ("kpts0", "desc0", "kpts1", "desc1")]
    want = jax.jit(lambda p, *a: jlg.LightGlueMatcher(**conf).apply(p, *a, training=True))(
        lg_vars, *(jnp.asarray(a) for a in s))
    with torch.no_grad():
        got = _port(tlg.LightGlueMatcher, conf, lg_vars)(*(_t(a) for a in s), training=True)
    assert set(got) == set(want)
    for k in ("all_log_assignment", "conf_logits0", "conf_logits1", "log_assignment"):
        assert got[k].shape == want[k].shape and _rel(got[k], want[k]) <= 1e-5, k
    for k in ("matches0", "matches1", "stop_layer", "prune0", "prune1"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    parts = tlg.lightglue_loss(got, _t(b["gt0"][0]), _t(b["gt1"][0]))
    jparts = jlg.lightglue_loss(want, jnp.asarray(b["gt0"][0]), jnp.asarray(b["gt1"][0]))
    for k in ("total", "assignment_nll", "confidence", "last"):
        assert _rel(parts[k], jparts[k]) <= LOSS_RTOL, k


@pytest.mark.parametrize("masks", [False, True], ids=["ignore_as_dustbin", "valid_masks"])
def test_superglue_loss_and_gradients_match_jax(sg_vars, masks):
    """``superglue_nll_loss`` with IGNORE labels: without masks both
    packages send IGNORE to the dustbin and count it (the JAX package's
    behaviour, kept); with ``valid0``/``valid1`` the masked points drop out.
    Values and gradients against ``jax.value_and_grad``."""
    jm = jsg.SuperGlueMatcher(**SG)
    b = _batch(3)
    s = [b[k][0] for k in ttrain.BATCH_KEYS]
    v0, v1 = s[4] != IGNORE, s[5] != IGNORE
    kw = dict(valid0=v0, valid1=v1) if masks else {}

    def jloss(p):
        la = jm.apply(p, *(jnp.asarray(a) for a in s[:4]))["log_assignment"]
        return jsg.superglue_nll_loss(la, jnp.asarray(s[4]), jnp.asarray(s[5]),
                                      **{k: jnp.asarray(v) for k, v in kw.items()})

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(sg_vars)
    port = _port(tsg.SuperGlueMatcher, SG, sg_vars)
    la = port(*(_t(a) for a in s[:4]))["log_assignment"]
    got = tsg.superglue_nll_loss(la, _t(s[4]), _t(s[5]), **{k: _t(v) for k, v in kw.items()})
    got.backward()
    assert abs(got.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    _grads_close(port, jgrads)
    # the copied fault: unmasked, an IGNORE row weighs in as its dustbin
    if not masks:
        with torch.no_grad():
            la = port(*(_t(a) for a in s[:4]))["log_assignment"]
            fixed = tsg.superglue_nll_loss(la, _t(s[4]), _t(s[5]), valid0=_t(v0), valid1=_t(v1))
            assert abs(float(fixed) - float(got)) > 1e-4


# ------------------------------------------------------------ augmentation

def _jax_draw(key, shape, conf):
    """The random numbers JAX's ``photometric_augment`` draws from ``key``,
    in the port's ``draw_photometric`` form."""
    keys = jax.random.split(key, 6)
    applies, vals = {}, []
    for step, k in zip(taug.STEPS, keys):
        kc, ka = jax.random.split(k)
        applies[step] = bool(jax.random.uniform(kc) < conf.p)
        vals.append(ka)
    u = jax.random.uniform
    return {
        "applies": applies,
        "brightness": float(u(vals[0], minval=-conf.brightness, maxval=conf.brightness)),
        "contrast": float(1.0 + u(vals[1], minval=-conf.contrast, maxval=conf.contrast)),
        "saturation": float(1.0 + u(vals[2], minval=-conf.saturation, maxval=conf.saturation)),
        "gamma": float(jnp.exp(u(vals[3], minval=-conf.gamma, maxval=conf.gamma))),
        "noise": torch.from_numpy(np.array(jax.random.normal(vals[4], shape))),
        "blur_sigma": float(u(vals[5], minval=0.1, maxval=conf.blur_sigma)),
    }


@pytest.mark.parametrize("channels,p,seed", [(3, 0.95, 0), (3, 0.5, 1), (1, 0.5, 2), (3, 1.0, 3)])
def test_photometric_augment_with_jax_draws_matches_jax(channels, p, seed):
    conf = taug.PhotometricConfig(p=p)
    img = np.random.default_rng(seed).random((24, 20, channels)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jaug.photometric_augment(key, jnp.asarray(img), jaug.PhotometricConfig(p=p))
    got = taug.apply_photometric(_t(img), _jax_draw(key, img.shape, conf), conf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert taug.LG_PRESET == tuple(jaug.LG_PRESET)


def test_photometric_augment_is_its_draw_applied():
    img = _t(np.random.default_rng(4).random((16, 12, 3)))
    a = taug.photometric_augment(torch.Generator().manual_seed(7), img)
    d = taug.draw_photometric(torch.Generator().manual_seed(7), img.shape)
    assert torch.equal(a, taug.apply_photometric(img, d))
    assert a.min() >= 0 and a.max() <= 1 and not torch.equal(a, img)
    blurred = taug.blur(torch.ones(9, 9, 1), 1.0)  # zero padding darkens the border
    assert blurred[4, 4, 0] == pytest.approx(1.0, abs=1e-6) and blurred[0, 0, 0] < 0.8


def test_sample_homography_difficulty_matches_jax():
    for d, a in ((0.7, 45.0), (0.2, 10.0), (1.0, 90.0)):
        want = jaug.sample_homography_difficulty(np.random.default_rng(3), 64, 80, d, a)
        got = taug.sample_homography_difficulty(np.random.default_rng(3), 64, 80, d, a)
        np.testing.assert_array_equal(got, want)


def _feed_jax_augmentation(monkeypatch):
    """The port's batch builder draws JAX's augmentation: the generator it
    seeds with the integer JAX seeds ``PRNGKey`` with; the first view takes
    the first key of the split, the second the second."""
    seen = {}

    def augment(generator, image, conf=taug.LG_PRESET):
        k0, k1 = jax.random.split(jax.random.PRNGKey(generator.initial_seed()))
        key = k1 if id(generator) in seen else k0
        seen[id(generator)] = generator  # keeps the id unique while in use
        return taug.apply_photometric(image, _jax_draw(key, image.shape, conf), conf)

    monkeypatch.setattr(taug, "photometric_augment", augment)


@pytest.fixture
def jax_batch_jitted(monkeypatch):
    """JAX's batch builder with its augmentation, warp and labels under
    ``jax.jit`` (the same functions, compiled once per shape; op by op they
    compile every operation)."""
    from comet_tpu.matching import benchmarks as jbench
    from comet_tpu.matching import gt_generation as jgt

    monkeypatch.setattr(jaug, "photometric_augment",
                        jax.jit(jaug.photometric_augment, static_argnums=2))
    monkeypatch.setattr(jbench, "warp_image", jax.jit(jbench.warp_image))
    monkeypatch.setattr(jgt, "gt_matches_from_homography", jax.jit(
        jgt.gt_matches_from_homography, static_argnames=("pos_threshold", "neg_threshold")))


def test_homography_training_batch_matches_jax(sp_params, jax_batch_jitted, monkeypatch):
    """A batch of 2 from a SuperPoint of 32 keypoints on 64 x 64 textures:
    labels equal, keypoints and descriptors within 1e-5."""
    from comet_tpu.matching import registry as jreg
    from comet_tpu_torch.matching import registry as treg

    _feed_jax_augmentation(monkeypatch)
    kw = dict(batch_size=2, image_hw=(64, 64), th_positive=3.0, th_negative=5.0)
    jext = jreg.get_model("extractor_superpoint", max_keypoints=N, params_path=sp_params)
    text = treg.get_model("extractor_superpoint", max_keypoints=N, params_path=sp_params)
    want = jtrain.make_homography_training_batch(jext, np.random.default_rng(8), **kw)
    got = ttrain.make_homography_training_batch(text, np.random.default_rng(8), device="cpu", **kw)
    assert set(got) == set(want)
    for k in ("gt0", "gt1"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("kpts0", "kpts1", "desc0", "desc1"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0)
    assert (np.asarray(want["gt0"]) >= 0).sum() > 4


# ------------------------------------------------------------ train steps

def _params_close(module, jparams, grads0, steps):
    """The port's weights against JAX's after ``steps`` Adam steps (see the
    module docstring; ``grads0``: the first step's gradients); returns the
    number of entries held as noise."""
    want = module_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), module)
    g0 = {k: np.abs(v.numpy()) for k, v in grads0.items()}
    floor = NOISE * max(g.max() for g in g0.values())
    noisy = 0
    for name, p in module.named_parameters():
        w = want[name].numpy()
        noise = g0[name] < floor
        diff = np.abs(p.detach().numpy() - w)
        # a LayerNorm scale (all 1 at the start) or a single bias has almost
        # no range: its largest |value| stands in; a bias that starts at 0
        # has only the range Adam gives it, at most lr per step
        lim = max(GRAD_TOL * max(w.max() - w.min(), np.abs(w).max()), ADAM_TOL * LR * steps)
        assert (diff[~noise] <= lim).all(), (name, diff[~noise].max(), lim)
        assert (diff[noise] <= 2 * LR * steps).all(), (name, diff[noise].max())
        noisy += int(noise.sum())
    return noisy


@pytest.mark.parametrize("matcher", ["lightglue", "superglue"])
def test_train_steps_match_jax(lg_vars, sg_vars, matcher):
    """Three steps from the same weights on the same batch: each loss, and
    the weights after the third, against JAX's jitted step and optax.adam."""
    if matcher == "lightglue":
        jm, jvars, conf, cls = jlg.LightGlueMatcher(**LG), lg_vars, LG, tlg.LightGlueMatcher
        jstep = jtrain.build_matcher_train_step(jm, optax.adam(LR))
        tstep = ttrain.build_matcher_train_step()
    else:
        jm, jvars, conf, cls = jsg.SuperGlueMatcher(**SG), sg_vars, SG, tsg.SuperGlueMatcher
        jstep = jtrain.build_superglue_train_step(jm, optax.adam(LR))
        tstep = ttrain.build_superglue_train_step()
    b = _batch(5)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(v) for k, v in b.items()}
    port = _port(cls, conf, jvars)
    opt = ttrain.make_adam(port, LR)
    params, state = jvars, optax.adam(LR).init(jvars)

    grads0 = None
    for _ in range(3):
        params, state, want = jstep(params, state, jb)
        got = tstep(port, opt, tb)
        assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
        if grads0 is None:  # the first step's gradients, to tell noise entries apart
            grads0 = {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
                      for n, p in port.named_parameters()}
    _params_close(port, params, grads0, 3)


# ------------------------------------------------------------ checkpoints

def _flat(tree, prefix=""):
    """path -> (shape, dtype) of a flax state dict (an empty map a leaf)."""
    if isinstance(tree, dict):
        if not tree:
            return {prefix: "empty"}
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    a = np.asarray(tree)
    return {prefix: (a.shape, a.dtype.name)}


def test_adam_state_round_trips_through_optax_layout(lg_vars):
    """adam_state_to_jax after two port steps has optax.adam's tree (the
    paths, shapes and dtypes of ``optax.adam(...).init``'s state dict), and
    adam_state_from_jax restores it into a fresh Adam exactly."""
    from flax import serialization

    port = _port(tlg.LightGlueMatcher, LG, lg_vars)
    opt = ttrain.make_adam(port, LR)
    step = ttrain.build_matcher_train_step()
    tb = {k: _t(v) for k, v in _batch(6).items()}
    for _ in range(2):
        step(port, opt, tb)
    tree = texp.adam_state_to_jax(opt, port)
    assert _flat(tree) == _flat(serialization.to_state_dict(optax.adam(LR).init(lg_vars)))
    assert int(tree["0"]["count"]) == 2
    fresh = ttrain.make_adam(port, LR)
    assert texp.adam_state_from_jax(tree, fresh, port) == 2
    for p in port.parameters():
        a, b = opt.state.get(p, {}), fresh.state[p]
        if "exp_avg" in a:
            assert torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"],
                                                                           b["exp_avg_sq"])
            assert float(a["step"]) == float(b["step"])
        else:  # unreached by the loss (the token confidences): zero moments
            assert not b["exp_avg"].any()


def _save_sequence(save, exp_dir, tree, opt):
    best = None
    for step, loss, ev in ((1, 0.9, None), (2, 0.5, 3.0), (3, 0.7, 2.0), (4, 0.6, 2.5),
                           (5, 0.4, None), (6, 0.8, 9.0), (7, 0.3, 1.0)):
        _, best = save(exp_dir, step, tree, opt, conf={"experiment": "x"}, loss=loss,
                       eval_metric=ev, best_eval=best, num_keep=3)
    return best


def test_save_experiment_writes_what_jax_writes(lg_vars, tmp_path):
    """The same saves in both packages: the same files, sidecars, rotation
    and best; each checkpoint byte for byte flax's ``to_bytes``; JAX's
    ``load_checkpoint`` reads the port's with and without a template."""
    jopt = optax.adam(LR).init(lg_vars)
    port = _port(tlg.LightGlueMatcher, LG, lg_vars)
    tree, topt = module_params_to_jax(port), texp.adam_state_to_jax(ttrain.make_adam(port, LR),
                                                                     port)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jbest = _save_sequence(jexp.save_experiment, jdir, lg_vars, jopt)
    tbest = _save_sequence(texp.save_experiment, tdir, tree, topt)
    assert jbest == tbest == 0.4
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    assert len(os.listdir(tdir)) == 2 * 4  # 3 kept and the best, with sidecars
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    for get_last in (False, True):
        jt, jmeta = jexp.load_checkpoint(tdir, template={"params": lg_vars, "opt": jopt},
                                         get_last=get_last)
        raw, _ = jexp.load_checkpoint(tdir, get_last=get_last)
        assert jmeta["step"] == (7 if get_last else 5) and "opt" in raw
        assert int(jt["opt"][0].count) == 0
        for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(jt["params"]),
                                    jax.tree_util.tree_leaves_with_path(lg_vars)):
            assert pa == pb and np.array_equal(np.asarray(a), np.asarray(b))


def test_jax_pipeline_loads_a_port_checkpoint(sp_params, lg_vars, tmp_path, monkeypatch):
    """A port-trained LightGlue saved by the port: JAX's pipeline loaded from
    the directory gives the port pipeline's matches on a pair."""
    from comet_tpu_torch.matching import benchmarks as tbench

    name = "superpoint+lightglue_homography"
    for configs in (jconfigs, tconfigs):
        exp = copy.deepcopy(configs.EXPERIMENTS[name])
        exp["extractor"].update(params_path=sp_params, max_keypoints=64)
        exp["matcher"].update(LG)
        monkeypatch.setitem(configs.EXPERIMENTS, name, exp)
    m = jlg.LightGlueMatcher(**LG)
    jvars = jax.tree_util.tree_map(np.asarray, jax.jit(m.init)(
        jax.random.PRNGKey(9), jnp.zeros((8, 2)), jnp.zeros((8, 256)), jnp.zeros((8, 2)),
        jnp.zeros((8, 256))))
    port = tlg.LightGlueMatcher(**LG, in_dim=256)
    port.load_state_dict(module_params_from_jax(jvars, port))
    opt = ttrain.make_adam(port, LR)
    tb = {k: _t(v) for k, v in _batch(7).items()}
    tb["desc0"] = torch.randn(B, N, 256, generator=torch.Generator().manual_seed(0))
    tb["desc1"] = tb["desc0"] + 0.1
    ttrain.build_matcher_train_step()(port, opt, tb)
    exp_dir = str(tmp_path / "exp")
    texp.save_experiment(exp_dir, 1, module_params_to_jax(port), texp.adam_state_to_jax(opt, port),
                         loss=1.0)
    jpipe = jconfigs.build_pipeline(name, (64, 64))
    tpipe = tconfigs.build_pipeline(name, (64, 64))
    jexp.load_experiment_into_pipeline(jpipe, exp_dir)
    texp.load_experiment_into_pipeline(tpipe, exp_dir)
    img0, img1, _ = tbench.make_synthetic_pairs(1, (64, 64), seed=2, device="cpu")[0]
    want = jpipe(jnp.asarray(img0.numpy()), jnp.asarray(img1.numpy()))
    got = tpipe(img0, img1)
    np.testing.assert_array_equal(got["matches0"].numpy(), np.asarray(want["matches0"]))
    assert (np.asarray(want["matches0"]) >= 0).sum() >= 3


def test_a_jax_checkpoint_resumes_in_the_port(lg_vars, tmp_path):
    """JAX trains one step and saves params and optax state; the port
    resumes from the file (weights and Adam's state) and its next step's
    loss and weights equal JAX's resumed step's."""
    jm = jlg.LightGlueMatcher(**LG)
    jstep = jtrain.build_matcher_train_step(jm, optax.adam(LR))
    b1, b2 = _batch(10), _batch(11)
    params, state, _ = jstep(lg_vars, optax.adam(LR).init(lg_vars),
                             {k: jnp.asarray(v) for k, v in b1.items()})
    exp_dir = str(tmp_path / "jax")
    jexp.save_experiment(exp_dir, 1, params, state, loss=1.0)
    params, state, want = jstep(params, state, {k: jnp.asarray(v) for k, v in b2.items()})

    tree, meta = texp.load_checkpoint(exp_dir, get_last=True)
    port = tlg.LightGlueMatcher(**LG, in_dim=D)
    port.load_state_dict(module_params_from_jax(tree["params"], port))
    opt = ttrain.make_adam(port, LR)
    assert texp.adam_state_from_jax(tree["opt"], opt, port) == 1 and meta["step"] == 1
    got = ttrain.build_matcher_train_step()(port, opt, {k: _t(v) for k, v in b2.items()})
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in
             port.named_parameters()}
    _params_close(port, params, grads, 2)


# ------------------------------------------------------------ the CLI

CLI_KP = 64
_PORT_INIT = tcli._init_matcher  # the port's own initialization
TRAIN_ARGS = ["match", "--train", "--experiment", "superpoint+lightglue_homography",
              "--image-size", "64", "--batch-size", "2", "--ckpt-every", "1"]


@pytest.fixture
def train_conf(sp_params, jax_batch_jitted, monkeypatch):
    """The experiment cut to a LightGlue of depth 2 and width 32 over a
    SuperPoint of 64 keypoints (shared weights; with 32 the validation pair
    has too few matches for a homography); the port's matcher starts
    from JAX's ``PRNGKey(seed)`` weights, its augmentation from JAX's draws."""
    name = "superpoint+lightglue_homography"
    for configs in (jconfigs, tconfigs):
        exp = copy.deepcopy(configs.EXPERIMENTS[name])
        exp["extractor"].update(params_path=sp_params, max_keypoints=CLI_KP)
        exp["matcher"].update(LG)
        monkeypatch.setitem(configs.EXPERIMENTS, name, exp)
    _feed_jax_augmentation(monkeypatch)
    from comet_tpu.matching import registry as jreg

    get_model = jreg.get_model

    def jitted_matchers(name, **conf):  # JAX's CLI inits its matcher op by op otherwise
        m = get_model(name, **conf)
        return _Jitted(m) if name.startswith("matcher_") else m

    monkeypatch.setattr(jreg, "get_model", jitted_matchers)

    def init(matcher, in_dim, seed):
        z = jnp.zeros((CLI_KP, 2))
        jvars = jax.jit(jlg.LightGlueMatcher(**LG).init)(jax.random.PRNGKey(seed), z,
                                                         jnp.zeros((CLI_KP, in_dim)), z,
                                                         jnp.zeros((CLI_KP, in_dim)))
        m = type(matcher)(**matcher.conf, in_dim=in_dim)
        m.load_state_dict(module_params_from_jax(jax.tree_util.tree_map(np.asarray, jvars), m))
        return m

    monkeypatch.setattr(tcli, "_init_matcher", init)


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out.splitlines()


def _sidecars(d):
    out = {}
    for name in sorted(os.listdir(d)):
        if name.endswith(".json"):
            with open(os.path.join(d, name)) as f:
                out[name] = json.load(f)
    return out


def _same_sidecars(got, want):
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g["step"] == w["step"] and g["conf"] == w["conf"], name
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4, err_msg=name)
        if w["eval"] is None or not np.isfinite(w["eval"]):
            assert g["eval"] == w["eval"], name
        else:
            np.testing.assert_allclose(g["eval"], w["eval"], rtol=1e-3, err_msg=name)


def test_match_train_prints_jax_lines_and_writes_its_files(train_conf, jax_draws, tmp_path,
                                                          capsys):
    """``match --train --steps 2 --ckpt-every 1 --exp-dir DIR --val-pairs 1``
    then ``--resume --steps 1``: the same progress lines, JSON keys, losses, checkpoint
    files and sidecars (best keyed on the validation H error), and
    ``log.txt`` in the directory."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    first = ["--steps", "2", "--val-pairs", "1"]
    want = _run(jcli.main, TRAIN_ARGS + ["--exp-dir", jdir] + first, capsys)
    got = _run(tcli.main, TRAIN_ARGS + ["--exp-dir", tdir, "--device", "cpu"] + first, capsys)
    row, jrow = json.loads(got[-1]), json.loads(want[-1])
    assert list(row) == list(jrow) and row["steps"] == 2 and row["exp_dir"] == tdir
    for k in ("loss_first", "loss_last", "best_eval"):
        np.testing.assert_allclose(row[k], jrow[k], rtol=1e-4, err_msg=k)
    assert [line.split(":")[0] for line in got[:-1]] == [line.split(":")[0] for line in want[:-1]]
    assert sum(line.startswith("  val: H_err") for line in got) == 2
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    side = _sidecars(tdir)
    _same_sidecars(side, _sidecars(jdir))
    evals = [v["eval"] for k, v in side.items() if k != "checkpoint_best.json"]
    assert side["checkpoint_best.json"]["eval"] == min(evals) and row["best_eval"] == round(
        min(evals), 4)
    with open(os.path.join(tdir, "log.txt")) as f:
        assert f.read().splitlines() == got

    resume = ["--steps", "1", "--resume"]
    want = _run(jcli.main, TRAIN_ARGS + ["--exp-dir", jdir] + resume, capsys)
    got = _run(tcli.main, TRAIN_ARGS + ["--exp-dir", tdir, "--device", "cpu"] + resume, capsys)
    assert got[0] == f"resumed {tdir} at step 2" and want[0] == f"resumed {jdir} at step 2"
    row, jrow = json.loads(got[-1]), json.loads(want[-1])
    for k in ("loss_first", "loss_last"):
        np.testing.assert_allclose(row[k], jrow[k], rtol=1e-4, err_msg=k)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert texp.get_last_checkpoint(tdir).endswith("checkpoint_00000003.msgpack")
    _same_sidecars(_sidecars(tdir), _sidecars(jdir))


def test_match_train_superglue_without_exp_dir(train_conf, monkeypatch, tmp_path, capsys):
    """``superpoint+superglue`` trains through the SuperGlue step and, with
    no ``--exp-dir``, checkpoints to outputs/match_train_<name> under the
    working directory, as the JAX package does; the checkpoint loads into a
    SuperGlue (its train step against JAX's: test_train_steps_match_jax)."""
    name = "superpoint+superglue"
    exp = copy.deepcopy(tconfigs.EXPERIMENTS[name])
    exp["extractor"].update(tconfigs.EXPERIMENTS["superpoint+lightglue_homography"]["extractor"])
    exp["matcher"].update(SG)
    monkeypatch.setitem(tconfigs.EXPERIMENTS, name, exp)
    monkeypatch.setattr(tcli, "_init_matcher", _PORT_INIT)
    monkeypatch.chdir(tmp_path)
    row = json.loads(_run(tcli.main, ["match", "--train", "--experiment", name, "--steps", "2",
                                      "--image-size", "64", "--batch-size", "2", "--device",
                                      "cpu"], capsys)[-1])
    assert list(row) == ["experiment", "steps", "loss_first", "loss_last", "exp_dir", "best_eval"]
    assert row["exp_dir"] == os.path.join("outputs", "match_train_superpoint_superglue")
    assert np.isfinite([row["loss_first"], row["loss_last"]]).all()
    assert sorted(os.listdir(row["exp_dir"])) == [
        "checkpoint_00000001.json", "checkpoint_00000001.msgpack", "checkpoint_00000002.json",
        "checkpoint_00000002.msgpack", "checkpoint_best.json", "checkpoint_best.msgpack"]
    tree, meta = texp.load_checkpoint(row["exp_dir"], get_last=True)
    m = tsg.SuperGlueMatcher(**SG, in_dim=256)
    m.load_state_dict(module_params_from_jax(tree["params"], m))
    assert meta["step"] == 2 and int(tree["opt"]["0"]["count"]) == 2


def test_match_train_refuses_an_eval_only_experiment():
    with pytest.raises(SystemExit, match="no train block"):
        tcli.main(["match", "--train", "--device", "cpu", "--experiment", "sift+nn"])
