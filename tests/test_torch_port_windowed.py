"""The port's windowed long-sequence mode against the JAX package's.

``models/windowed.py`` (the schedule, the teacher-forcing scheduler, the
uvz composition, the host loop ``windowed_forward`` and the scan form
``windowed_forward_scan``) and ``training/loop.py::build_windowed_train_step``,
on the CPU, on the same numpy inputs and the same weights as
``comet_tpu``'s, in f32.

Tolerances: the schedule and the scheduler's decisions equal; the
composition within 1e-6 (a few f32 operations); both stitching forms within
1e-6 of JAX's with the deterministic fake model of tests/test_windowed.py
(its table lookups, then the composition); the port's scan form against its
own host loop on the real tiny model: tracks exactly, encodings within 1e-6
(the scan form rewrites each window's frame 0 with the anchor composed with
the identity, which need not round back to the anchor; JAX's own pair
agreed to 1.2e-7, PROFILE.md:57-60). One window of the real tiny model
against JAX's within the forward tolerances of
tests/test_torch_port_models.py (2e-2 px on tracks, 5e-3 on poses). Two
chained windows are held only to 2 px on tracks and 5e-2 on poses: the
second window's queries are the first window's tracks, and with random
weights the tracker amplifies a difference in its queries about 800x per
window (PROFILE.md:54-69), so the first window's 1e-4 px become ~0.1 px.
The windowed train steps (marked slow: JAX's step compiles for ~55 s, so
they run with ``-m slow``) are held to tests/test_torch_port_train.py's step
tolerances (the loss within 1e-4 relative, the camera parameters within
1e-2 x the sum of the step sizes, with its rule for elements whose gradient
is rounding, applied at each of the three steps, with its threshold at
1e-4 of the tensor's largest gradient instead of 1e-5: through the chain's
anchors a gradient summed over more terms lands there, and one element of
traj_encoder.fc1 with gradients of 3.2e-5 and 1.3e-5 of its tensor's
largest in steps 1 and 2 took an Adam step 3.5e-5 from JAX's; and a
tensor's largest gradient is floored at 1e-4 of the model's, as
chip_smoke.py's GRAD_FLOOR: the confidence-attention MLP's gradient is
f32 rounding, ~1e-8, since the context LayerNorm undoes its per-track
scale); their weights hold the trackers' coordinate updates at 0
(the first two columns of each ``flow_head``), so that the tracks stay at
the queries on both sides and the chain's differences are those of the
camera predictor, the composition and the optimizer, not the random
tracker's amplification of f32 rounding (0.15 % of the loss otherwise).
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
from comet_tpu.models import COMET as JaxCOMET
from comet_tpu.models import windowed as jwin
from comet_tpu.training import loop as jloop
from comet_tpu.training import optim as joptim
from comet_tpu_torch.geometry import cameras as tcam
from comet_tpu_torch.geometry import codecs as tcodecs
from comet_tpu_torch.models import build_comet
from comet_tpu_torch.models import windowed as twin
from comet_tpu_torch.training import build_optimizer, build_windowed_train_step, camera_only_mask
from comet_tpu_torch.weights import params_from_jax
from test_torch_port_models import _jax_params, _t, _tiny
from test_torch_port_train import _OPT, _configs, _one_torch_thread  # noqa: F401 (a fixture)

# ------------------------------------------------------------- schedule


@pytest.mark.parametrize("total,window_len", [
    (48, 8), (48, 16), (64, 16), (17, 8), (16, 16), (10, 3), (7, 1),
    (5, 4), (3, 8), (1, 4),  # mirror-padded tails
])
def test_window_schedule_matches_jax(total, window_len):
    want = jwin.window_schedule(total, window_len)
    got = twin.window_schedule(total, window_len)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("start,end,epochs", [(1.0, 0.2, 10), (0.8, 0.0, 3), (1.0, 0.2, 300)])
def test_teacher_forcing_scheduler_matches_jax(start, end, epochs):
    want, got = jwin.TeacherForcingScheduler(start, end, epochs), \
        twin.TeacherForcingScheduler(start, end, epochs)
    for epoch in range(epochs + 3):
        assert got.ratio(epoch) == want.ratio(epoch), epoch
    rng_w, rng_g = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(200):
        epoch = i % (epochs + 2)
        assert got.use_teacher_forcing(epoch, rng_g) == want.use_teacher_forcing(epoch, rng_w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compose_uvz_matches_jax(seed):
    rng = np.random.default_rng(seed)
    anchor = rng.normal(size=7).astype(np.float32)
    anchor[3:] /= np.linalg.norm(anchor[3:])
    window = rng.normal(size=(6, 7)).astype(np.float32)
    want = jwin.compose_uvz_encodings(jnp.asarray(anchor), jnp.asarray(window), jnp.float32(0.7))
    got = twin.compose_uvz_encodings(_t(anchor), _t(window), torch.tensor(0.7))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


# ------------------------------------------------------------ stitching


def _trajectory(rng, t):
    q = rng.normal(size=(t, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t_uvz = rng.normal(size=(t, 3)).astype(np.float32)
    t_uvz[:, 2] = np.abs(t_uvz[:, 2]) + 2.0
    return dict(q=q, t_xyz=rng.normal(size=(t, 3)).astype(np.float32), t_uvz=t_uvz,
                focal=np.full((t, 2), 2.0, np.float32), ratio=np.float32(0.5))


def _anchor_table(cams, t):
    """table[a, f]: the encoding of frame f relative to frame a (f >= a),
    the fake model's answers to both packages."""
    table = np.zeros((t, t, 7), np.float32)
    for a in range(t):
        sub = tcam.make_camera_set(**{k: torch.from_numpy(v[a:]) if k != "ratio" else v
                                      for k, v in cams.items()})
        table[a, a:] = tcodecs.encode_relative_uvz(sub)[:, :7].numpy()
    return table


def _fake_jax(table):
    """tests/test_windowed.py's traceable fake model: the frame indices read
    back from the images, the encodings gathered from the table, the seeded
    queries echoed as every frame's tracks."""
    tab = jnp.asarray(table)

    def apply(win_images, win_queries):
        f_idx = win_images[0, :, 0, 0, 0].astype(jnp.int32)
        enc = jnp.take(jnp.take(tab, f_idx[0], axis=0), f_idx, axis=0)
        tracks = jnp.broadcast_to(win_queries[:, None], (1, f_idx.shape[0], *win_queries.shape[1:]))
        return {"pred_pose_enc": enc[None], "pred_track": tracks + f_idx[None, :, None, None]}

    return apply


def _fake_port(table):
    tab = torch.from_numpy(table)

    def apply(win_images, win_queries):
        f_idx = win_images[0, :, 0, 0, 0].long()
        enc = tab[f_idx[0]][f_idx]
        tracks = win_queries[:, None].expand(1, f_idx.shape[0], *win_queries.shape[1:])
        return {"pred_pose_enc": enc[None], "pred_track": tracks + f_idx[None, :, None, None]}

    return apply


@pytest.mark.parametrize("form", ["windowed_forward", "windowed_forward_scan"])
@pytest.mark.parametrize("teacher_force", [False, True])
@pytest.mark.parametrize("total,window_len", [(16, 8), (13, 4)])
def test_stitching_matches_jax(form, teacher_force, total, window_len):
    rng = np.random.default_rng(total + window_len)
    cams = _trajectory(rng, total)
    table = _anchor_table(cams, total)
    gt_enc = np.asarray(jcodecs.encode_relative_uvz(jcam.make_camera_set(**cams)))
    # each frame's index written into its pixels, which the fake reads back
    images = np.broadcast_to(np.arange(total, dtype=np.float32)[None, :, None, None, None],
                             (1, total, 4, 4, 3)).copy()
    queries = (rng.random((1, 5, 2)) * 8).astype(np.float32)
    kw = dict(gt_enc=gt_enc, teacher_force=teacher_force)
    want = getattr(jwin, form)(_fake_jax(table), jnp.asarray(images), jnp.asarray(queries),
                               window_len, jnp.float32(cams["ratio"]),
                               **{**kw, "gt_enc": jnp.asarray(gt_enc)})
    got = getattr(twin, form)(_fake_port(table), _t(images), _t(queries), window_len,
                              torch.tensor(cams["ratio"]), **{**kw, "gt_enc": _t(gt_enc)})
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    # the chain reproduces the trajectory of the fake's table
    sign = np.sign(np.sum(got[0][0, :, 3:].numpy() * gt_enc[:, 3:7], -1, keepdims=True))
    np.testing.assert_allclose(got[0][0, :, :3].numpy(), gt_enc[:, :3], atol=1e-4)
    np.testing.assert_allclose(got[0][0, :, 3:].numpy() * sign, gt_enc[:, 3:7], atol=1e-4)


@pytest.mark.parametrize("teacher_force", [False, True])
def test_scan_chain_is_differentiable(teacher_force):
    """A loss on the last frame reaches the first window's encodings
    through the chained anchors; with teacher forcing the anchors are the
    ground truth's and it does not."""
    total, window_len = 12, 4
    leaves = []

    def apply(win_images, win_queries):
        enc = torch.zeros(1, window_len, 7)
        enc[..., 3] = 1.0
        enc = enc + 0.01 * torch.arange(window_len * 7.0).reshape(1, window_len, 7)
        enc.requires_grad_(True)
        leaves.append(enc)
        return {"pred_pose_enc": enc, "pred_track": win_queries[:, None].expand(1, window_len, 3, 2)}

    gt_enc = torch.zeros(total, 8)
    gt_enc[:, 3] = 1.0
    enc, _ = twin.windowed_forward_scan(apply, torch.zeros(1, total, 2, 2, 3), torch.zeros(1, 3, 2),
                                        window_len, torch.tensor(0.5), gt_enc=gt_enc,
                                        teacher_force=teacher_force)
    assert len(leaves) == len(twin.window_schedule(total, window_len)) == 5
    enc[0, -1].sum().backward()
    first = leaves[0].grad
    assert (first is not None and bool(first.abs().sum() > 0)) == (not teacher_force)
    assert leaves[-1].grad.abs().sum() > 0


@pytest.mark.parametrize("total,window_len", [(3, 8), (5, 8), (1, 2)])
def test_scan_raises_on_repeated_frames(total, window_len):
    with pytest.raises(ValueError, match="windowed_forward"):
        twin.windowed_forward_scan(lambda *a: None, torch.zeros(1, total, 2, 2, 3),
                                   torch.zeros(1, 3, 2), window_len, torch.tensor(0.5))


# ---------------------------------------------------- the real tiny model


@pytest.fixture(scope="module")
def real():
    """The tiny config at seqlen 2, its weights, a 4-frame sequence, and
    JAX's jitted forward."""
    jc, tc = _tiny(jcfg), _tiny(tcfg)
    rng = np.random.default_rng(21)
    images = rng.normal(size=(1, 4, jc.img_size, jc.img_size, 3)).astype(np.float32)
    queries = (rng.random((1, jc.track_num, 2)) * (jc.img_size - 20) + 10).astype(np.float32)
    params = _jax_params(jc, images[:, :2], queries, seed=22)
    apply = jax.jit(lambda im, q: JaxCOMET(jc).apply({"params": params}, im, q))
    return dict(jc=jc, tc=tc, images=images, queries=queries, params=params, apply=apply)


def _port_model(real, route=None):
    model = build_comet(real["tc"], device="cpu", route=route or tcfg.KernelRoute())
    model.load_state_dict(params_from_jax({"params": real["params"]}, real["tc"]))
    return model


@pytest.mark.parametrize("route", ["default", "fused"])
def test_scan_equals_the_host_loop_on_the_real_model(real, route):
    model = _port_model(real, tcfg.FUSED_ROUTE if route == "fused" else None)
    images, queries = _t(real["images"]), _t(real["queries"])
    with torch.no_grad():
        enc_h, trk_h = twin.windowed_forward(model, images, queries, 2, torch.tensor(0.5))
        enc_s, trk_s = twin.windowed_forward_scan(model, images, queries, 2, torch.tensor(0.5))
    assert torch.equal(trk_s, trk_h)
    torch.testing.assert_close(enc_s, enc_h, atol=1e-6, rtol=0)
    assert torch.isfinite(enc_s).all() and torch.equal(enc_s[0, 0], enc_h[0, 0])
    torch.testing.assert_close(enc_s[0, 0], torch.tensor([0.0, 0, 0, 1, 0, 0, 0]), atol=0, rtol=0)


@pytest.mark.parametrize("frames,track_atol,pose_atol", [(2, 2e-2, 5e-3), (3, 2.0, 5e-2)],
                         ids=["one window", "two windows"])
def test_real_model_windows_match_jax(real, frames, track_atol, pose_atol):
    images, queries = real["images"][:, :frames], real["queries"]
    want = jwin.windowed_forward(real["apply"], jnp.asarray(images), jnp.asarray(queries), 2,
                                 jnp.float32(0.5))
    with torch.no_grad():
        got = twin.windowed_forward(_port_model(real), _t(images), _t(queries), 2,
                                    torch.tensor(0.5))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=track_atol, rtol=2e-2)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=pose_atol, rtol=5e-3)
    if frames == 2:  # one window: the plain forward
        with torch.no_grad():
            direct = _port_model(real)(_t(images), _t(queries))
        torch.testing.assert_close(got[0], direct["pred_pose_enc"], atol=1e-6, rtol=0)
        torch.testing.assert_close(got[1], direct["pred_track"], atol=0, rtol=0)


# ------------------------------------------------------- the train step


@pytest.fixture(scope="module")
def windowed_train():
    """The train tests' config (seqlen 3), a 4-frame sequence (2 windows)
    and JAX's windowed train step, 3 steps with and 3 without teacher
    forcing from the same start."""
    jc, tc = _configs()
    total = 4
    rng = np.random.default_rng(31)
    images = rng.normal(size=(1, total, jc.img_size, jc.img_size, 3)).astype(np.float32)
    queries = (rng.random((1, jc.track_num, 2)) * (jc.img_size - 20) + 10).astype(np.float32)
    cams = _trajectory(rng, total)
    cams["t_uvz"][:, :2] *= 50
    params = _jax_params(jc, images[:, :jc.seqlen], queries, seed=32)
    for tracker in ("coarse_tracker", "fine_tracker"):
        head = params[tracker]["updateformer"]["flow_head"]
        head["kernel"] = np.asarray(head["kernel"]).copy()
        head["bias"] = np.asarray(head["bias"]).copy()
        head["kernel"][..., :2] = 0.0
        head["bias"][:2] = 0.0
    tx, schedule = joptim.build_optimizer({"params": params}, **_OPT)
    step = jloop.build_windowed_train_step(JaxCOMET(jc), jc, tx, jc.seqlen)
    gt = jcam.make_camera_set(**cams)
    runs = {}
    for tf in (False, True):
        state = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
        opt_state = tx.init(state)
        auxes = []
        for _ in range(3):
            state, opt_state, aux = step(state, opt_state, jnp.asarray(images),
                                         jnp.asarray(queries), gt, teacher_force=tf)
            auxes.append({k: np.asarray(v) for k, v in aux.items()})
        runs[tf] = dict(after=state["params"], auxes=auxes)
    return dict(tc=tc, images=images, queries=queries, cams=cams, params=params, runs=runs,
                lrs=[float(schedule(i)) for i in range(3)], window_len=jc.seqlen)


# below this share of its tensor's largest gradient an element's Adam step
# follows f32 rounding (see the module's docstring)
ROUNDING = 1e-4
# a tensor whose largest gradient is below this share of the model's is
# itself at rounding level (the confidence-attention MLP's: the context
# LayerNorm undoes its per-track scale, chip_smoke.py's GRAD_FLOOR)
FLOOR = 1e-4


@pytest.mark.slow  # JAX's windowed train step compiles for ~55 s on the test host
@pytest.mark.parametrize("teacher_force", [False, True])
def test_three_windowed_train_steps_match_jax(windowed_train, teacher_force):
    w = windowed_train
    tc, run = w["tc"], w["runs"][teacher_force]
    model = build_comet(tc, device="cpu")
    model.load_state_dict(params_from_jax({"params": w["params"]}, tc))
    optimizer, scheduler = build_optimizer(model, **_OPT)
    step = build_windowed_train_step(model, tc, optimizer, scheduler, w["window_len"])
    gt = tcam.make_camera_set(**{k: torch.from_numpy(np.asarray(v)) for k, v in w["cams"].items()})
    auxes, unresolved = [], {}
    for i in range(3):
        auxes.append(step(_t(w["images"]), _t(w["queries"]), gt, teacher_force=teacher_force))
        # the train test's rule, applied at every step: an element whose
        # gradient is near rounding level in any step takes an Adam step of
        # that rounding's sign there
        grads = {n: p.grad.abs() for n, p in model.named_parameters() if p.grad is not None}
        top = max(float(g.max()) for g in grads.values())
        for n, g in grads.items():
            m = float(g.max())
            small = g < (ROUNDING * m if m >= FLOOR * top else float("inf"))
            unresolved[n] = small | unresolved[n] if n in unresolved else small
        if i == 0:
            zero = sum(int((p.grad == 0).sum()) for p in model.parameters() if p.grad is not None)
    for i, (got, want) in enumerate(zip(auxes, run["auxes"])):
        assert set(got) == set(want)
        assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-4), i
        np.testing.assert_allclose(got["pred_pose_enc"].numpy(), want["pred_pose_enc"], atol=5e-3)
        assert not any(v.requires_grad for v in got.values())
    after = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, run["after"])}, tc)
    before = params_from_jax({"params": w["params"]}, tc)
    mask = camera_only_mask(model)
    lr_sum = sum(w["lrs"])
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
