"""The port's line stack (``lines``, ``deeplsd``, ``gluestick``) and the
registry against ``comet_tpu``'s, on the CPU, on the same numpy inputs and
the same weights (each JAX module's flax variables carried across with
``weights.module_params_from_jax``; the SuperPoint of the wireframes from one
``.msgpack``). Images are 64 x 64 (DeepLSD also 72 x 88), at most 64
keypoints and 8 lines; GlueStick runs at depth 2, width 32.

Tolerances (f32):

- the Sobel gradients within 1e-6; XLA's convolution sums its taps in an
  order that no fixed sequence of adds reproduces, so flat regions (whose
  gradient is 0) keep rounding residues of +-1e-8 of either sign in both
  packages, and the orientation of such a pixel (an ``atan2`` of them) is
  +-pi/2 depending on the sign: a march that samples one can end elsewhere.
  ``detect_line_segments`` is therefore held to JAX through its fields
  (within 1e-6; the orientation's difference times |g| within 1e-6) and its
  march (both packages' marches on the port's fields and on JAX's give the
  same segments within 1e-4 px, validity equal); the wireframe test gives JAX's
  wireframe the port's segments, so that the rest compares exactly;
- line segments within 1e-4 px with the anchors (validity) equal, scores
  within 1e-5;
- DeepLSD's fields within 1e-5 of each field's range;
- GlueStick's log assignments within 1e-4 of the largest |value|, its
  matches equal (both ``line_attention`` settings);
- ``gluestick_nll_loss`` and ``deeplsd_field_loss`` within 1e-5 relative,
  their gradients within 1e-5 of the largest |gradient|;
- the registry and the 11 experiments: ``test_torch_port_registry.py``; the
  two line experiments' rows are held to JAX's in
  ``test_torch_port_match_cli.py``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu.matching import deeplsd as jdl
from comet_tpu.matching import gluestick as jgs
from comet_tpu.matching import lines as jlines
from comet_tpu.matching import registry as jreg
from comet_tpu.matching import sift as jsift
from comet_tpu_torch.matching import benchmarks as tbench
from comet_tpu_torch.matching import deeplsd as tdl
from comet_tpu_torch.matching import gluestick as tgs
from comet_tpu_torch.matching import lines as tlines
from comet_tpu_torch.matching import registry as treg
from comet_tpu_torch.weights import module_params_from_jax, module_params_to_jax
from torch_port_line_helpers import one_torch_thread  # noqa: F401

SIZE = 64
GS = dict(depth=2, dim=32, filter_threshold=0.0)
SEG_TOL = 1e-4
FIELD_TOL = 1e-5
LOG_TOL = 1e-4
LOSS_RTOL = 1e-5


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _n(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol, what=""):
    got, want = np.asarray(_n(got), np.float64), np.asarray(_n(want), np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def scene(seed, h=SIZE, w=SIZE):
    """A gray image in [0, 1]: a smooth texture under a few flat rectangles
    and a bar, so that straight edges are there to detect."""
    rng = np.random.default_rng(seed)
    img = 0.3 * tbench.synthetic_texture(rng, h, w)[..., 0]
    for _ in range(3):
        y0, x0 = rng.integers(4, h // 2), rng.integers(4, w // 2)
        img[y0:y0 + rng.integers(12, h // 2), x0:x0 + rng.integers(12, w // 2)] = rng.uniform(
            0.5, 1.0)
    img[h // 2:h // 2 + 3, 6:w - 6] = 0.9
    return img.astype(np.float32)


# ------------------------------------------------------------ lines

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lsd_segments_match_jax(seed):
    """``detect_line_segments``: the fields within 1e-6 (the orientation's
    difference times the gradient's magnitude; on the same gradients the
    magnitude bit for bit), and the march of each package on either
    package's fields the same."""
    gray = scene(seed)
    gx, gy = jlines.image_gradients(jnp.asarray(gray))
    tgx, tgy = tlines.image_gradients(_t(gray))
    _close(tgx, gx, 1e-6, "gx")
    _close(tgy, gy, 1e-6, "gy")
    jfields = (jnp.sqrt(gx * gx + gy * gy), jnp.arctan2(gy, gx))
    tfields = (tlines.gradient_magnitude(tgx, tgy), torch.atan2(tgy, tgx))
    _close(tfields[0], jfields[0], 1e-6, "magnitude")
    # on JAX's own gradients, JAX's magnitude bit for bit (both correctly rounded)
    np.testing.assert_array_equal(_n(tlines.gradient_magnitude(_t(gx), _t(gy))),
                                  np.asarray(jfields[0]))
    # the orientation: its difference (2 pi wrapped) times |g|, the gradient's
    # perpendicular part, within the gradients' 1e-6
    dth = np.abs(_n(tfields[1]).astype(np.float64) - np.asarray(jfields[1]))
    dth = np.minimum(dth, 2 * np.pi - dth)
    assert (dth * np.asarray(jfields[0])).max() <= 1e-6
    got = tlines.detect_line_segments(_t(gray), max_lines=8)
    # the march, op by op on both sides, on the port's fields and on JAX's
    for fields in ([_n(f) for f in tfields], [np.asarray(f) for f in jfields]):
        want = jlines.march_segments_from_fields(*(jnp.asarray(f) for f in fields), max_lines=8)
        replay = tlines.march_segments_from_fields(*(_t(f) for f in fields), max_lines=8)
        np.testing.assert_array_equal(_n(replay.valid), np.asarray(want.valid))
        _close(replay.segments, want.segments, SEG_TOL, "segments")
        _close(replay.scores, want.scores, FIELD_TOL, "scores")
    assert int(want.valid.sum()) >= 2
    np.testing.assert_array_equal(_n(got.valid), np.asarray(
        jlines.march_segments_from_fields(*(jnp.asarray(_n(f)) for f in tfields),
                                          max_lines=8).valid))


def test_marching_from_fields_matches_jax():
    """``march_segments_from_fields`` (few anchors: ties of -inf in the top-k)
    and DeepLSD's ``extract_lines_from_fields`` on smooth random fields."""
    rng = np.random.default_rng(4)
    df = np.abs(tbench.resize_cubic(rng.normal(size=(8, 8, 1)).astype(np.float32), SIZE,
                                    SIZE)[..., 0]) * 3
    angle = np.mod(tbench.resize_cubic(rng.normal(size=(4, 4, 1)).astype(np.float32), SIZE,
                                       SIZE)[..., 0], np.pi).astype(np.float32)
    mag = np.exp(-df).astype(np.float32)
    cases = [
        (tlines.march_segments_from_fields(_t(mag), _t(angle), max_lines=8, mag_threshold=0.6),
         jlines.march_segments_from_fields(mag, angle, max_lines=8, mag_threshold=0.6)),
        (tdl.extract_lines_from_fields(_t(df), _t(angle), max_lines=8),
         jdl.extract_lines_from_fields(df, angle, max_lines=8)),
    ]
    for got, want in cases:
        np.testing.assert_array_equal(_n(got.valid), np.asarray(want.valid))
        _close(got.segments, want.segments, SEG_TOL, "segments")
        _close(got.scores, want.scores, FIELD_TOL, "scores")
    assert not np.asarray(cases[0][1].valid).all()


def test_line_sampling_and_nn_matching_match_jax():
    rng = np.random.default_rng(5)
    segs = rng.uniform(-4, SIZE + 4, (8, 2, 2)).astype(np.float32)
    _close(tlines.sample_line_points(_t(segs), 8), jlines.sample_line_points(segs, 8), 1e-7,
           "points")
    np.testing.assert_array_equal(_n(tlines.linspace01(8)), np.asarray(jnp.linspace(0.0, 1.0, 8)))
    dmap = rng.normal(size=(SIZE, SIZE, 3)).astype(np.float32)
    d0 = tlines.sample_line_descriptors(_t(dmap), _t(segs))
    _close(d0, jlines.sample_line_descriptors(dmap, segs), 1e-6, "descriptors")
    segs1 = segs[::-1] + rng.normal(size=segs.shape).astype(np.float32)
    d1 = tlines.sample_line_descriptors(_t(dmap), _t(segs1))
    valid0 = np.arange(8) != 3
    got = tlines.match_lines_nn(d0, d1, valid0=torch.as_tensor(valid0))
    want = jlines.match_lines_nn(jnp.asarray(_n(d0)), jnp.asarray(_n(d1)),
                                 valid0=jnp.asarray(valid0))
    np.testing.assert_array_equal(_n(got["matches0"]), np.asarray(want["matches0"]))
    _close(got["scores0"], want["scores0"], 1e-6, "scores0")


# ------------------------------------------------------------ DeepLSD

@pytest.fixture(scope="module")
def deeplsd_nets():
    """(JAX net, its variables, the port's net with them) at base 8."""
    jnet = jdl.DeepLSDNet(base=8)
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(3), jnp.zeros((SIZE, SIZE)))
    tnet = tdl.DeepLSDNet(base=8)
    tnet.load_state_dict(module_params_from_jax(variables, tnet))
    return jnet, variables, tnet


@pytest.mark.parametrize("hw", [(SIZE, SIZE), (72, 88)])
def test_deeplsd_fields_match_jax(deeplsd_nets, hw):
    jnet, variables, tnet = deeplsd_nets
    gray = scene(7, *hw)
    want = jax.jit(jnet.apply)(variables, gray)
    with torch.no_grad():
        got = tnet(_t(gray))
    for k in ("df", "angle", "angle_vec"):
        w = np.asarray(want[k], np.float64)
        rng_ = max(float(w.max() - w.min()), 1e-12)
        if k == "angle":  # angle and angle + pi are the same orientation near 0 / pi
            diff = np.abs(_n(got[k]) - w)
            diff = np.minimum(diff, np.pi - diff)
            assert diff.max() <= FIELD_TOL * rng_, k
        else:
            np.testing.assert_allclose(_n(got[k]), w, rtol=0, atol=FIELD_TOL * rng_, err_msg=k)


def test_deeplsd_bridge_round_trip(deeplsd_nets):
    """``module_params_to_jax`` gives JAX's tree back, leaf for leaf."""
    _, variables, tnet = deeplsd_nets
    back = module_params_to_jax(tnet)
    want = dict(jax.tree_util.tree_leaves_with_path(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


def test_deeplsd_field_loss_and_gradients_match_jax(deeplsd_nets):
    jnet, variables, tnet = deeplsd_nets
    gray = scene(8)
    rng = np.random.default_rng(8)
    gt_df = np.abs(rng.normal(size=gray.shape) * 3).astype(np.float32)
    gt_angle = rng.uniform(0, np.pi, gray.shape).astype(np.float32)

    def jloss(v):
        return jdl.deeplsd_field_loss(jnet.apply(v, gray), gt_df, gt_angle)

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(variables)
    tnet.zero_grad()
    got = tdl.deeplsd_field_loss(tnet(_t(gray)), _t(gt_df), _t(gt_angle))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    grads = module_params_to_jax(tnet, {n: p.grad for n, p in tnet.named_parameters()})
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        _close(dict(jax.tree_util.tree_leaves_with_path(grads))[path], g, LOSS_RTOL, str(path))


def test_deeplsd_detector_matches_jax(deeplsd_nets):
    """``lines_deeplsd`` given JAX's variables: the same segments."""
    _, variables, _ = deeplsd_nets
    gray = scene(9)
    jdet = jreg.get_model("lines_deeplsd", base=8, max_lines=8)
    jdet.params = variables
    tdet = treg.get_model("lines_deeplsd", base=8, max_lines=8, device="cpu")
    tdet.params = variables
    want, got = jdet(gray), tdet(gray)
    np.testing.assert_array_equal(_n(got.valid), np.asarray(want.valid))
    _close(got.segments, want.segments, SEG_TOL, "segments")


# ------------------------------------------------------------ GlueStick

def _gs_inputs(seed, shared_junctions):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    inp = {}
    for s, (n, k) in enumerate(((24, 6), (20, 5))):
        desc = rng.normal(size=(n, 16))
        inp[f"kpts{s}"] = f32(rng.uniform(-1, 1, (n, 2)))
        inp[f"desc{s}"] = f32(desc / np.linalg.norm(desc, axis=-1, keepdims=True))
        inp[f"lines{s}"] = f32(rng.uniform(-1, 1, (k, 2, 2)))
        inp[f"ldesc{s}"] = f32(rng.normal(size=(k, 5, 3)))
        inp[f"valid{s}"] = np.arange(n) % 7 != 3
        inp[f"lvalid{s}"] = np.arange(k) != 1
        inp[f"scores{s}"] = f32(rng.uniform(0, 1, n))
        inp[f"line_scores{s}"] = f32(rng.uniform(0, 1, k))
        ji = np.arange(2 * k).reshape(k, 2)  # each endpoint its own junction token
        if shared_junctions:  # line 0's second endpoint is line 2's first
            ji[2, 0] = ji[0, 1]
        inp[f"junc_idx{s}"] = ji.astype(np.int32)
    return inp


def _random_variables(module, inputs, seed):
    """The module's variables drawn at random in numpy (their shapes from
    ``jax.eval_shape``), dustbins included: the scalars must cross the bridge."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), **inputs)
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) / np.sqrt(a.shape[0] if a.ndim == 2 else 1)).astype(
            np.float32), shapes)


@pytest.fixture(scope="module")
def gluestick_pair():
    """For each line_attention setting: (JAX module's jitted apply, its
    variables, the port's module with them)."""
    out = {}
    inp = _gs_inputs(0, True)
    for la in (False, True):
        jm = jgs.GlueStickMatcher(**GS, line_attention=la)
        variables = _random_variables(jm, inp, 11 + la)
        tm = tgs.GlueStickMatcher(**GS, line_attention=la, in_dim=16, line_in_dim=3)
        tm.load_state_dict(module_params_from_jax(variables, tm))
        out[la] = (jm, jax.jit(jm.apply), variables, tm.eval())
    return out


@pytest.mark.parametrize("line_attention", [False, True], ids=["scatter_mean", "attention"])
@pytest.mark.parametrize("shared", [False, True], ids=["own_junctions", "shared_junctions"])
def test_gluestick_matches_jax(gluestick_pair, line_attention, shared):
    _, apply, variables, tm = gluestick_pair[line_attention]
    inp = _gs_inputs(1, shared)
    want = apply(variables, **inp)
    with torch.no_grad():
        got = tm(**{k: torch.as_tensor(v) for k, v in inp.items()})
    assert set(got) == set(want) and len(got) == 17
    for k in ("log_assignment", "token_log_assignment", "line_log_assignment",
              "raw_line_scores"):
        _close(got[k], want[k], LOG_TOL, k)
    for k in ("matches0", "matches1", "token_matches0", "line_matches0", "line_matches1"):
        np.testing.assert_array_equal(_n(got[k]), np.asarray(want[k]), err_msg=k)
    for k in ("matching_scores0", "line_matching_scores1", "assignment", "line_assignment"):
        _close(got[k], want[k], LOG_TOL, k)
    assert int((np.asarray(want["matches0"]) >= 0).sum()) + int(
        (np.asarray(want["line_matches0"]) >= 0).sum()) > 0


def test_gluestick_bridge_round_trip(gluestick_pair):
    _, _, variables, tm = gluestick_pair[True]
    back = module_params_to_jax(tm)
    want = dict(jax.tree_util.tree_leaves_with_path(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(leaf))
    assert back["params"]["bin_score"].shape == ()
    assert float(back["params"]["line_bin_score"]) == float(variables["params"]["line_bin_score"])


def test_gluestick_nll_loss_and_gradients_match_jax(gluestick_pair):
    jm, _, variables, tm = gluestick_pair[False]
    inp = _gs_inputs(2, False)
    rng = np.random.default_rng(2)
    gt0 = rng.integers(-2, 20, 24).astype(np.int32)
    gt1 = rng.integers(-1, 24, 20).astype(np.int32)

    jinp = {k: jnp.asarray(v) for k, v in inp.items()}

    def jloss(v):
        return jgs.gluestick_nll_loss(jm.apply(v, **jinp)["log_assignment"], gt0, gt1)

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(variables)
    tm.zero_grad()
    got = tgs.gluestick_nll_loss(tm(**{k: torch.as_tensor(v) for k, v in inp.items()})[
        "log_assignment"], torch.as_tensor(gt0).long(), torch.as_tensor(gt1).long())
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    grads = dict(jax.tree_util.tree_leaves_with_path(
        module_params_to_jax(tm, {n: torch.zeros_like(p) if p.grad is None else p.grad
                                  for n, p in tm.named_parameters()})))
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        _close(grads[path], g, LOSS_RTOL, str(path))


# ------------------------------------------------------------ wireframes and the experiments

def test_wireframe_matches_jax(monkeypatch):
    """``extractor_wireframe`` at JAX's defaults (SIFT and the LSD stand-in)
    on a numpy image: every output. JAX's wireframe takes the port's
    segments (``detect_line_segments`` is held to JAX above, through its
    fields and its march), so that the rest compares exactly."""
    gray = scene(0)

    def port_segments(g, max_lines):
        segs = tlines.detect_line_segments(_t(g), max_lines=max_lines)
        return jlines.LineSegments(*(jnp.asarray(_n(a)) for a in segs))

    monkeypatch.setattr(jlines, "detect_line_segments", port_segments)
    monkeypatch.setattr(jsift, "extract_sift", jax.jit(
        jsift.extract_sift, static_argnames=("max_keypoints", "threshold")))
    want = jreg.get_model("extractor_wireframe", point_conf={"max_keypoints": 64},
                          max_lines=8)(jnp.asarray(gray))
    got = treg.get_model("extractor_wireframe", point_conf={"max_keypoints": 64}, max_lines=8,
                         device="cpu")(gray)
    assert set(got) == set(want)
    for k in ("keypoints", "valid", "line_valid"):
        np.testing.assert_array_equal(_n(got[k]), np.asarray(want[k]), err_msg=k)
    lv = np.asarray(want["line_valid"])
    assert lv.sum() >= 2
    _close(_n(got["lines"])[lv], np.asarray(want["lines"])[lv], SEG_TOL, "lines")
    _close(_n(got["line_descriptors"])[lv], np.asarray(want["line_descriptors"])[lv], FIELD_TOL,
           "line_descriptors")
    for k in ("scores", "descriptors", "line_scores"):
        _close(got[k], want[k], FIELD_TOL, k)
