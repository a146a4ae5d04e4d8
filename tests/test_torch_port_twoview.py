"""The port's two-view estimators, alignment, minimal solvers, PnP and
robust-estimator registry against ``comet_tpu.twoview``, on the same numpy
inputs from a seed, in f32.

Every RANSAC of the port draws its samples through
``estimators.ransac_samples``; the tests replace it with the indices that
the JAX function draws from its key (``jax.random.split`` and ``choice``,
as the JAX function calls them), so hypotheses, scores and inlier masks are
compared exactly.

Tolerances (f32):

- ``CLOSED``: closed forms, 1e-5 of the largest |value|;
- ``TRANSFER``: the homography transfer error, a squared difference of
  pixel coordinates near 640 (one f32 step 6e-5), 1e-4 of its largest value;
- inlier masks and scores: identical once the samples are identical;
- ``MODEL``: F, E and H within 1e-4 after scaling to unit norm with the
  sign of their largest entry (an SVD null vector is fixed only up to sign
  and scale);
- ``POSE``: rotations and translations of EPnP, PnP and relative poses
  within 1e-4 (compared as poses, not as intermediates);
- ``err``/``reproj_rms`` of EPnP and PnP: 1e-3 relative (an RMS of
  residuals at the noise floor, each rounded at the scale of its
  coordinates);
- the 5-point solver's real solutions as sets: a JAX candidate whose
  constraints vanish (``REAL``) has a port candidate within ``MODEL`` up
  to sign (the 4-D null space's basis, and so the padded stack's order, is
  not unique).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comet_tpu.twoview as jtv
import comet_tpu.utils.dense_depth as jdd
from comet_tpu.geometry import quaternions as jq
from comet_tpu.twoview import align as jalign
from comet_tpu.twoview import estimators as jest
from comet_tpu.twoview import pnp as jpnp
from comet_tpu.twoview import solvers as jsol
import comet_tpu_torch.twoview as ttv
import comet_tpu_torch.utils.dense_depth as tdd
from comet_tpu_torch.twoview import align as talign
from comet_tpu_torch.twoview import estimators as test_
from comet_tpu_torch.twoview import pnp as tpnp
from comet_tpu_torch.twoview import robust_estimators as trob
from comet_tpu_torch.twoview import solvers as tsol

CLOSED = 1e-5
MODEL = 1e-4
POSE = 1e-4
REAL = 1e-4
TRANSFER = 1e-4

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _n(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rel=CLOSED):
    got, want = _n(got).astype(np.float64), _n(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"max |got - want| {err:.3e} > {rel:g} x {scale:.3e}"


def _unit(m):
    """m scaled to unit norm, signed so that its largest entry is positive."""
    m = _n(m).astype(np.float64).reshape(-1)
    m = m / np.linalg.norm(m)
    return m * np.sign(m[np.argmax(np.abs(m))])


def _same_model(got, want, rel=MODEL):
    _close(_unit(got), _unit(want), rel)


def _two_view(seed, n=48, noise=0.0, outliers=0):
    """Points seen by two cameras, column convention x_cam = R x + t."""
    rng = np.random.default_rng(seed)
    pts3d = rng.random((n, 3)) * np.array([4, 4, 2]) + np.array([-2, -2, 6])
    ang = np.deg2rad([5.0, -8.0, 3.0])
    cx, cy, cz = np.cos(ang)
    sx, sy, sz = np.sin(ang)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    r_rel = rz @ ry @ rx
    t_rel = np.array([0.5, 0.1, 0.05])

    def project(pts, r, t):
        pix = (pts @ r.T + t) @ K.T
        return pix[:, :2] / pix[:, 2:]

    x1 = project(pts3d, np.eye(3), np.zeros(3))
    x2 = project(pts3d, r_rel, t_rel)
    if noise:
        x1 = x1 + rng.normal(0, noise, x1.shape)
        x2 = x2 + rng.normal(0, noise, x2.shape)
    if outliers:
        idx = rng.choice(n, outliers, replace=False)
        x2[idx] += rng.random((outliers, 2)) * 100 + 30
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(pts3d), f32(x1), f32(x2), f32(r_rel), f32(t_rel)


def _jax_samples(key, n, h, k):
    """The indices [H, k] that the JAX RANSACs draw from ``key``."""
    keys = jax.random.split(key, h)
    return np.asarray(jax.vmap(lambda kk: jax.random.choice(kk, n, (k,), replace=False))(keys))


def _feed(monkeypatch, *draws):
    """Make the port's ``ransac_samples`` return ``draws`` in turn."""
    queue = list(draws)

    def fake(n, num_hypotheses, sample_size, generator, device, p=None):
        idx = torch.as_tensor(queue.pop(0), dtype=torch.int64, device=device)
        assert idx.shape[-2:] == (num_hypotheses, sample_size)
        return idx

    monkeypatch.setattr(test_, "ransac_samples", fake)
    return queue


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")}


def test_exports():
    jax_names = {n for n in _public(jtv)
                 if not isinstance(getattr(jtv, n), type(jtv))}  # not its submodules
    assert jax_names - _public(ttv) == set()
    assert set(jdd.__all__) == set(tdd.__all__)
    assert all(callable(getattr(tdd, n)) for n in jdd.__all__)


# closed forms (each test's JAX side is one jitted function: JAX run op by
# op compiles every operation on first use, several times slower)


def _normalized(x):
    kinv = np.linalg.inv(K)
    return (np.concatenate([x, np.ones((len(x), 1), np.float32)], 1) @ kinv.T)[:, :2].astype(
        np.float32)


def test_normalize_sampson_and_8point():
    _, x1, x2, _, _ = _two_view(0, noise=0.5)
    w = np.random.default_rng(1).random(48).astype(np.float32)

    @jax.jit
    def ref(x1, x2, w):
        f = jtv.run_8point(x1, x2)
        return (jtv.normalize_points(x1), f, jtv.sampson_distance(f, x1, x2),
                jtv.run_8point(x1, x2, w), jtv.run_8point(x1[8:16], x2[8:16]))

    norm, f, sampson, fw, f_sub = ref(x1, x2, w)
    for got, want in zip(ttv.normalize_points(_t(x1)), norm):
        _close(got, want)
    _close(ttv.sampson_distance(_t(np.asarray(f)), _t(x1), _t(x2)), sampson)
    _same_model(ttv.run_8point(_t(x1), _t(x2)), f)
    _same_model(ttv.run_8point(_t(x1), _t(x2), _t(w)), fw)
    # the batched form equals the problems one by one
    batch = ttv.run_8point(_t(np.stack([x1[:8], x1[8:16]])), _t(np.stack([x2[:8], x2[8:16]])))
    _same_model(batch[1], f_sub)


def test_homography_dlt_and_transfer_error():
    rng = np.random.default_rng(2)
    x1 = rng.uniform(0, 640, (30, 2)).astype(np.float32)
    h_true = np.array([[1.1, 0.05, 12.0], [-0.03, 0.95, -7.0], [1e-4, -2e-4, 1.0]], np.float32)
    xh = np.concatenate([x1, np.ones((30, 1), np.float32)], 1) @ h_true.T
    x2 = (xh[:, :2] / xh[:, 2:] + rng.normal(0, 0.3, (30, 2))).astype(np.float32)
    w = rng.random(30).astype(np.float32)

    @jax.jit
    def ref(x1, x2, w):
        h = jtv.run_homography_dlt(x1, x2)
        return h, jtv.run_homography_dlt(x1, x2, w), jtv.homography_transfer_error(h, x1, x2)

    h, hw, err = ref(x1, x2, w)
    _same_model(ttv.run_homography_dlt(_t(x1), _t(x2)), h)
    _same_model(ttv.run_homography_dlt(_t(x1), _t(x2), _t(w)), hw)
    # the error is a difference of pixel coordinates near 640, where one f32
    # step is 6e-5: summed in another order, it moves by 2 |d| 6e-5
    _close(ttv.homography_transfer_error(_t(np.asarray(h)), _t(x1), _t(x2)), err, TRANSFER)


def test_essential_decomposition_and_motion():
    pts3d, x1, x2, r_rel, t_rel = _two_view(3, noise=0.2)
    n1, n2 = _normalized(x1), _normalized(x2)
    p1 = np.eye(3, 4, dtype=np.float32)
    p2 = np.concatenate([r_rel, t_rel[:, None]], 1)

    @jax.jit
    def ref(x1, x2, n1, n2, k, p1, p2):
        f = jtv.run_8point(x1, x2)
        e = jtv.essential_from_fundamental(f, k, k)
        rs, ts = jtv.decompose_essential(e)
        counts = jax.vmap(lambda r, t: jtv.cheirality_count(r, t, n1, n2))(rs, ts)
        return (f, e, rs, ts, counts, jtv.motion_from_essential(e, n1, n2),
                jtv.triangulate_point(p1, p2, n1[0], n2[0]), jtv.triangulate_points(p1, p2, n1, n2))

    f, e, jrs, jts, counts, (jr, jt), one, many = ref(x1, x2, n1, n2, K, p1, p2)
    _close(ttv.essential_from_fundamental(_t(np.asarray(f)), _t(K), _t(K)), e)
    e = _t(np.asarray(e))
    # the 4 candidates as a set: each of JAX's has one of the port's within
    # CLOSED (the SVD's signs may order them otherwise)
    rs, ts = ttv.decompose_essential(e)
    got = np.concatenate([_n(rs).reshape(4, 9), _n(ts)], 1)
    want = np.concatenate([np.asarray(jrs).reshape(4, 9), np.asarray(jts)], 1)
    assert max(np.abs(got - w).max(-1).min() for w in want) <= CLOSED
    r, t = ttv.motion_from_essential(e, _t(n1), _t(n2))
    _close(r, jr, POSE)
    _close(t, jt, POSE)
    _close(r, r_rel, 1e-2)
    _close(ttv.triangulate_point(_t(p1), _t(p2), _t(n1[0]), _t(n2[0])), one)
    _close(ttv.triangulate_points(_t(p1), _t(p2), _t(n1), _t(n2)), many)
    np.testing.assert_array_equal(
        _n(ttv.cheirality_count(_t(np.asarray(jrs)), _t(np.asarray(jts)), _t(n1)[None],
                                _t(n2)[None])), np.asarray(counts))


def test_7point_real_solutions_as_sets():
    _, x1, x2, _, _ = _two_view(4)
    got = _n(ttv.run_7point(_t(x1[:7]), _t(x2[:7])))
    want = np.asarray(jax.jit(jtv.run_7point)(x1[:7], x2[:7]))
    x1h = np.concatenate([x1[:7], np.ones((7, 1))], 1)
    x2h = np.concatenate([x2[:7], np.ones((7, 1))], 1)

    def solves(f):  # a real solution: the epipolar residuals and det vanish
        f = f / np.linalg.norm(f)
        return (np.abs(np.einsum("ni,ij,nj->n", x2h, f, x1h)).max() < 1e-3
                and abs(np.linalg.det(f)) < 1e-4)

    real = [f for f in want if solves(f)]
    assert real
    for f in real:
        assert min(np.abs(_unit(g) - _unit(f)).max() for g in got) < MODEL


# RANSAC on JAX's samples


@pytest.mark.parametrize("kind", ["fundamental", "homography"])
def test_ransac_on_jax_samples(monkeypatch, kind):
    _, x1, x2, _, _ = _two_view(5, noise=0.3, outliers=10)
    key = jax.random.PRNGKey(3)
    if kind == "fundamental":
        want = jax.jit(jtv.estimate_fundamental_ransac, static_argnums=(3, 4))(x1, x2, key, 1.0, 32)
        _feed(monkeypatch, _jax_samples(key, 48, 32, 8))
        got = ttv.estimate_fundamental_ransac(_t(x1), _t(x2), None, 1.0, 32)
    else:
        want = jax.jit(jtv.estimate_homography_ransac, static_argnums=(3, 4))(x1, x2, key, 9.0, 32)
        _feed(monkeypatch, _jax_samples(key, 48, 32, 4))
        got = ttv.estimate_homography_ransac(_t(x1), _t(x2), None, 9.0, 32)
    assert int(got.score) == int(want.score)
    np.testing.assert_array_equal(_n(got.inliers), np.asarray(want.inliers))
    _same_model(got.model, want.model)


def test_essential_ransac_on_jax_samples(monkeypatch):
    _, x1, x2, r_rel, t_rel = _two_view(6, noise=0.3, outliers=8)
    key = jax.random.PRNGKey(4)
    want, jr, jt = jax.jit(jtv.estimate_essential_ransac, static_argnums=(5, 6))(
        x1, x2, K, K, key, 1e-5, 32)
    _feed(monkeypatch, _jax_samples(key, 48, 32, 8))
    got, r, t = ttv.estimate_essential_ransac(_t(x1), _t(x2), _t(K), _t(K), None, 1e-5, 32)
    assert int(got.score) == int(want.score)
    np.testing.assert_array_equal(_n(got.inliers), np.asarray(want.inliers))
    _same_model(got.model, want.model)
    _close(r, jr, POSE)
    _close(t, jt, POSE)


def test_tied_scores_keep_the_first_hypothesis(monkeypatch):
    """Noise-free correspondences: every hypothesis explains every point, so
    all 16 scores tie and both keep hypothesis 0 (jnp.argmax's first)."""
    _, x1, x2, _, _ = _two_view(7)
    key = jax.random.PRNGKey(5)
    idx = _jax_samples(key, 48, 16, 8)
    _feed(monkeypatch, idx)
    res = test_._ransac(ttv.run_8point, ttv.sampson_distance, 8, _t(x1), _t(x2),
                        torch.Generator(), 1e-2, 16)
    want = jax.jit(lambda a, b, k: jest._ransac(jtv.run_8point, jtv.sampson_distance, 8, a, b, k,
                                                1e-2, 16))(x1, x2, key)
    assert int(res.score) == int(want.score) == 48
    _close(res.model, ttv.run_8point(_t(x1[idx[0]]), _t(x2[idx[0]])))
    _same_model(res.model, want.model)
    tied = torch.tensor([3, 7, 2, 7, 7, 1])
    assert int(tied.argmax()) == int(jnp.argmax(jnp.asarray(tied.numpy()))) == 1
    assert int(test_.take(torch.arange(6.0) * 10, tied.argmax())) == 10


@pytest.fixture(scope="module")
def five_point():
    """Three minimal samples of a noise-free scene and a degenerate one (one
    point repeated), through JAX's run_5point in one jitted call: the
    candidates, and their Sampson distances to every point."""
    _, x1, x2, _, _ = _two_view(9)
    n1, n2 = _normalized(x1), _normalized(x2)
    samples = np.concatenate([np.arange(15).reshape(3, 5), np.zeros((1, 5), np.int64)])
    cand, sampson = jax.jit(lambda a, b, c, d: (lambda e: (e, jax.vmap(jax.vmap(
        lambda m: jtv.sampson_distance(m, c, d)))(e)))(jax.vmap(jtv.run_5point)(a, b)))(
        n1[samples], n2[samples], n1, n2)
    return dict(x1=x1, x2=x2, n1=n1, n2=n2, samples=samples, cand=np.asarray(cand),
                sampson=np.asarray(sampson))


def test_singular_hypothesis_scores_out(monkeypatch, five_point):
    """A minimal sample of one point repeated makes the 5-point action
    matrix's system singular: where JAX's solve returns non-finite values and
    carries on, the port's does too (a checked solve would raise), no
    candidate of that sample explains more points than a minimal sample
    holds, and the RANSAC still finds the scene."""
    fp = five_point
    degenerate = fp["samples"][3]
    cand = ttv.run_5point(_t(fp["n1"][degenerate]), _t(fp["n2"][degenerate]))
    got = (ttv.sampson_distance(cand, _t(fp["n1"]), _t(fp["n2"])) < 1e-5).sum(-1)
    assert int(got.max()) <= 5 and int((fp["sampson"][3] < 1e-5).sum(-1).max()) <= 5
    with pytest.raises(RuntimeError):  # what the checked solve would do
        torch.linalg.solve(torch.zeros(10, 10), torch.ones(10, 10))
    idx = np.array(_jax_samples(jax.random.PRNGKey(6), 48, 8, 5))
    idx[0] = degenerate
    _feed(monkeypatch, idx)
    res, r, t = ttv.estimate_essential_5point_ransac(_t(fp["x1"]), _t(fp["x2"]), _t(K), _t(K),
                                                     None, 1e-5, 8)
    assert int(res.score) == 48


# the 5-point solver, EPnP, homography decomposition


def _constraint_residual(e, n1, n2):
    e = e / np.linalg.norm(e)
    x1h = np.concatenate([n1, np.ones((len(n1), 1))], 1)
    x2h = np.concatenate([n2, np.ones((len(n2), 1))], 1)
    epi = np.abs(np.einsum("ni,ij,nj->n", x2h, e, x1h)).max()
    ess = np.abs(2 * e @ e.T @ e - np.trace(e @ e.T) * e).max()
    return max(epi, ess, abs(np.linalg.det(e)))


def test_5point_real_solutions_as_sets(five_point):
    fp = five_point
    samples = fp["samples"][:3]
    got = _n(ttv.run_5point(_t(fp["n1"][samples]), _t(fp["n2"][samples])))
    for g, w, s in zip(got, fp["cand"][:3], samples):
        real = [e for e in w if _constraint_residual(e, fp["n1"][s], fp["n2"][s]) < REAL]
        assert real
        for e in real:
            assert min(np.abs(_unit(c) - _unit(e)).max() for c in g) < MODEL


def test_5point_ransac_on_jax_samples(monkeypatch):
    _, x1, x2, r_rel, t_rel = _two_view(10, outliers=8)
    key = jax.random.PRNGKey(7)
    want, jr, jt = jax.jit(jtv.estimate_essential_5point_ransac, static_argnums=(5, 6))(
        x1, x2, K, K, key, 1e-5, 16)
    _feed(monkeypatch, _jax_samples(key, 48, 16, 5))
    got, r, t = ttv.estimate_essential_5point_ransac(_t(x1), _t(x2), _t(K), _t(K), None, 1e-5, 16)
    assert int(got.score) == int(want.score)
    np.testing.assert_array_equal(_n(got.inliers), np.asarray(want.inliers))
    _same_model(got.model, want.model)
    _close(r, jr, POSE)
    _close(t, jt, POSE)


def test_efficient_pnp_and_homography_decomposition():
    pts3d, x1, x2, r_rel, t_rel = _two_view(11, noise=0.2)
    n2 = _normalized(x2)
    w = np.random.default_rng(3).uniform(0.5, 1.0, 48).astype(np.float32)
    # a plane seen by the two cameras
    plane = pts3d.copy()
    plane[:, 2] = 7.0
    pix1 = plane @ K.T
    pix2 = (plane @ r_rel.T + t_rel) @ K.T
    p1 = (pix1[:, :2] / pix1[:, 2:]).astype(np.float32)
    p2 = (pix2[:, :2] / pix2[:, 2:]).astype(np.float32)
    q1, q2 = _normalized(p1), _normalized(p2)

    @jax.jit
    def ref(pts3d, n2, w, p1, p2, q1, q2, k):
        h = jtv.run_homography_dlt(p1, p2)
        rs, ts, ns = jtv.decompose_homography(h, k, k)
        return (jtv.efficient_pnp(pts3d, n2), jtv.efficient_pnp(pts3d, n2, w), h,
                jtv.select_homography_motion(rs, ts, ns, q1, q2))

    plain, weighted, h, motion = ref(pts3d, n2, w, p1, p2, q1, q2, K)
    for weights, want in ((None, plain), (_t(w), weighted)):
        got = ttv.efficient_pnp(_t(pts3d), _t(n2), weights)
        _close(got.r, want.r, POSE)
        _close(got.t, want.t, POSE)
        _close(got.err, want.err, 1e-3)
    # EPnP's rank-deficient beta systems: the least-norm solution of JAX's
    # lstsq (a duplicated column)
    a = np.random.default_rng(4).normal(size=(6, 2)).astype(np.float32)[:, [0, 1, 0]]
    b = np.random.default_rng(5).normal(size=6).astype(np.float32)
    _close(tsol._lstsq(_t(a), _t(b[:, None]))[:, 0], jnp.linalg.lstsq(a, b)[0], 1e-4)
    rs, ts, ns = ttv.decompose_homography(_t(np.asarray(h)), _t(K), _t(K))
    got = ttv.select_homography_motion(rs, ts, ns, _t(q1), _t(q2))
    for g, w_ in zip(got, motion):
        _close(g, w_, POSE)
    _close(got[0], r_rel, 1e-3)


def test_pnp_lm_batched_and_focal_sweep():
    pts3d, _, x2, r_rel, t_rel = _two_view(12, noise=0.3)
    w = np.random.default_rng(6).uniform(0.2, 1.0, 48).astype(np.float32)
    p3 = np.stack([pts3d, pts3d[::-1] * 1.01])
    p2 = np.stack([x2, x2[::-1]])
    focals = np.array([350.0, 450.0, 500.0, 600.0], np.float32)
    pp = np.array([320.0, 240.0], np.float32)

    @jax.jit
    def ref(pts3d, x2, k, w, p3, p2, pp, focals):
        return (jtv.solve_pnp(pts3d, x2, k), jtv.solve_pnp(pts3d, x2, k, w),
                jtv.solve_pnp_batched(p3, p2, k), jtv.solve_pnp_focal_sweep(pts3d, x2, pp, focals),
                jpnp._dlt_pose(pts3d, x2 / 500.0))

    plain, weighted, batched, (sweep, jf), (jr0, jt0) = ref(pts3d, x2, K, w, p3, p2, pp, focals)
    for weights, want in ((None, plain), (_t(w), weighted)):
        got = ttv.solve_pnp(_t(pts3d), _t(x2), _t(K), weights)
        _close(got.r, want.r, POSE)
        _close(got.t, want.t, POSE)
        _close(got.reproj_rms, want.reproj_rms, 1e-3)
        _close(got.r, r_rel, 5e-3)  # against the truth, under 0.3 px of noise
    got = ttv.solve_pnp_batched(_t(p3), _t(p2), _t(K))
    _close(got.r, batched.r, POSE)
    _close(got.t, batched.t, POSE)
    got, f = ttv.solve_pnp_focal_sweep(_t(pts3d), _t(x2), _t(pp), _t(focals))
    assert float(f) == float(jf) == 500.0
    _close(got.r, sweep.r, POSE)
    _close(got.t, sweep.t, POSE)
    r0, t0 = tpnp._dlt_pose(_t(pts3d), _t(x2 / 500.0), None)
    _close(r0, jr0, POSE)
    _close(t0, jt0, POSE)


# alignment and orderings


def test_alignment_and_rotation_averaging():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(20, 3)).astype(np.float32)
    q = rng.normal(size=(6, 4)).astype(np.float32)
    r = np.asarray(jq.quat_to_matrix(jnp.asarray(q)))
    y = (1.7 * x @ r[0] + np.array([0.3, -1.0, 2.0])).astype(np.float32)
    t_src = rng.normal(size=(6, 3)).astype(np.float32)
    r_tgt = r @ r[1]
    t_tgt = (t_src * 2 + 1).astype(np.float32)
    near = (q[:1] + rng.normal(size=(5, 4)) * 0.05).astype(np.float32)
    batch = np.stack([r, r @ r[2], np.swapaxes(r, -1, -2)]).astype(np.float32)

    @jax.jit
    def ref(x, y, q, r, t_src, r_tgt, t_tgt, near, batch):
        return (jtv.corresponding_points_alignment(x, y, True),
                jtv.corresponding_points_alignment(x, y, False),
                jtv.align_camera_extrinsics(r, t_src, r_tgt, t_tgt), jtv.rotation_average(near),
                jtv.relative_to_first(q, t_src), jtv.average_batch_rotations(batch))

    scaled, rigid, aligned, avg, rel, batch_avg = ref(x, y, q, r, t_src, r_tgt, t_tgt, near, batch)
    for est, want in ((True, scaled), (False, rigid)):
        for g, w in zip(ttv.corresponding_points_alignment(_t(x), _t(y), est), want):
            _close(g, w)
    got = ttv.align_camera_extrinsics(_t(r), _t(t_src), _t(r_tgt), _t(t_tgt))
    for g, w in zip(got[0], aligned[0]):
        _close(g, w, 1e-4)
    _close(got[1], aligned[1], 1e-4)
    _close(got[2], aligned[2], 1e-4)
    _close(ttv.rotation_average(_t(near)), avg)
    for g, w in zip(ttv.relative_to_first(_t(q), _t(t_src)), rel):
        _close(g, w)
    _close(ttv.average_batch_rotations(_t(batch)), batch_avg)


def test_average_query_predictions():
    rng = np.random.default_rng(14)
    s = 6
    q = rng.normal(size=(s, 4)).astype(np.float32)
    r = np.asarray(jq.quat_to_matrix(jnp.asarray(q)))
    t = rng.normal(size=(s, 3)).astype(np.float32)
    focal = rng.uniform(1, 2, (s, 2)).astype(np.float32)

    def predict(order, lib, asarray):
        # a predictor relative to the frame placed first
        o = np.asarray(order)
        rr, tt = r[o], t[o]
        r_rel = np.einsum("nij,kj->nik", rr, rr[0])
        t_rel = tt - np.einsum("nij,j->ni", r_rel, tt[0])
        return asarray(r_rel.astype(np.float32)), asarray(t_rel.astype(np.float32)), asarray(
            focal[o])

    got = ttv.average_query_predictions(lambda o: predict(o, torch, _t), s,
                                        rng=np.random.default_rng(1), device="cpu")
    want = jtv.average_query_predictions(lambda o: predict(o, jnp, jnp.asarray), s,
                                         rng=np.random.default_rng(1))
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, 1e-4)
    np.testing.assert_array_equal(_n(ttv.calculate_index_mappings(3, 5, device="cpu")),
                                  np.asarray(jtv.calculate_index_mappings(3, 5)))
    a = rng.normal(size=(2, 5, 3)).astype(np.float32)
    order = np.asarray(jtv.calculate_index_mappings(2, 5))
    got = ttv.switch_tensor_order([_t(a), None], torch.as_tensor(order))
    want = jtv.switch_tensor_order([jnp.asarray(a), None], jnp.asarray(order))
    _close(got[0], want[0])
    assert got[1] is None and want[1] is None


def test_orderings_and_sampling():
    rng = np.random.default_rng(15)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    np.testing.assert_array_equal(_n(ttv.farthest_point_sample(_t(pts), 9)),
                                  np.asarray(jtv.farthest_point_sample(jnp.asarray(pts), 9)))
    feats = rng.normal(size=(7, 5, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        _n(ttv.rank_by_feature_similarity(_t(feats), 5)),
        np.asarray(jtv.rank_by_feature_similarity(jnp.asarray(feats), 5)))
    for n in range(1, 12):
        assert ttv.generate_rank_by_midpoint(n) == jtv.generate_rank_by_midpoint(n)
        for k in range(1, 4):
            assert ttv.generate_rank_by_interval(n, k) == jtv.generate_rank_by_interval(n, k)
        for idx in range(-2, n + 2):
            for length in range(1, n + 3):
                assert talign.sample_subrange(n, idx, length) == jalign.sample_subrange(
                    n, idx, length)


def test_ransac_samples_draws():
    g = torch.Generator().manual_seed(0)
    idx = test_.ransac_samples(20, 50, 8, g, torch.device("cpu"))
    assert idx.shape == (50, 8)
    assert all(len(set(row.tolist())) == 8 for row in idx)
    again = test_.ransac_samples(20, 50, 8, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert torch.equal(idx, again)
    valid = torch.zeros(3, 20)
    valid[:, ::2] = 1.0
    p = valid / valid.sum(-1, keepdim=True)
    idx = test_.ransac_samples(20, 50, 8, g, torch.device("cpu"), p=p)
    assert idx.shape == (3, 50, 8)
    assert (idx % 2 == 0).all()
    assert all(len(set(row.tolist())) == 8 for row in idx.reshape(-1, 8))


# the robust-estimator registry


def _estimator_data():
    _, x1, x2, _, _ = _two_view(16, noise=0.3, outliers=8)
    return {"m_kpts0": x1.astype(np.float64), "m_kpts1": x2.astype(np.float64), "K0": K, "K1": K}


@pytest.mark.parametrize("kind,name,sample", [
    ("homography", "ransac", 4), ("homography", "dlt", None), ("relative_pose", "ransac", 8),
    ("relative_pose", "nister", 5), ("fundamental", "ransac", 8)])
def test_estimators_on_jax_samples(monkeypatch, kind, name, sample):
    # JAX's estimators look their RANSAC up at each call: the same functions
    # jitted (see the note on the closed forms)
    for module, fn in ((jest, "estimate_homography_ransac"), (jest, "estimate_essential_ransac"),
                       (jest, "estimate_fundamental_ransac"),
                       (jsol, "estimate_essential_5point_ransac")):
        monkeypatch.setattr(module, fn, jax.jit(getattr(module, fn),
                                                static_argnames=("threshold", "num_hypotheses")))
    data = _estimator_data()
    conf = {"seed": 3, "num_hypotheses": 16}
    want = jtv.get_estimator(kind, name, conf)(data)
    if sample is not None:
        _feed(monkeypatch, _jax_samples(jax.random.PRNGKey(3), 48, 16, sample))
    got = ttv.get_estimator(kind, name, conf, device="cpu")(data)
    assert got["success"] == want["success"]
    np.testing.assert_array_equal(_n(got["inliers"]), np.asarray(want["inliers"]))
    if kind == "relative_pose":
        for g, w in zip(got["M_0to1"], want["M_0to1"]):
            _close(g, w, POSE)
        _same_model(got["E"], want["E"])
    else:
        _same_model(got["M_0to1"], want["M_0to1"])
    assert got["inliers"].device.type == "cpu"


def test_estimator_registry_and_errors():
    assert ttv.list_estimators() == jtv.list_estimators()
    assert ttv.list_estimators("relative_pose") == jtv.list_estimators("relative_pose")
    for kind, name in jtv.list_estimators():
        jcls, tcls = jtv.load_estimator(kind, name), ttv.load_estimator(kind, name)
        assert tcls.__name__ == jcls.__name__
        assert {**tcls.base_default_conf, **tcls.default_conf} == {
            **jcls.base_default_conf, **jcls.default_conf}
        assert tcls.required_data_keys == jcls.required_data_keys
    for call in (lambda m: m.load_estimator("homography", "opencv"),
                 lambda m: m.get_estimator("fundamental", "ransac", {"thresh": 1.0}),
                 lambda m: m.get_estimator("relative_pose", "ransac")({"m_kpts0": 1})):
        with pytest.raises(KeyError) as jerr:
            call(jtv)
        with pytest.raises(KeyError) as terr:
            call(ttv)
        assert str(terr.value) == str(jerr.value)

    @ttv.register_estimator("homography", "test-only")
    class Echo(ttv.BaseEstimator):
        required_data_keys = ("x",)

        def _forward(self, data):
            return data

    try:
        assert ttv.get_estimator("homography", "test-only")({"x": 1}) == {"x": 1}
        with pytest.raises(KeyError, match="Echo requires"):
            ttv.get_estimator("homography", "test-only")({})
    finally:
        trob._ESTIMATORS.pop(("homography", "test-only"))
    assert ttv.list_estimators() == jtv.list_estimators()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the default without a card")
def test_numpy_inputs_go_to_the_card():
    """Inputs built from nothing or from numpy go to the card by default:
    without one, the call raises instead of running on the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttv.default_kmat(64, 48)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttv.get_estimator("fundamental", "ransac")(_estimator_data())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttv.calculate_index_mappings(1, 4)
    # tensors run where they live
    data = {k: _t(v) for k, v in _estimator_data().items()}
    assert ttv.get_estimator("fundamental", "ransac")(data)["inliers"].device.type == "cpu"
