"""The port's scene geometry against ``comet_tpu``: triangulation, the
dense LM bundle adjustment and RANSAC triangulation, preliminary cameras,
``scene_ba`` stage by stage and ``reconstruct_scene`` end to end, its
COLMAP export through the port's ``colmap_io``, and ``dense_depth``.

The scene: S 5 cameras on an arc around N 40 points, 0.3 px of noise, 15 %
of the tracks (6) replaced by uniform pixels outright (as
tests/test_scene_ba_staged.py does), poses perturbed by 0.02 in rotation
and 0.05 in translation. The same f32 numpy inputs go through both
packages; the preliminary RANSAC is fed the sample indices that JAX draws
from its keys. JAX's side runs jitted (op by op it compiles every
operation on first use, several times slower).

Tolerances (f32):

- ``CLOSED``: closed forms, 1e-5 of the largest |value|;
- ``ROT`` and ``EXTENT``: BA and ``reconstruct_scene`` poses within 1e-3
  rad, translations and points within 1e-3 of the scene's extent;
- reprojection RMS: 1e-3 relative (residuals at the noise floor, each
  rounded at the scale of its pixel coordinates);
- ``MASKS``: masks equal at >= 99 % of their entries (a point within
  rounding of a threshold may fall either side);
- the preliminary fundamental matrices within 1e-4 after unit-norm and sign
  normalization, and their inlier masks identical;
- ``dense_depth`` is host numpy in both packages: equal bit for bit.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comet_tpu.twoview as jtv
import comet_tpu.utils.dense_depth as jdd
from comet_tpu.twoview import triangulation as jtri
from comet_tpu.utils import colmap_io as jcolmap
import comet_tpu_torch.twoview as ttv
import comet_tpu_torch.utils.dense_depth as tdd
from comet_tpu_torch.twoview import estimators as test_
from comet_tpu_torch.twoview import triangulation as ttri
from comet_tpu_torch.utils import colmap_io as tcolmap

CLOSED = 1e-5
ROT = 1e-3
EXTENT = 1e-3
MASKS = 0.99
MODEL = 1e-4
S, N, N_OUT = 5, 40, 6
FOCAL, IMG = 320.0, 256.0


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _n(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rel=CLOSED, scale=None):
    got, want = _n(got).astype(np.float64), _n(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = scale if scale is not None else max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"max |got - want| {err:.3e} > {rel:g} x {scale:.3e}"


def _rot_close(q_got, q_want, tol=ROT):
    a = _n(q_got).astype(np.float64)
    b = _n(q_want).astype(np.float64)
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    ang = 2 * np.arccos(np.clip(np.abs((a * b).sum(-1)), 0.0, 1.0))
    assert ang.max() <= tol, f"rotations differ by up to {ang.max():.3e} rad"


def _masks_agree(got, want, share=MASKS):
    got, want = _n(got).astype(bool), _n(want).astype(bool)
    assert got.shape == want.shape
    agree = (got == want).mean()
    assert agree >= share, f"masks agree at {agree:.4f} of entries"


def _quat(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def _qmat(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def make_scene(seed=7, s=S, n=N, n_out=N_OUT, noise=0.3, f=FOCAL, img=IMG):
    """Cameras on an arc looking at a cloud near the origin (row convention
    x_cam = x @ R + T), tracks with noise, n_out tracks corrupted outright,
    and the poses perturbed (camera 0 kept)."""
    rng = np.random.default_rng(seed)
    k = np.array([[f, 0, img / 2], [0, f, img / 2], [0, 0, 1]])
    pts = rng.uniform(-1.0, 1.0, size=(n, 3))
    pts[:, 2] *= 0.5
    qs, ts = [], []
    for i in range(s):
        ang = (i - s / 2) * 0.08
        q = _quat([0, 1, 0], ang)
        c = np.array([np.sin(ang) * 4.0, 0.1 * i / s, -np.cos(ang) * 4.0])
        qs.append(q)
        ts.append(-c @ _qmat(q))
    q, t = np.stack(qs), np.stack(ts)
    cam = np.einsum("nj,sji->sni", pts, np.stack([_qmat(x) for x in q])) + t[:, None]
    pix = cam @ k.T
    tracks = pix[..., :2] / pix[..., 2:] + rng.normal(size=(s, n, 2)) * noise
    tracks[:, :n_out] = rng.uniform(0, img, size=(s, n_out, 2))
    q0 = q + rng.normal(size=q.shape) * 0.02
    q0 /= np.linalg.norm(q0, axis=-1, keepdims=True)
    t0 = t + rng.normal(size=t.shape) * 0.05
    q0[0], t0[0] = q[0], t[0]
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(q=f32(q), t=f32(t), q0=f32(q0), t0=f32(t0), k=f32(k), pts=f32(pts),
                tracks=f32(tracks), vis=np.ones((s, n), np.float32))


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _extent(sc):
    return float(np.abs(sc["pts"]).max() + np.abs(sc["t"]).max())


# triangulation and bundle adjustment


def test_triangulation_and_ransac_triangulation(scene):
    q, t, k, tracks, vis = (scene[x] for x in ("q0", "t0", "k", "tracks", "vis"))
    vis = vis.copy()
    vis[1, ::7] = 0.0

    @jax.jit
    def ref(q, t, k, tracks, vis):
        proj = jtv.projection_matrices(q, t, k)
        pts = jtv.triangulate_tracks(proj, tracks, vis)
        state = jtv.BAState(q=q, t=t, points=pts)
        return (proj, pts, jtv.triangulate_multiview(proj, tracks[:, 3], vis[:, 3]),
                jtv.project_points(pts, q, t, k),
                jtri.reprojection_residuals(state, tracks, vis, k),
                jtv.triangulate_tracks_ransac(proj, tracks, vis, 2.0))

    proj, pts, one, pix, res, (rpts, rinl) = ref(q, t, k, tracks, vis)
    tq, tt, tk, ttr, tvis = (_t(x) for x in (q, t, k, tracks, vis))
    tproj = ttv.projection_matrices(tq, tt, tk)
    _close(tproj, proj)
    tpts = ttv.triangulate_tracks(tproj, ttr, tvis)
    _close(tpts, pts, EXTENT, _extent(scene))
    _close(ttv.triangulate_multiview(tproj, ttr[:, 3], tvis[:, 3]), one, EXTENT, _extent(scene))
    _close(ttv.project_points(_t(np.asarray(pts)), tq, tt, tk), pix, CLOSED, IMG)
    state = ttv.BAState(q=tq, t=tt, points=_t(np.asarray(pts)))
    _close(ttri.reprojection_residuals(state, ttr, tvis, tk), res, CLOSED, IMG)
    gpts, ginl = ttv.triangulate_tracks_ransac(tproj, ttr, tvis, 2.0)
    _masks_agree(ginl, rinl)
    agree = np.asarray(rinl).all(0) == _n(ginl).all(0)
    _close(_n(gpts)[agree], np.asarray(rpts)[agree], EXTENT, _extent(scene))


@pytest.mark.parametrize("huber,fix_first", [(None, True), (4.0, True), (4.0, False)])
def test_bundle_adjust(scene, huber, fix_first):
    q0, t0, k, tracks, vis = (scene[x] for x in ("q0", "t0", "k", "tracks", "vis"))
    mask = vis.copy()
    mask[:, :N_OUT] = 0.0  # the corrupted tracks left out: a clean problem
    points0 = np.asarray(jtv.triangulate_tracks(jtv.projection_matrices(q0, t0, k), tracks, mask))
    ba = jax.jit(partial(jtv.bundle_adjust, iters=8, huber_delta=huber, fix_first_camera=fix_first))
    want, want_rms = ba(q0, t0, points0, tracks, mask, k)
    got, rms = ttv.bundle_adjust(_t(q0), _t(t0), _t(points0), _t(tracks), _t(mask), _t(k), iters=8,
                                 huber_delta=huber, fix_first_camera=fix_first)
    _rot_close(got.q, want.q)
    _close(got.t, want.t, EXTENT, _extent(scene))
    _close(got.points[N_OUT:], np.asarray(want.points)[N_OUT:], EXTENT, _extent(scene))
    _close(rms, want_rms, 1e-3)
    assert float(rms) < 0.5  # the noise is 0.3 px
    if fix_first:
        _close(got.q[0], q0[0], 0.0)
        _close(got.t[0], t0[0], 0.0)


def test_triangulate_and_refine_and_global_ba(scene):
    q0, t0, k, tracks, vis = (scene[x] for x in ("q0", "t0", "k", "tracks", "vis"))

    @jax.jit
    def ref(q0, t0, tracks, vis, k):
        return (jtv.triangulate_and_refine(q0, t0, tracks[:, N_OUT:], vis[:, N_OUT:], k, ba_iters=6),
                jtv.global_bundle_adjust(q0, t0, tracks, vis, k, rounds=2, ba_iters=6))

    (rs, rrms), (gs, gmask, grms) = ref(q0, t0, tracks, vis, k)
    args = [_t(x) for x in (q0, t0, tracks, vis, k)]
    state, rms = ttv.triangulate_and_refine(args[0], args[1], args[2][:, N_OUT:],
                                            args[3][:, N_OUT:], args[4], ba_iters=6)
    _rot_close(state.q, rs.q)
    _close(state.points, rs.points, EXTENT, _extent(scene))
    _close(rms, rrms, 1e-3)
    state, mask, rms = ttv.global_bundle_adjust(*args, rounds=2, ba_iters=6)
    _rot_close(state.q, gs.q)
    _close(state.t, gs.t, EXTENT, _extent(scene))
    _masks_agree(mask, gmask)
    keep = _n(mask).sum(0) >= 2
    _close(_n(state.points)[keep], np.asarray(gs.points)[keep], EXTENT, _extent(scene))


# preliminary cameras


def _jax_masked_samples(key, valid, h):
    """The indices [P, H, 8] that JAX's masked fundamental RANSAC draws: one
    key per pair, split into H, each a choice weighted by the valid points."""
    n = valid.shape[-1]

    def per_pair(v, k_):
        v = v.astype(jnp.float32)
        p = v / jnp.maximum(v.sum(), 1.0)
        return jax.vmap(lambda kk: jax.random.choice(kk, n, (8,), replace=False, p=p))(
            jax.random.split(k_, h))

    return np.asarray(jax.jit(jax.vmap(per_pair))(valid, jax.random.split(key, valid.shape[0])))


def test_preliminary_cameras(scene, monkeypatch):
    tracks = scene["tracks"][None, :, N_OUT:]
    vis = scene["vis"][None, :, N_OUT:].copy()
    vis[0, 2, :5] = 0.0  # invalid correspondences: neither sampled nor inliers
    score = np.ones_like(vis)
    score[0, 3, 5:8] = 0.2
    key = jax.random.PRNGKey(2)
    prelim = jax.jit(partial(jtv.estimate_preliminary_cameras, width=int(IMG), height=int(IMG),
                             max_error=0.5, num_hypotheses=32))
    want_cams, want = prelim(tracks, vis, tracks_score=score, key=key)
    valid = ((vis >= 0.05) & (score >= 0.5))[0, 1:]
    idx = _jax_masked_samples(key, valid, 32)
    assert not np.isin(np.arange(5), idx[1]).any()  # frame 2's invalid points never drawn

    def fake(n, num_hypotheses, sample_size, generator, device, p=None):
        assert p is not None and p.shape == valid.shape
        return torch.as_tensor(idx, dtype=torch.int64, device=device)

    monkeypatch.setattr(test_, "ransac_samples", fake)
    cams, got = ttv.estimate_preliminary_cameras(_t(tracks), _t(vis), int(IMG), int(IMG),
                                                 tracks_score=_t(score), num_hypotheses=32)
    np.testing.assert_array_equal(_n(got["fmat_inlier_mask"]), np.asarray(want["fmat_inlier_mask"]))
    for g, w in zip(_n(got["fmat"]).reshape(-1, 3, 3), np.asarray(want["fmat"]).reshape(-1, 3, 3)):
        g, w = g.reshape(-1) / np.linalg.norm(g), w.reshape(-1) / np.linalg.norm(w)
        _close(g * np.sign(g[np.argmax(np.abs(g))]), w * np.sign(w[np.argmax(np.abs(w))]), MODEL)
    _rot_close(cams["q"], want_cams["q"])
    _close(cams["t"], want_cams["t"], EXTENT, 1.0)  # unit translation directions
    _close(cams["q"][0, 0], [1.0, 0, 0, 0], 0.0, 1.0)
    _close(ttv.default_kmat(int(IMG), 200, device="cpu"), jtv.default_kmat(int(IMG), 200), 0.0)


# scene_ba stage by stage


def test_scene_stages(scene):
    q0, t0, k, tracks, vis = (scene[x] for x in ("q0", "t0", "k", "tracks", "vis"))
    pts = scene["pts"]

    @jax.jit
    def ref(q0, t0, k, tracks, vis, pts):
        centers = jtv.camera_centers(q0, t0)
        init = jtv.init_ba(q0, t0, k, tracks, vis, ba_iters=6)
        return (centers, jtv.triangulation_angles_deg(pts, centers),
                jtv.triangulate_by_pair(q0, t0, k, tracks, vis), init,
                jtv.refine_poses(q0, t0, k, pts, jnp.ones(N, bool), tracks, vis),
                jtv.filter_points3d(pts, tracks, q0, t0, k, max_reproj_error=3.0))

    centers, angles, (ppts, pinl, pang), init, (rq, rt), (fval, finl) = ref(q0, t0, k, tracks, vis,
                                                                            pts)
    a = [_t(x) for x in (q0, t0, k, tracks, vis)]
    tc = ttv.camera_centers(a[0], a[1])
    _close(tc, centers)
    _close(ttv.triangulation_angles_deg(_t(pts), tc), angles)
    gpts, ginl, gang = ttv.triangulate_by_pair(*a)
    _masks_agree(ginl, pinl)
    both = _n(ginl) & np.asarray(pinl)
    _close(_n(gpts)[both], np.asarray(ppts)[both], EXTENT, _extent(scene))
    # angles of the pair-triangulated points, which are held to EXTENT: the same 1e-3
    _close(_n(gang)[both], np.asarray(pang)[both], EXTENT)
    ginit = ttv.init_ba(*a, ba_iters=6)
    assert int(ginit.init_idx) == int(init.init_idx)
    _masks_agree(ginit.point_valid, init.point_valid)
    _rot_close(ginit.state.q, init.state.q)
    _close(ginit.state.t, init.state.t, EXTENT, _extent(scene))
    valid = _n(ginit.point_valid) & np.asarray(init.point_valid)
    _close(_n(ginit.points)[valid], np.asarray(init.points)[valid], EXTENT, _extent(scene))
    gq, gt = ttv.refine_poses(a[0], a[1], a[2], _t(pts), torch.ones(N, dtype=torch.bool), a[3], a[4])
    _rot_close(gq, rq)
    _close(gt, rt, EXTENT, _extent(scene))
    gval, ginl = ttv.filter_points3d(_t(pts), a[3], a[0], a[1], a[2], max_reproj_error=3.0)
    _masks_agree(gval, fval)
    _masks_agree(ginl, finl)


@pytest.fixture(scope="module")
def reconstructions(scene):
    args = [scene[x] for x in ("q0", "t0", "tracks", "vis", "k")]
    want = jax.jit(partial(jtv.reconstruct_scene, ba_iters=8, ba_rounds=2,
                           max_reproj_error=3.0))(*args)
    got = ttv.reconstruct_scene(*(_t(x) for x in args), ba_iters=8, ba_rounds=2,
                                max_reproj_error=3.0)
    return got, want


def test_reconstruct_scene(scene, reconstructions):
    got, want = reconstructions
    _rot_close(got.state.q, want.state.q)
    _close(got.state.t, want.state.t, EXTENT, _extent(scene))
    _masks_agree(got.valid_tracks, want.valid_tracks)
    _masks_agree(got.inlier_mask, want.inlier_mask)
    keep = _n(got.valid_tracks) & np.asarray(want.valid_tracks)
    _close(_n(got.state.points)[keep], np.asarray(want.state.points)[keep], EXTENT, _extent(scene))
    _close(got.rms, want.rms, 1e-3)
    # the scene itself: corrupted tracks out, clean ones in
    valid = _n(got.valid_tracks)
    assert valid[:N_OUT].mean() < 0.2 and valid[N_OUT:].mean() > 0.9


def test_scene_to_colmap(tmp_path, scene, reconstructions):
    """The port's SceneReconstruction feeds the port's colmap_io unchanged:
    the same model as JAX's result through JAX's colmap_io."""
    got, want = reconstructions
    assert {"state", "valid_tracks", "inlier_mask"} <= set(got._fields)
    tmodel = tcolmap.scene_to_colmap(got.state.q, got.state.t, scene["k"], scene["tracks"], got,
                                     (int(IMG), int(IMG)))
    jmodel = jcolmap.scene_to_colmap(want.state.q, want.state.t, scene["k"], scene["tracks"], want,
                                     (int(IMG), int(IMG)))
    tcolmap.write_model_text(tmodel, str(tmp_path / "port"))
    back = tcolmap.read_model_text(str(tmp_path / "port"))
    assert sorted(back.images) == sorted(jmodel.images)
    assert abs(len(back.points3d) - len(jmodel.points3d)) <= (1 - MASKS) * N
    for iid, im in back.images.items():
        _rot_close(im.qvec, jmodel.images[iid].qvec)
        _close(im.tvec, jmodel.images[iid].tvec, EXTENT, _extent(scene))
    xyz = {tuple(p.track): p.xyz for p in back.points3d.values()}
    for p in jmodel.points3d.values():
        if tuple(p.track) in xyz:
            _close(xyz[tuple(p.track)], p.xyz, EXTENT, _extent(scene))


# dense depth (host numpy in both packages)


def test_dense_depth(tmp_path):
    rng = np.random.default_rng(3)
    h, w = 24, 32
    depth = rng.uniform(2.0, 6.0, (h, w)).astype(np.float32)
    disp = (1.0 / depth * 0.5 + 0.1).astype(np.float32)  # scale and shift away from 1/depth
    disp[0, :4] = 0.0
    uv = np.stack([rng.integers(0, w, 60), rng.integers(0, h, 60)], -1)
    uvd = np.concatenate([uv, depth[uv[:, 1], uv[:, 0], None]], -1).astype(np.float64)
    uvd[::9, 2] *= 3.0  # outliers for the RANSAC line fit
    for fn, args in (("align_disparity_to_sparse", (disp, uvd)),
                     ("ransac_linear_fit", (uvd[:, 2], 1 / uvd[:, 2] + 0.1, 0.01, 300, 4))):
        got, want = getattr(tdd, fn)(*args), getattr(jdd, fn)(*args)
        for g, w_ in zip(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w_)
    aligned = tdd.align_dense_depth_maps({"a": uvd}, {"a": disp}, max_trials=500)
    np.testing.assert_array_equal(aligned["a"], jdd.align_dense_depth_maps(
        {"a": uvd}, {"a": disp}, max_trials=500)["a"])
    inl = np.abs(1 / aligned["a"][uv[:, 1], uv[:, 0]] - 1 / depth[uv[:, 1], uv[:, 0]]) < 1e-3
    assert inl.mean() > 0.8
    k = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]])
    r = _qmat(_quat([0, 1, 0], 0.1))
    rgb = rng.integers(0, 255, (h, w, 3))
    for g, w_ in zip(tdd.unproject_depth_map(depth, k, r, np.ones(3), rgb),
                     jdd.unproject_depth_map(depth, k, r, np.ones(3), rgb)):
        np.testing.assert_array_equal(g, w_)
    uvs = rng.integers(0, 4, (40, 2))
    d = rng.uniform(1, 2, 40)
    np.testing.assert_array_equal(tdd.filter_invisible_reprojections(uvs, d),
                                  jdd.filter_invisible_reprojections(uvs, d))
    for arr in (depth, rng.random((5, 7, 3)).astype(np.float32)):
        path = tdd.write_colmap_array(arr, str(tmp_path / "map.bin"))
        np.testing.assert_array_equal(tdd.read_colmap_array(path), jdd.read_colmap_array(path))
        np.testing.assert_array_equal(tdd.read_colmap_array(path), arr)
        jdd.write_colmap_array(arr, str(tmp_path / "jmap.bin"))
        assert open(path, "rb").read() == open(tmp_path / "jmap.bin", "rb").read()
