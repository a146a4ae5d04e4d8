"""The port's geometry (transforms, the FoV and orthographic cameras, the
absT_quaR_OneFL codec) against ``comet_tpu.geometry``, in f32 within 1e-5
absolute plus 1e-5 relative (screen pixels reach hundreds), on the same
inputs from one numpy generator; the FoV perspective unprojection, which
inverts a 4x4 projection in f32 on each side, within 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu.geometry import cameras as jcam
from comet_tpu.geometry import codecs as jcodecs
from comet_tpu.geometry import fov_cameras as jfov
from comet_tpu.geometry import transforms as jtr
from comet_tpu_torch.geometry import cameras as tcam
from comet_tpu_torch.geometry import codecs as tcodecs
from comet_tpu_torch.geometry import fov_cameras as tfov
from comet_tpu_torch.geometry import transforms as ttr
from comet_tpu_torch.geometry.quaternions import quat_to_matrix

TOL = 1e-5


def _close(got, want, atol=TOL, rtol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _rotations(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return quat_to_matrix(_t(q)).numpy()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def extrinsics(rng):
    r = _rotations(rng, 3)
    t = (rng.normal(size=(3, 3)) + [0.0, 0.0, 8.0]).astype(np.float32)
    pts = (rng.normal(size=(7, 3)) * 2).astype(np.float32)
    return r, t, pts


def test_transform3d(extrinsics):
    r, t, pts = extrinsics
    a = ttr.Transform3d.from_rotation_translation(_t(r), _t(t))
    b = jtr.Transform3d.from_rotation_translation(_j(r), _j(t))
    x = np.broadcast_to(pts, (3, 7, 3))
    _close(a.matrix, b.matrix)
    _close(a.inverse().matrix, b.inverse().matrix)
    _close(a.compose(a.inverse()).matrix, b.compose(b.inverse()).matrix)
    _close(a.transform_points(_t(x)), b.transform_points(_j(x)))
    _close(a.transform_points(_t(x), eps=1e-3), b.transform_points(_j(x), eps=1e-3))
    _close(a.transform_normals(_t(x)), b.transform_normals(_j(x)))
    _close(ttr.Transform3d.identity((2,)).matrix, jtr.Transform3d.identity((2,)).matrix)


def test_perspective_cameras(extrinsics, rng):
    r, t, pts = extrinsics
    focal = rng.uniform(200, 400, (3, 2)).astype(np.float32)
    pp = rng.uniform(100, 300, (3, 2)).astype(np.float32)
    a = ttr.PerspectiveCameras(_t(r), _t(t), _t(focal), _t(pp))
    b = jtr.PerspectiveCameras(_j(r), _j(t), _j(focal), _j(pp))
    screen = a.transform_points_screen(_t(pts))
    _close(screen, b.transform_points_screen(_j(pts)))
    _close(a.unproject_points(screen), b.unproject_points(_j(screen.numpy())))
    _close(a.unproject_points(screen), np.broadcast_to(pts, (3, 7, 3)))


def test_iterative_undistort(rng):
    pts = rng.uniform(-0.8, 0.8, (9, 2)).astype(np.float32)
    k = np.asarray([0.1, -0.05, 0.01], np.float32)
    for iters in (1, 5):
        _close(ttr.iterative_undistort(_t(pts), _t(k), iters),
               jtr.iterative_undistort(_j(pts), _j(k), iters))


@pytest.mark.parametrize("degrees", [True, False])
def test_fov_perspective(extrinsics, degrees):
    r, t, pts = extrinsics
    fov = [60.0, 45.0, 75.0] if degrees else [1.0, 0.7, 1.2]
    kw = dict(znear=[0.5, 1.0, 2.0], zfar=100.0, aspect_ratio=1.5, fov=fov, degrees=degrees)
    a = tfov.FoVPerspectiveCameras.create(**kw, r=_t(r), t=_t(t))
    b = jfov.FoVPerspectiveCameras.create(**kw, r=_j(r), t=_j(t))
    _close(a.k, b.k)
    ndc = a.transform_points(_t(pts))
    _close(ndc, b.transform_points(_j(pts)))
    _close(a.transform_points_screen(_t(pts), (48, 64)),
           b.transform_points_screen(_j(pts), (48, 64)))
    xy_depth = torch.cat([ndc[..., :2], a.world_to_view().transform_points(
        _t(pts)[None].expand(3, 7, 3))[..., 2:]], -1)
    # unprojection inverts the 4x4 projection in f32 (torch.linalg.inv against
    # jnp.linalg.inv): 2.6e-5 apart at fov 1.2 rad, so 1e-4 here
    for world in (True, False):
        _close(a.unproject_points(xy_depth, world),
               b.unproject_points(_j(xy_depth.numpy()), world), atol=1e-4)
        _close(a.unproject_points(ndc, world, scaled_depth_input=True),
               b.unproject_points(_j(ndc.numpy()), world, scaled_depth_input=True), atol=1e-4)
    _close(a.unproject_points(xy_depth), np.broadcast_to(pts, (3, 7, 3)))


def test_fov_orthographic(extrinsics):
    r, t, pts = extrinsics
    kw = dict(znear=1.0, zfar=[20.0, 30.0, 40.0], max_y=2.0, min_y=-1.0, max_x=1.5, min_x=-2.5,
              scale_xyz=(1.0, 2.0, 0.5))
    a = tfov.FoVOrthographicCameras.create(**kw, r=_t(r), t=_t(t))
    b = jfov.FoVOrthographicCameras.create(**kw, r=_j(r), t=_j(t))
    _close(a.k, b.k)
    ndc = a.transform_points(_t(pts))
    _close(ndc, b.transform_points(_j(pts)))
    for world in (True, False):
        for scaled in (True, False):
            _close(a.unproject_points(ndc, world, scaled),
                   b.unproject_points(_j(ndc.numpy()), world, scaled))


def test_orthographic_sfm(extrinsics):
    r, t, pts = extrinsics
    kw = dict(focal_length=[1.5, 2.0, 0.5], principal_point=[[0.1, -0.2], [0.0, 0.3], [0.2, 0.2]])
    a = tfov.OrthographicCameras.create(**kw, r=_t(r), t=_t(t))
    b = jfov.OrthographicCameras.create(**kw, r=_j(r), t=_j(t))
    _close(a.k, b.k)
    x = a.transform_points(_t(pts))
    _close(x, b.transform_points(_j(pts)))
    _close(a.unproject_points(x), b.unproject_points(_j(x.numpy())))
    _close(a.unproject_points(x), np.broadcast_to(pts, (3, 7, 3)))
    for ortho in (True, False):
        _close(tfov.sfm_calibration_matrix(_t([[2.0, 3.0]]), _t([[0.5, 0.25]]), ortho),
               jfov.sfm_calibration_matrix(_j([[2.0, 3.0]]), _j([[0.5, 0.25]]), ortho))


@pytest.mark.parametrize("size", [(48, 64), (64, 48), (32, 32)])
@pytest.mark.parametrize("flip", [True, False])
def test_ndc_screen_transforms(rng, size, flip):
    pts = rng.uniform(-1, 1, (2, 5, 3)).astype(np.float32)
    a, b = tfov.ndc_to_screen_transform(2, size, flip), jfov.ndc_to_screen_transform(2, size, flip)
    _close(a.matrix, b.matrix)
    _close(a.transform_points(_t(pts)), b.transform_points(_j(pts)))
    _close(tfov.screen_to_ndc_transform(2, size, flip).matrix,
           jfov.screen_to_ndc_transform(2, size, flip).matrix)
    _close(tfov.ndc_to_grid_sample_coords(_t(pts[..., :2]), size),
           jfov.ndc_to_grid_sample_coords(_j(pts[..., :2]), size))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(12, 16), (16, 12)])
def test_ndc_grid_sample(rng, align_corners, size):
    feats = rng.normal(size=(2, *size, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 4, 5, 2)).astype(np.float32)  # some outside: zeros
    got = tfov.ndc_grid_sample(_t(feats), _t(grid), align_corners)
    assert got.shape == (2, 4, 5, 3)
    _close(got, jfov.ndc_grid_sample(_j(feats), _j(grid), align_corners))


def _cams(rng, s=5):
    q = rng.normal(size=(s, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=(s, 3)).astype(np.float32)
    focal = rng.uniform(0.05, 40.0, (s, 2)).astype(np.float32)  # some outside the clamp
    kw = dict(q=q, t_xyz=t, t_uvz=t, focal=focal, pp=np.zeros((s, 2), np.float32),
              ratio=np.float32(1.0))
    return (tcam.CameraSet(**{k: _t(v) for k, v in kw.items()}),
            jcam.CameraSet(**{k: _j(v) for k, v in kw.items()}))


def test_abst_quar_onefl_codec(rng):
    tc, jc = _cams(rng)
    enc = tcodecs.encode_abst_quar_onefl(tc)
    _close(enc, jcodecs.encode_abst_quar_onefl(jc))
    enc2 = rng.normal(size=(2, 5, 8)).astype(np.float32)
    enc2[..., 7] = rng.uniform(0.0, 50.0, (2, 5))
    for got, want in zip(tcodecs.decode_abst_quar_onefl(_t(enc2), tc, 0.2, 20.0),
                         jcodecs.decode_abst_quar_onefl(_j(enc2), jc, 0.2, 20.0)):
        _close(got, want)
    q, t, f = tcodecs.decode_abst_quar_onefl(enc, tc)
    _close(t, tc.t_xyz)


def test_intrinsics_and_get_efp(rng):
    focal = rng.uniform(0.5, 3.0, (6, 2)).astype(np.float32)
    pp = rng.uniform(100, 200, (6, 2)).astype(np.float32)
    _close(tcodecs.create_intri_matrix(_t(focal), _t(pp)),
           jcodecs.create_intri_matrix(_j(focal), _j(pp)))
    r, t = _rotations(rng, 6), rng.normal(size=(6, 3)).astype(np.float32)
    focal[0] = [0.01, 0.02]  # under the clamp
    focal[1] = [30.0, 40.0]  # over it
    for default in (False, True):
        got = tcodecs.get_efp(_t(r), _t(t), _t(focal), (96, 128), 2, 3, default)
        want = jcodecs.get_efp(_j(r), _j(t), _j(focal), np.asarray((96, 128)), 2, 3, default)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            _close(g, w)


@pytest.mark.parametrize("logspace,append_input", [(True, False), (False, True)])
def test_harmonic_embedding_matches_jax(rng, logspace, append_input):
    """The NeRF-style harmonic embedding (no JAX model calls it) within
    1e-5: sines of arguments up to 2^5 x |x| < 100."""
    from comet_tpu.geometry import embeddings as jemb
    from comet_tpu_torch.geometry import harmonic_embedding

    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    kw = dict(n_harmonic_functions=6, omega_0=0.7, logspace=logspace, append_input=append_input)
    got = harmonic_embedding(_t(x), **kw)
    want = jemb.harmonic_embedding(_j(x), **kw)
    assert tuple(got.shape) == want.shape
    _close(got, want)
