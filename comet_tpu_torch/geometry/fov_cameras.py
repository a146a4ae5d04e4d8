"""The FoV and orthographic camera families, NDC <-> screen transforms and
``ndc_grid_sample``.

Counterpart of ``comet_tpu/geometry/fov_cameras.py``, itself the
minipytorch3d family the repo carries:

- FoVPerspectiveCameras (minipytorch3d/cameras.py:510-753),
- FoVOrthographicCameras (cameras.py:793-1003),
- OrthographicCameras (cameras.py:1273, the SfM convention),
- the NDC <-> screen transforms (cameras.py:1765-1870),
- ndc_grid_sample and ndc_to_grid_sample_coords (renderer_utils.py:355-439).

The JAX package's conventions are kept: row-vector transforms (x' = [x, 1]
@ M, so every matrix here is the transpose of the column-major K of
PyTorch3D), PyTorch3D's NDC (+X left, +Y up, z in [0, 1] between znear and
zfar), z_sign +1. The cameras are NamedTuples of tensors, as the rest of
``geometry/``; the constructors give f32 on the CPU unless their tensors
say otherwise.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .quaternions import se3_matrix_row_convention
from .transforms import Transform3d


def _as_batch(x, n: int) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).reshape(-1).expand(n)


def _count(*values) -> int:
    return max(torch.as_tensor(v).numel() for v in values)


def _rows_to_matrix(rows) -> torch.Tensor:
    """The column-major K's rows (each four [N] tensors) -> the row-vector
    matrices [N, 4, 4] (K transposed)."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2).transpose(-1, -2)


def fov_perspective_projection(znear, zfar, fov, aspect_ratio=1.0,
                               degrees: bool = True) -> torch.Tensor:
    """[N, 4, 4] row-vector FoV perspective projections (compute_projection_matrix,
    cameras.py:591-641, transposed): camera space to NDC, (max_x, max_y) ->
    (+1, +1), z -> [0, 1] between znear and zfar, w' = z."""
    n = _count(znear, zfar, fov, aspect_ratio)
    znear, zfar = _as_batch(znear, n), _as_batch(zfar, n)
    fov, aspect_ratio = _as_batch(fov, n), _as_batch(aspect_ratio, n)
    if degrees:
        fov = fov * (math.pi / 180.0)
    max_y = torch.tan(fov / 2.0) * znear
    max_x = max_y * aspect_ratio
    z, one = torch.zeros(n), torch.ones(n)
    f1 = zfar / (zfar - znear)
    f2 = -(zfar * znear) / (zfar - znear)
    return _rows_to_matrix([[znear / max_x, z, z, z], [z, znear / max_y, z, z],
                            [z, z, f1, f2], [z, z, one, z]])


def fov_orthographic_projection(znear, zfar, max_y=1.0, min_y=-1.0, max_x=1.0, min_x=-1.0,
                                scale_xyz=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """[N, 4, 4] row-vector FoV orthographic projections (cameras.py:864-899,
    transposed)."""
    n = _count(znear, zfar, max_y, min_y, max_x, min_x)
    znear, zfar = _as_batch(znear, n), _as_batch(zfar, n)
    max_y, min_y = _as_batch(max_y, n), _as_batch(min_y, n)
    max_x, min_x = _as_batch(max_x, n), _as_batch(min_x, n)
    scale = torch.as_tensor(scale_xyz, dtype=torch.float32).reshape(-1, 3).expand(n, 3)
    z, one = torch.zeros(n), torch.ones(n)
    return _rows_to_matrix([
        [2.0 / (max_x - min_x) * scale[:, 0], z, z, -(max_x + min_x) / (max_x - min_x)],
        [z, 2.0 / (max_y - min_y) * scale[:, 1], z, -(max_y + min_y) / (max_y - min_y)],
        [z, z, scale[:, 2] / (zfar - znear), -znear / (zfar - znear)],
        [z, z, z, one],
    ])


def sfm_calibration_matrix(focal, pp, orthographic: bool = False) -> torch.Tensor:
    """[N, 4, 4] row-vector SfM calibrations (cameras.py:1485-1559,
    transposed); ``focal`` [N] or [N, 2], ``pp`` [N, 2]. Perspective: w' = z."""
    focal = torch.as_tensor(focal, dtype=torch.float32)
    if focal.dim() == 1:
        focal = focal[:, None]
    fx, fy = focal[:, 0], focal[:, -1].expand(focal.shape[0])
    pp = torch.as_tensor(pp, dtype=torch.float32)
    px, py = pp[:, 0], pp[:, 1]
    z, one = torch.zeros_like(fx), torch.ones_like(fx)
    if orthographic:
        rows = [[fx, z, z, px], [z, fy, z, py], [z, z, one, z], [z, z, z, one]]
    else:
        rows = [[fx, z, px, z], [z, fy, py, z], [z, z, z, one], [z, z, one, z]]
    return _rows_to_matrix(rows)


def _eye_r_zero_t(n: int, r, t):
    r = torch.eye(3).expand(n, 3, 3) if r is None else r
    t = torch.zeros(n, 3) if t is None else t
    return r, t


def _per_camera(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[N] -> [N, 1, ..., 1] against ``like`` [N, ..., 3]."""
    return x.reshape(-1, *([1] * (like.dim() - 1)))


class _FoVBase(NamedTuple):
    """Extrinsics (row-vector R, T) and the row-vector projection K."""

    r: torch.Tensor  # [N, 3, 3]
    t: torch.Tensor  # [N, 3]
    k: torch.Tensor  # [N, 4, 4]

    def world_to_view(self) -> Transform3d:
        return Transform3d(se3_matrix_row_convention(self.r, self.t))

    def projection(self) -> Transform3d:
        return Transform3d(self.k)

    def full_projection(self) -> Transform3d:
        """World -> NDC (get_full_projection_transform)."""
        return self.world_to_view().compose(self.projection())

    def transform_points(self, points: torch.Tensor, eps: Optional[float] = None) -> torch.Tensor:
        """World points [N_pts, 3] -> NDC [N_cam, N_pts, 3]."""
        pts = points[None].expand(self.r.shape[0], *points.shape)
        return self.full_projection().transform_points(pts, eps=eps)

    def transform_points_screen(self, points: torch.Tensor, image_size: Tuple[int, int],
                                with_xyflip: bool = True,
                                eps: Optional[float] = None) -> torch.Tensor:
        ndc = self.transform_points(points, eps=eps)
        return ndc_to_screen_transform(self.r.shape[0], image_size,
                                       with_xyflip=with_xyflip).transform_points(ndc)

    def _unproject(self, xy_sdepth: torch.Tensor, world_coordinates: bool) -> torch.Tensor:
        to_ndc = self.full_projection() if world_coordinates else self.projection()
        return Transform3d(torch.linalg.inv(to_ndc.get_matrix())).transform_points(xy_sdepth)


class FoVPerspectiveCameras(_FoVBase):
    """OpenGL-style FoV perspective cameras (cameras.py:510)."""

    @staticmethod
    def create(znear=1.0, zfar=100.0, aspect_ratio=1.0, fov=60.0, degrees=True,
               r: Optional[torch.Tensor] = None,
               t: Optional[torch.Tensor] = None) -> "FoVPerspectiveCameras":
        k = fov_perspective_projection(znear, zfar, fov, aspect_ratio, degrees)
        return FoVPerspectiveCameras(*_eye_r_zero_t(k.shape[0], r, t), k)

    def unproject_points(self, xy_depth: torch.Tensor, world_coordinates: bool = True,
                         scaled_depth_input: bool = False) -> torch.Tensor:
        """NDC (x, y, depth) -> world (or camera) points (cameras.py:703-749);
        depth in world units of z unless ``scaled_depth_input`` (in [0, 1])."""
        if scaled_depth_input:
            return self._unproject(xy_depth, world_coordinates)
        # f1 is K[2, 2], f2 the column-major K[2, 3] = row-vector k[3, 2]
        f1 = _per_camera(self.k[:, 2, 2], xy_depth)
        f2 = _per_camera(self.k[:, 3, 2], xy_depth)
        d = xy_depth[..., 2:3]
        sdepth = (f1 * d + f2) / d
        return self._unproject(torch.cat([xy_depth[..., :2], sdepth], -1), world_coordinates)


class FoVOrthographicCameras(_FoVBase):
    """OpenGL-style FoV orthographic cameras (cameras.py:793)."""

    @staticmethod
    def create(znear=1.0, zfar=100.0, max_y=1.0, min_y=-1.0, max_x=1.0, min_x=-1.0,
               scale_xyz=(1.0, 1.0, 1.0), r: Optional[torch.Tensor] = None,
               t: Optional[torch.Tensor] = None) -> "FoVOrthographicCameras":
        k = fov_orthographic_projection(znear, zfar, max_y, min_y, max_x, min_x, scale_xyz)
        return FoVOrthographicCameras(*_eye_r_zero_t(k.shape[0], r, t), k)

    def unproject_points(self, xy_depth: torch.Tensor, world_coordinates: bool = True,
                         scaled_depth_input: bool = False) -> torch.Tensor:
        """(cameras.py:949-997): the depth's scale and offset from K."""
        if scaled_depth_input:
            return self._unproject(xy_depth, world_coordinates)
        mid_z = _per_camera(self.k[:, 3, 2], xy_depth)
        scale_z = _per_camera(self.k[:, 2, 2], xy_depth)
        sdepth = scale_z * xy_depth[..., 2:3] + mid_z
        return self._unproject(torch.cat([xy_depth[..., :2], sdepth], -1), world_coordinates)


class OrthographicCameras(_FoVBase):
    """SfM-convention orthographic cameras (cameras.py:1273): x_out = fx * x
    + px, no perspective divide."""

    @staticmethod
    def create(focal_length=1.0, principal_point=((0.0, 0.0),),
               r: Optional[torch.Tensor] = None,
               t: Optional[torch.Tensor] = None) -> "OrthographicCameras":
        pp = torch.as_tensor(principal_point, dtype=torch.float32).reshape(-1, 2)
        n = pp.shape[0]
        focal = torch.atleast_1d(torch.as_tensor(focal_length, dtype=torch.float32))
        if focal.dim() == 1:
            focal = focal[:, None]
        k = sfm_calibration_matrix(focal.expand(n, 2), pp, orthographic=True)
        return OrthographicCameras(*_eye_r_zero_t(n, r, t), k)

    def unproject_points(self, xy_depth: torch.Tensor,
                         world_coordinates: bool = True) -> torch.Tensor:
        return self._unproject(xy_depth, world_coordinates)


def ndc_to_screen_transform(n: int, image_size: Tuple[int, int],
                            with_xyflip: bool = False) -> Transform3d:
    """PyTorch3D NDC -> screen (cameras.py:1765-1836), row-vector: the smaller
    image side spans [-1, 1]; ``with_xyflip`` converts between NDC's (+X
    left, +Y up) and the screen's (+X right, +Y down)."""
    h, w = image_size
    scale = min(h, w) / 2.0
    k = torch.zeros(4, 4)
    k[0, 0] = k[1, 1] = scale
    k[0, 3], k[1, 3] = -w / 2.0, -h / 2.0
    k[2, 2] = k[3, 3] = 1.0
    m = k.T.expand(n, 4, 4)
    if with_xyflip:
        m = m @ torch.diag(torch.tensor([-1.0, -1.0, 1.0, 1.0])).expand(n, 4, 4)
    return Transform3d(m)


def screen_to_ndc_transform(n: int, image_size: Tuple[int, int],
                            with_xyflip: bool = False) -> Transform3d:
    """The inverse of :func:`ndc_to_screen_transform` (cameras.py:1838-1870)."""
    fwd = ndc_to_screen_transform(n, image_size, with_xyflip)
    return Transform3d(torch.linalg.inv(fwd.get_matrix()))


def ndc_to_grid_sample_coords(xy_ndc: torch.Tensor, image_size_hw: Tuple[int, int]) -> torch.Tensor:
    """PyTorch3D NDC -> ``grid_sample`` coordinates (renderer_utils.py:413-439):
    negated, the long side's axis shrunk by the aspect ratio."""
    h, w = image_size_hw
    aspect = min(h, w) / max(h, w)
    out = -xy_ndc
    axis = 1 if h >= w else 0
    return torch.cat([out[..., :axis], out[..., axis:axis + 1] * aspect, out[..., axis + 1:]], -1)


def ndc_grid_sample(inputs: torch.Tensor, grid_ndc: torch.Tensor,
                    align_corners: bool = False) -> torch.Tensor:
    """Feature maps [B, H, W, C] (channel-last) sampled at PyTorch3D NDC
    points [B, ..., 2] -> [B, ..., C] (renderer_utils.py:355-410), with
    ``ops.bilinear.sample_features`` and ``grid_sample``'s "zeros"
    padding."""
    from ..ops.bilinear import sample_features

    b, h, w, c = inputs.shape
    spatial = grid_ndc.shape[1:-1]
    flat = ndc_to_grid_sample_coords(grid_ndc.reshape(b, -1, 2), (h, w))
    if align_corners:
        px = (flat[..., 0] + 1.0) * 0.5 * (w - 1)
        py = (flat[..., 1] + 1.0) * 0.5 * (h - 1)
    else:
        px = ((flat[..., 0] + 1.0) * w - 1.0) * 0.5
        py = ((flat[..., 1] + 1.0) * h - 1.0) * 0.5
    out = sample_features(inputs, torch.stack([px, py], -1), padding_mode="zeros")
    return out.reshape(b, *spatial, c)
