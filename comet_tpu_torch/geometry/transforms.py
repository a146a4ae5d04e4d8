"""Transform3d and PerspectiveCameras, row-vector convention.

Counterpart of ``comet_tpu/geometry/transforms.py``, itself the subset of
minipytorch3d/transform3d.py:48 (compose, inverse, transform_points) and
minipytorch3d/cameras.py:1034 (PerspectiveCameras projection and
unprojection in screen space) that the repo uses: a point is a row vector,
x' = [x, 1] @ M.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .quaternions import se3_inverse_row_convention, se3_matrix_row_convention


class Transform3d(NamedTuple):
    """Batch of 4x4 row-vector transforms: x' = [x, 1] @ matrix."""

    matrix: torch.Tensor  # [..., 4, 4]

    @staticmethod
    def identity(batch=(), dtype=torch.float32, device=None) -> "Transform3d":
        return Transform3d(torch.eye(4, dtype=dtype, device=device).expand(*batch, 4, 4))

    @staticmethod
    def from_rotation_translation(r: torch.Tensor, t: torch.Tensor) -> "Transform3d":
        return Transform3d(se3_matrix_row_convention(r, t))

    def compose(self, other: "Transform3d") -> "Transform3d":
        """self then other: x @ M_self @ M_other."""
        return Transform3d(self.matrix @ other.matrix)

    def inverse(self) -> "Transform3d":
        return Transform3d(se3_inverse_row_convention(self.matrix))

    def transform_points(self, points: torch.Tensor, eps: Optional[float] = None) -> torch.Tensor:
        """points [..., N, 3] -> transformed [..., N, 3]; with ``eps`` the
        homogeneous divisor is kept at least ``eps`` from zero."""
        ph = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
        out = torch.einsum("...ni,...ij->...nj", ph, self.matrix)
        denom = out[..., 3:]
        if eps is not None:
            denom = torch.where(denom.abs() < eps,
                                torch.sign(denom) * eps + (denom == 0) * eps, denom)
        return out[..., :3] / denom

    def transform_normals(self, normals: torch.Tensor) -> torch.Tensor:
        inv_t = torch.linalg.inv(self.matrix[..., :3, :3])
        return torch.einsum("...ni,...ij->...nj", normals, inv_t.transpose(-1, -2))

    def get_matrix(self) -> torch.Tensor:
        return self.matrix


class PerspectiveCameras(NamedTuple):
    """Pinhole camera batch, screen-space convention: ``r`` [N, 3, 3]
    row-vector world-to-view rotations, ``t`` [N, 3], ``focal`` [N, 2],
    ``pp`` [N, 2] principal points in pixels."""

    r: torch.Tensor
    t: torch.Tensor
    focal: torch.Tensor
    pp: torch.Tensor

    def world_to_view(self) -> Transform3d:
        return Transform3d.from_rotation_translation(self.r, self.t)

    def transform_points_screen(self, points: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
        """World points [N_pts, 3], for every camera -> [N_cam, N_pts, 3]
        (x_pix, y_pix, depth)."""
        cam = self.world_to_view().transform_points(points[None].repeat(self.r.shape[0], 1, 1))
        zc = cam[..., 2:]
        z = zc.abs().clamp_min(eps) * torch.sign(torch.where(zc == 0, torch.ones_like(zc), zc))
        x = cam[..., 0:1] / z * self.focal[:, None, 0:1] + self.pp[:, None, 0:1]
        y = cam[..., 1:2] / z * self.focal[:, None, 1:2] + self.pp[:, None, 1:2]
        return torch.cat([x, y, zc], dim=-1)

    def unproject_points(self, xy_depth: torch.Tensor) -> torch.Tensor:
        """Screen (x, y, depth) -> world points, the inverse of
        :meth:`transform_points_screen`."""
        d = xy_depth[..., 2:]
        xc = (xy_depth[..., 0:1] - self.pp[:, None, 0:1]) * d / self.focal[:, None, 0:1]
        yc = (xy_depth[..., 1:2] - self.pp[:, None, 1:2]) * d / self.focal[:, None, 1:2]
        cam = torch.cat([xc, yc, d], dim=-1)
        return self.world_to_view().inverse().transform_points(cam)


def iterative_undistort(pts: torch.Tensor, k_radial: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """Fixed-point undistortion of [N, 2] distorted normalized coordinates
    (comet/utils/distortion.py:27): x_u = x_d / (1 + k1 r^2 + k2 r^4 + ...),
    ``iters`` times."""
    p = pts
    for _ in range(iters):
        r2 = (p ** 2).sum(-1, keepdim=True)
        factor, rpow = torch.ones_like(r2), r2
        for k in k_radial:
            factor = factor + k * rpow
            rpow = rpow * r2
        p = pts / factor
    return p
