"""Multi-view DLT triangulation, projection matrices and projection.

Counterpart of ``comet_tpu/twoview/triangulation.py:27-70`` (the
reference's all-view DLT, comet/utils/triangulation.py:677): every point
triangulated over all views at once as one batched SVD. Cameras follow the
row-vector convention x_cam = x_world @ R + T. The bundle adjustment of
that module is not ported yet.
"""

from __future__ import annotations

import torch

from ..geometry.quaternions import quat_to_matrix


def triangulate_multiview(
    proj: torch.Tensor,  # [S, 3, 4] projection matrices
    pts2d: torch.Tensor,  # [S, 2] observations of one point
    mask: torch.Tensor,  # [S] observation validity
) -> torch.Tensor:
    """All-view DLT triangulation of one point -> [3]."""
    return triangulate_tracks(proj, pts2d[:, None], mask[:, None])[0]


def triangulate_tracks(
    proj: torch.Tensor,  # [S, 3, 4]
    pts2d: torch.Tensor,  # [S, N, 2]
    mask: torch.Tensor,  # [S, N]
) -> torch.Tensor:
    """DLT triangulation of N tracks, one batched SVD -> points [N, 3]. Each
    view gives two rows x P_3 - P_1 and y P_3 - P_2, weighted by its mask;
    the point is the right singular vector of the smallest singular value."""
    pts = pts2d.transpose(0, 1).to(proj.dtype)  # [N, S, 2]
    rows_x = pts[..., 0:1] * proj[:, 2] - proj[:, 0]  # [N, S, 4]
    rows_y = pts[..., 1:2] * proj[:, 2] - proj[:, 1]
    a = torch.cat([rows_x, rows_y], dim=1)  # [N, 2S, 4]
    w = mask.transpose(0, 1).to(a.dtype)
    a = a * torch.cat([w, w], dim=1)[..., None]
    x = torch.linalg.svd(a, full_matrices=True).Vh[:, -1]  # [N, 4]
    h = x[:, 3:]
    return x[:, :3] / torch.where(h.abs() > 1e-10, h, torch.full_like(h, 1e-10))


def projection_matrices(q: torch.Tensor, t: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[S, 3, 4] projection matrices from quaternions, translations and
    intrinsics: x_cam = x_world @ R + T makes the column-vector matrix
    K [R^T | T]."""
    ext = torch.cat([quat_to_matrix(q).transpose(-1, -2), t[..., None]], dim=-1)
    return torch.einsum("ij,sjk->sik", k, ext)


def project_points(points: torch.Tensor, q: torch.Tensor, t: torch.Tensor,
                   k: torch.Tensor) -> torch.Tensor:
    """points [N, 3], cameras [S] -> pixel coordinates [S, N, 2]."""
    cam = torch.einsum("nj,sji->sni", points, quat_to_matrix(q)) + t[:, None, :]
    pix = torch.einsum("ij,snj->sni", k, cam)
    z = pix[..., 2:]
    return pix[..., :2] / z.abs().clamp_min(1e-8) * torch.sign(z)
