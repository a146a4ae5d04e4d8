"""Quaternion and rotation-matrix math (wxyz convention).

Counterpart of ``comet_tpu/geometry/quaternions.py``. Functions broadcast
over leading batch dimensions. Rotation matrices act on column vectors:
``v' = R @ v``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize quaternions along the last axis."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(eps)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a * b of wxyz quaternions (broadcasts)."""
    aw, ax, ay, az = torch.unbind(a, -1)
    bw, bx, by, bz = torch.unbind(b, -1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_standardize(q: torch.Tensor) -> torch.Tensor:
    """Flip the sign so that w >= 0."""
    return torch.where(q[..., :1] < 0, -q, q)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (w, -x, -y, -z)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_invert(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion: its conjugate."""
    return quat_conjugate(q)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternions [..., 4] -> rotation matrices [..., 3, 3]."""
    w, x, y, z = torch.unbind(quat_normalize(q), -1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> wxyz quaternions [..., 4].

    The branchless "largest diagonal candidate" algorithm: four candidate
    quaternions, each exact when its pivot is the largest, and the
    best-conditioned one picked per element."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    def sqrt_pos(x):
        return torch.sqrt(x.clamp_min(0.0))

    q_abs = torch.stack(
        [
            sqrt_pos(1.0 + m00 + m11 + m22),  # |w|*2
            sqrt_pos(1.0 + m00 - m11 - m22),  # |x|*2
            sqrt_pos(1.0 - m00 + m11 - m22),  # |y|*2
            sqrt_pos(1.0 - m00 - m11 + m22),  # |z|*2
        ],
        dim=-1,
    )
    candidates = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )
    candidates = candidates / (2.0 * q_abs.clamp_min(0.1))[..., None]
    best = q_abs.argmax(dim=-1)
    q = torch.gather(candidates, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    return quat_normalize(q)


def random_quaternions(shape=(), generator: Optional[torch.Generator] = None,
                       device=None) -> torch.Tensor:
    """Uniform random unit quaternions, drawn from ``generator``."""
    return quat_normalize(torch.randn(*shape, 4, generator=generator, device=device))


def geodesic_angle_from_matrices(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle (radians) between rotation matrices [..., 3, 3]:
    arccos((trace(r1 r2^T) - 1) / 2), clipped to the valid range."""
    m = torch.einsum("...ij,...kj->...ik", r1, r2)
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0) / 2.0
    return torch.arccos(cos.clamp(-1.0, 1.0))


def rotation_angle_from_quats(q1: torch.Tensor, q2: torch.Tensor,
                              eps: float = 1e-15) -> torch.Tensor:
    """Angle (degrees) between unit quaternions, sign-invariant:
    arccos(1 - 2 (1 - (q1.q2)^2))."""
    loss_q = (1.0 - (q1 * q2).sum(-1) ** 2).clamp_min(eps)
    return torch.arccos((1.0 - 2.0 * loss_q).clamp(-1.0, 1.0)) * (180.0 / math.pi)


def euler_xyz_from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Euler angles [..., 3] = (x, y, z) in radians, with the reference's
    singular branch (sy < 1e-6: z = atan2(-m12, m11), x = 0)."""
    sy = torch.sqrt(m[..., 0, 0] ** 2 + m[..., 1, 0] ** 2)
    singular = sy < 1e-6
    z = torch.where(singular, torch.atan2(-m[..., 1, 2], m[..., 1, 1]),
                    torch.atan2(m[..., 2, 1], m[..., 2, 2]))
    y = torch.atan2(-m[..., 2, 0], sy)
    x = torch.where(singular, torch.zeros_like(sy), torch.atan2(m[..., 1, 0], m[..., 0, 0]))
    return torch.stack([x, y, z], dim=-1)


def se3_matrix_row_convention(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Row-vector SE(3) matrices [..., 4, 4]: x_cam = x_world @ R + T, i.e.
    M = [[R, 0], [T, 1]] applied as x_h @ M."""
    m = r.new_zeros((*r.shape[:-2], 4, 4))
    m[..., :3, :3] = r
    m[..., 3, :3] = t
    m[..., 3, 3] = 1.0
    return m


def se3_inverse_row_convention(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a row-convention SE(3) matrix:
    [[R^T, 0], [-T R^T, 1]]."""
    r_t = m[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(m)
    out[..., :3, :3] = r_t
    out[..., 3:4, :3] = -(m[..., 3:4, :3] @ r_t)
    out[..., 3, 3] = 1.0
    return out
