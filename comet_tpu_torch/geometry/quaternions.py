"""Quaternion math (wxyz convention).

Counterpart of the parts of ``comet_tpu/geometry/quaternions.py`` that the
pose codecs use.
"""

from __future__ import annotations

import torch


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
