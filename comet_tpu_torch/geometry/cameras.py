"""Camera containers.

Counterpart of ``comet_tpu/geometry/cameras.py``: a camera set is a
NamedTuple of tensors. Rotations are wxyz quaternions; world-to-view follows
the row-vector convention ``X_cam = X_world @ R + T``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CameraSet(NamedTuple):
    """Cameras of one sequence (frames along axis 0), or of a batch of
    sequences ([B, S, ...] arrays and ratio [B]).

    q [N, 4] wxyz rotation; t_xyz [N, 3] metric translation; t_uvz [N, 3]
    image-plane (u, v) of T plus depth z; focal [N, 2]; pp [N, 2];
    ratio [] crop-resize ratio.
    """

    q: torch.Tensor
    t_xyz: torch.Tensor
    t_uvz: torch.Tensor
    focal: torch.Tensor
    pp: torch.Tensor
    ratio: torch.Tensor


def make_camera_set(
    q,
    t_xyz,
    t_uvz=None,
    focal=None,
    pp=None,
    ratio=None,
    dtype=torch.float32,
    device=None,
) -> CameraSet:
    """Build a CameraSet with the reference's defaulting rules."""
    q = torch.as_tensor(q, dtype=dtype, device=device)
    t_xyz = torch.as_tensor(t_xyz, dtype=dtype, device=q.device)
    n = q.shape[0]
    if t_uvz is None:
        t_uvz = q.new_zeros((n, 3))
    else:
        t_uvz = torch.as_tensor(t_uvz, dtype=dtype, device=q.device)
    if focal is None:
        focal = q.new_ones((n, 2))
    else:
        focal = torch.as_tensor(focal, dtype=dtype, device=q.device)
        if focal.dim() == 0:
            focal = focal.expand(n, 2)
        elif focal.dim() == 1:
            focal = focal[:, None].expand(n, 2)
    if pp is None:
        pp = q.new_zeros((n, 2))
    else:
        pp = torch.as_tensor(pp, dtype=dtype, device=q.device)
        if pp.dim() == 1:
            pp = pp[None, :].expand(n, 2)
    if ratio is None:
        ratio = q.new_tensor(1.0)
    else:
        ratio = torch.as_tensor(ratio, dtype=dtype, device=q.device).reshape(())
    return CameraSet(q=q, t_xyz=t_xyz, t_uvz=t_uvz, focal=focal, pp=pp, ratio=ratio)
