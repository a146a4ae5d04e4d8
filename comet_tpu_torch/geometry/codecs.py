"""Frame-0-relative pose encodings: encoders and decoders.

Counterpart of the uvz and xyz codecs of ``comet_tpu/geometry/codecs.py``:

- uvz codec: (du, dv) in crop-normalized pixels, dd relative depth, relative
  quaternion; translation recovered through the pinhole model with the
  dataset's intrinsics.
- xyz codec: dT = T_i - T_0 in metric space, relative quaternion.

The encoders take the cameras of one sequence ([S, ...]).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .cameras import CameraSet
from .quaternions import quat_invert, quat_multiply, quat_standardize


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float


# Per-dataset intrinsics table.
INTRINSICS_TABLE = {
    "spark": Intrinsics(1744.92206139719, 1746.58640701753, 737.272795902663, 528.471960188736),
    "AMD": Intrinsics(268.44444444, 268.44444444, 320.0, 240.0),
    "AMD_eval": Intrinsics(268.44444444, 268.44444444, 320.0, 240.0),
    "AMD_test": Intrinsics(214.75555555, 286.34074074, 256.0, 256.0),
}

# The du/dv normalization constant of the codec, whatever the crop size.
_UV_NORM = 256.0 / 2.0


def encode_relative_uvz(cams: CameraSet) -> torch.Tensor:
    """S cameras -> frame-0-relative [S, 8] = (du, dv, dd, quat, focal).

    Row 0 is the identity encoding (zeros and the unit quaternion) with the
    frame-0 focal appended; du and dv are normalized by ``_UV_NORM``
    whatever the crop size."""
    q, t_uvz, ratio = cams.q, cams.t_uvz, cams.ratio
    q_rel = quat_standardize(quat_multiply(q, quat_invert(q[0:1])))
    du = (t_uvz[:, 0] - t_uvz[0, 0]) * ratio / _UV_NORM
    dv = (t_uvz[:, 1] - t_uvz[0, 1]) * ratio / _UV_NORM
    dd = (t_uvz[:, 2] / t_uvz[0, 2] - 1.0) * ratio
    focal = cams.focal[:, 0].clamp(0.1, 30.0)
    enc = torch.cat([torch.stack([du, dv, dd], dim=-1), q_rel, focal[:, None]], dim=-1)
    first = torch.cat([enc.new_tensor([0, 0, 0, 1, 0, 0, 0]), focal[0:1]])
    return torch.cat([first[None], enc[1:]])


def decode_relative_uvz(
    enc: torch.Tensor, ref_cams: CameraSet, intrinsics: Intrinsics
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[*, C>=7] encodings -> absolute (quat [*, 4], T_xyz [*, 3]), with
    ``ref_cams`` row 0 as the reference frame:
    T = ((u - cx) d / fx, (v - cy) d / fy, d)."""
    flat = enc.reshape(-1, enc.shape[-1])
    q_ref = ref_cams.q[0]
    t_ref = ref_cams.t_uvz[0]
    ratio = ref_cams.ratio

    u_abs = t_ref[0] + flat[:, 0] / ratio * _UV_NORM
    v_abs = t_ref[1] + flat[:, 1] / ratio * _UV_NORM
    d_abs = t_ref[2] * (flat[:, 2] / ratio + 1.0)
    tx = (u_abs - intrinsics.cx) * d_abs / intrinsics.fx
    ty = (v_abs - intrinsics.cy) * d_abs / intrinsics.fy
    t_abs = torch.stack([tx, ty, d_abs], dim=-1)

    rel = flat[:, 3:7]
    q_abs = quat_standardize(quat_multiply(rel, q_ref.expand_as(rel)))
    batch = enc.shape[:-1]
    return q_abs.reshape(*batch, 4), t_abs.reshape(*batch, 3)


def encode_relative_xyz(cams: CameraSet) -> torch.Tensor:
    """S cameras -> frame-0-relative [S, 7] = (dT_xyz, quat); row 0 is the
    identity encoding."""
    q_rel = quat_standardize(quat_multiply(cams.q, quat_invert(cams.q[0:1])))
    enc = torch.cat([cams.t_xyz - cams.t_xyz[0:1], q_rel], dim=-1)
    return torch.cat([enc.new_tensor([[0, 0, 0, 1, 0, 0, 0]]), enc[1:]])


def decode_relative_xyz(
    enc: torch.Tensor, ref_cams: CameraSet
) -> Tuple[torch.Tensor, torch.Tensor]:
    """xyz-codec encodings -> absolute (quat, T)."""
    flat = enc.reshape(-1, enc.shape[-1])
    q_ref = ref_cams.q[0].expand(flat.shape[0], 4)
    t_abs = ref_cams.t_xyz[0][None, :] + flat[:, :3]
    q_abs = quat_standardize(quat_multiply(flat[:, 3:7], q_ref))
    batch = enc.shape[:-1]
    return q_abs.reshape(*batch, 4), t_abs.reshape(*batch, 3)
