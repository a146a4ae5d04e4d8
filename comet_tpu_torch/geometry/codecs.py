"""Decoding of frame-0-relative pose encodings.

Counterpart of the decoders of ``comet_tpu/geometry/codecs.py``:

- uvz codec: (du, dv) in crop-normalized pixels, dd relative depth, relative
  quaternion; translation recovered through the pinhole model with the
  dataset's intrinsics.
- xyz codec: dT = T_i - T_0 in metric space, relative quaternion.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .cameras import CameraSet
from .quaternions import quat_multiply, quat_standardize


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
