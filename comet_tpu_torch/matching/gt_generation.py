"""Ground-truth matches from homographies and relative poses.

Counterpart of ``comet_tpu/matching/gt_generation.py`` (gluefactory's
geometry/gt_generation.py): mutual nearest reprojections within a pixel
threshold match, points farther than the negative threshold are unmatched
(-1), the rest ignored (-2). Static shapes; ties go to the lowest index. The inverses skip the error
check (``inv_ex``: no host sync; a singular matrix gives non-finite
distances, as JAX's inverse does).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..twoview.estimators import to_homogeneous

IGNORE = -2
UNMATCHED = -1


def warp_homography(kpts: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """[N, 2] points through a 3 x 3 homography."""
    x = to_homogeneous(kpts) @ h.T
    z = x[:, 2:]
    return x[:, :2] / torch.where(z.abs() > 1e-8, z, 1e-8)


def _label(dist, pos_threshold, neg_threshold):
    n0, n1 = dist.shape
    nn0 = dist.argmin(dim=1)
    nn1 = dist.argmin(dim=0)
    best0 = dist.amin(dim=1)
    best1 = dist.amin(dim=0)
    mutual0 = torch.arange(n0, device=dist.device) == nn1[nn0]
    mutual1 = torch.arange(n1, device=dist.device) == nn0[nn1]
    matches0 = torch.where(mutual0 & (best0 < pos_threshold), nn0,
                           torch.where(best0 > neg_threshold, UNMATCHED, IGNORE))
    matches1 = torch.where(mutual1 & (best1 < pos_threshold), nn1,
                           torch.where(best1 > neg_threshold, UNMATCHED, IGNORE))
    return {"matches0": matches0, "matches1": matches1, "distances": dist}


def gt_matches_from_homography(
    kpts0: torch.Tensor,  # [N0, 2]
    kpts1: torch.Tensor,  # [N1, 2]
    h: torch.Tensor,  # [3, 3] image0 -> image1
    pos_threshold: float = 3.0,
    neg_threshold: float = 6.0,
) -> Dict[str, torch.Tensor]:
    """matches0 [N0], matches1 [N1] (index, UNMATCHED or IGNORE) and the
    symmetric reprojection distances [N0, N1]."""
    proj0 = warp_homography(kpts0, h)  # kpts0 in image 1
    proj1 = warp_homography(kpts1, torch.linalg.inv_ex(h)[0])  # kpts1 in image 0
    d0 = torch.linalg.vector_norm(proj0[:, None] - kpts1[None], dim=-1)
    d1 = torch.linalg.vector_norm(kpts0[:, None] - proj1[None], dim=-1)
    return _label(torch.maximum(d0, d1), pos_threshold, neg_threshold)


def gt_matches_from_pose(
    kpts0: torch.Tensor,
    kpts1: torch.Tensor,
    e: torch.Tensor,  # [3, 3] essential matrix (normalized coordinates)
    k0: torch.Tensor,
    k1: torch.Tensor,
    pos_threshold: float = 5e-4,
    neg_threshold: float = 5e-3,
) -> Dict[str, torch.Tensor]:
    """Epipolar labels: the symmetric point-to-epipolar-line distance in
    normalized coordinates; pairs under ``pos_threshold`` can match, pairs
    over ``neg_threshold`` are non-matches."""
    n0 = to_homogeneous(kpts0) @ torch.linalg.inv_ex(k0)[0].T
    n1 = to_homogeneous(kpts1) @ torch.linalg.inv_ex(k1)[0].T
    l1 = n0 @ e.T  # [N0, 3] epipolar lines in image 1
    l0 = n1 @ e  # [N1, 3] in image 0
    num = torch.einsum("ic,jc->ij", l1, n1).abs()
    norm1 = torch.sqrt(l1[:, 0] ** 2 + l1[:, 1] ** 2)
    norm0 = torch.sqrt(l0[:, 0] ** 2 + l0[:, 1] ** 2)
    dist = 0.5 * num * (1.0 / norm1[:, None].clamp_min(1e-9) + 1.0 / norm0[None, :].clamp_min(1e-9))
    return _label(dist, pos_threshold, neg_threshold)
