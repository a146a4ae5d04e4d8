"""Preliminary camera estimation from point tracks.

Counterpart of ``comet_tpu/twoview/preliminary.py`` (the reference's
estimate_preliminary_cameras, comet/two_view_geo/estimate_preliminary.py:
98-230): frame 0 paired with every other frame, a fundamental matrix
RANSAC per pair on the track correspondences (masked by visibility and
score), lifted to an essential matrix with the default intrinsics (focal
max(W, H), principal point at the center), decomposed with cheirality,
frame 0 padded with the identity. The S - 1 pairs are one batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..geometry.quaternions import matrix_to_quat
from . import estimators
from .estimators import (
    gather_points,
    motion_from_essential,
    project_to_essential,
    run_8point,
    sampson_distance,
    take,
    to_homogeneous,
    where,
)


def default_kmat(width: int, height: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The default intrinsics: focal max(W, H), principal point at the
    center (estimate_preliminary.py:244-270 / get_default_intri), on
    ``device`` (the card by default)."""
    k = torch.zeros(3, 3, dtype=dtype, device=resolve_device(device, "default_kmat"))
    # fill_ takes the value as a kernel argument: no copy from the host, no
    # synchronization (k[i, j] = v would copy a host tensor)
    for (i, j), v in (((0, 0), max(width, height)), ((1, 1), max(width, height)),
                      ((0, 2), width / 2.0), ((1, 2), height / 2.0), ((2, 2), 1.0)):
        k[i, j].fill_(float(v))
    return k


def _masked_fundamental_ransac(pts1: torch.Tensor, pts2: torch.Tensor, valid: torch.Tensor,
                               generator: torch.Generator, max_error: float,
                               num_hypotheses: int
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """8-point RANSAC over a batch of pairs, pts [P, N, 2], valid [P, N],
    where invalid correspondences are neither sampled nor counted as
    inliers. Returns (F [P, 3, 3], inlier mask [P, N], residuals [P, N])."""
    n = pts1.shape[-2]
    valid = valid.to(pts1.dtype)
    p = valid / valid.sum(dim=-1, keepdim=True).clamp_min(1.0)
    idx = estimators.ransac_samples(n, num_hypotheses, 8, generator, pts1.device, p=p)
    models = run_8point(gather_points(pts1, idx), gather_points(pts2, idx))  # [P, H, 3, 3]
    errs = sampson_distance(models, pts1[:, None], pts2[:, None])  # [P, H, N]
    ok = valid[:, None, :] > 0.5
    inliers = (errs < max_error) & ok
    scores = inliers.sum(dim=-1)
    best = scores.argmax(dim=-1)  # [P]
    best_inl = take(inliers, best)

    # local optimization: the weighted refit on the best inlier set
    f_refit = run_8point(pts1, pts2, weights=best_inl.to(pts1.dtype))
    errs_r = sampson_distance(f_refit, pts1, pts2)
    inl_r = (errs_r < max_error) & ok[:, 0]
    better = inl_r.sum(dim=-1) >= take(scores, best)
    return (where(better, f_refit, take(models, best)), where(better, inl_r, best_inl),
            where(better, errs_r, take(errs, best)))


def estimate_preliminary_cameras(tracks: torch.Tensor, tracks_vis: torch.Tensor, width: int,
                                 height: int, tracks_score: Optional[torch.Tensor] = None,
                                 max_error: float = 0.5, num_hypotheses: int = 128,
                                 generator: Optional[torch.Generator] = None
                                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Tracks [B, S, N, 2] (pixels), visibility [B, S, N] in [0, 1] ->
    frame-0-relative preliminary poses.

    Returns (cameras, preliminary_dict): cameras = {"q": [B, S, 4] wxyz,
    "t": [B, S, 3]} (frame 0 the identity); preliminary_dict = {"fmat":
    [B, S-1, 3, 3], "fmat_inlier_mask": [B, S-1, N]}, the reference's
    outputs (estimate_preliminary.py:215-230)."""
    generator = estimators.default_generator(generator, tracks.device)
    b, s, n, _ = tracks.shape
    q_pts = tracks[:, 0:1].expand(b, s - 1, n, 2).reshape(b * (s - 1), n, 2)
    r_pts = tracks[:, 1:].reshape(b * (s - 1), n, 2)
    valid = (tracks_vis >= 0.05)[:, 1:].reshape(b * (s - 1), n)
    if tracks_score is not None:
        valid = valid & (tracks_score >= 0.5)[:, 1:].reshape(b * (s - 1), n)

    kmat = default_kmat(width, height, tracks.dtype, device=tracks.device)
    kinv = torch.linalg.inv_ex(kmat)[0]
    f, inl, _ = _masked_fundamental_ransac(q_pts, r_pts, valid, generator, max_error,
                                           num_hypotheses)
    # E = K^T F K, then the motion by cheirality on normalized coordinates
    e = project_to_essential(kmat.T @ f @ kmat)
    n1 = (to_homogeneous(q_pts) @ kinv.T)[..., :2]
    n2 = (to_homogeneous(r_pts) @ kinv.T)[..., :2]
    r, t = motion_from_essential(e, n1, n2)

    q_rel = matrix_to_quat(r.reshape(b, s - 1, 3, 3))
    # frame 0 the identity (estimate_preliminary.py:174-190)
    q_id = tracks.new_zeros(b, 1, 4)
    q_id[..., 0].fill_(1.0)
    cameras = {"q": torch.cat([q_id, q_rel], dim=1),
               "t": torch.cat([tracks.new_zeros(b, 1, 3), t.reshape(b, s - 1, 3)], dim=1)}
    preliminary = {"fmat": f.reshape(b, s - 1, 3, 3), "fmat_inlier_mask": inl.reshape(b, s - 1, n)}
    return cameras, preliminary
