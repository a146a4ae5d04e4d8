"""The staged scene reconstruction: init-pair BA, per-camera pose
refinement, global BA, then rounds of filtering and re-BA.

Counterpart of ``comet_tpu/twoview/scene_ba.py`` (the reference's
pycolmap-driven orchestration, comet/utils/triangulation.py:
triangulate_by_pair:45, init_BA:138, refine_pose:260, global_BA:1020,
iterative_global_BA:1076, and the COLMAP-style point filter,
triangulation_helpers.py:133-300), composed from the dense-LM solvers of
``triangulation`` and the PnP of ``pnp``: every stage is batched with
fixed shapes and chains on the device without a host read.

Conventions: row-vector cameras (x_cam = x_world @ R + T), wxyz
quaternions, tracks [S, N, 2] in pixels, one K shared by all frames.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..geometry.quaternions import matrix_to_quat, quat_to_matrix
from .estimators import take, where
from .pnp import _solve_pnp
from .triangulation import (
    BAState,
    bundle_adjust,
    project_points,
    projection_matrices,
    to_pixels,
    triangulate_tracks,
    triangulate_tracks_ransac,
)


def camera_centers(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[S, 3] world-space centers: C @ R + T = 0, so C = -T R^T."""
    return -torch.einsum("sj,sij->si", t, quat_to_matrix(q))


def _tri_angle_deg(ray_a: torch.Tensor, ray_b: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """The triangulation angle min(theta, 180 - theta) from squared ray
    lengths and the squared baseline, by the law of cosines."""
    cosang = (ray_a + ray_b - base) / (2.0 * torch.sqrt((ray_a * ray_b).clamp_min(1e-12)))
    ang = torch.rad2deg(torch.arccos(cosang.clamp(-1.0, 1.0)))
    return torch.minimum(ang, 180.0 - ang)


def triangulation_angles_deg(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Every pair's triangulation angle per point, [S, S, N] degrees
    (colmap triangulation.cc:130, as in triangulation.py:85-130)."""
    ray2 = torch.sum((points[None, :, :] - centers[:, None, :]) ** 2, -1)  # [S, N]
    base2 = torch.sum((centers[:, None, :] - centers[None, :, :]) ** 2, -1)  # [S, S]
    return _tri_angle_deg(ray2[:, None, :], ray2[None, :, :], base2[..., None])


def triangulate_by_pair(q: torch.Tensor, t: torch.Tensor, k: torch.Tensor, tracks: torch.Tensor,
                        vis: torch.Tensor, max_reproj_error: float = 4.0,
                        min_tri_angle: float = 1.5
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Triangulate every (frame 0, frame i) pair (triangulation.py:45-137).

    Returns (points [S-1, N, 3], inlier [S-1, N], angles [S-1, N] degrees),
    the inlier combining cheirality in both views, the pair's reprojection
    error and its triangulation angle."""
    proj = projection_matrices(q, t, k)  # [S, 3, 4]
    s = tracks.shape[0]
    r = quat_to_matrix(q)
    centers = -torch.einsum("sj,sij->si", t, r)
    m = vis[0:1] * vis[1:]  # [S-1, N]
    pair_proj = torch.stack([proj[0:1].expand(s - 1, 3, 4), proj[1:]], dim=1)  # [S-1, 2, 3, 4]
    pair_obs = torch.stack([tracks[0:1].expand_as(tracks[1:]), tracks[1:]], dim=1)
    pts = triangulate_tracks(pair_proj, pair_obs, torch.stack([m, m], dim=1))  # [S-1, N, 3]
    # cheirality: z > 0 in both cameras
    cam0 = pts @ r[0] + t[0]
    cami = pts @ r[1:] + t[1:, None, :]
    cheir = (cam0[..., 2] > 0) & (cami[..., 2] > 0)
    # the pair's reprojection error
    err0 = torch.linalg.norm(to_pixels(cam0, k) - tracks[0], dim=-1)
    erri = torch.linalg.norm(to_pixels(cami, k) - tracks[1:], dim=-1)
    reproj_ok = (err0 < max_reproj_error) & (erri < max_reproj_error)
    ang = _tri_angle_deg(torch.sum((pts - centers[0]) ** 2, -1),
                         torch.sum((pts - centers[1:, None, :]) ** 2, -1),
                         torch.sum((centers[1:] - centers[0]) ** 2, -1)[:, None])
    inl = cheir & reproj_ok & (ang >= min_tri_angle) & (m > 0.5)
    return pts, inl, ang


class InitBAResult(NamedTuple):
    state: BAState  # every camera (only the init pair refined)
    points: torch.Tensor  # [N, 3] the init cloud (pair-triangulated, BA-refined)
    point_valid: torch.Tensor  # [N] the init pair's inlier mask
    init_idx: torch.Tensor  # [] the partner frame chosen


def _put(x: torch.Tensor, i: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """x with row i (a 0-d tensor) replaced by value, on the device."""
    rows = torch.arange(x.shape[0], device=x.device) == i
    return where(rows, value.expand_as(x), x)


def init_ba(q: torch.Tensor, t: torch.Tensor, k: torch.Tensor, tracks: torch.Tensor,
            vis: torch.Tensor, ba_iters: int = 15,
            init_max_reproj_error: float = 4.0) -> InitBAResult:
    """init_BA (triangulation.py:138-257): pick frame 0's best partner,
    bundle-adjust only that pair and its inlier points, write the refined
    pose back into the full state.

    The pair's score is angle-weighted, the sum over its inliers of
    min(angle, 10 deg): the reference's raw inlier count degenerates to
    "first frame wins" when every pair passes the angle gate, and can seed
    the scene from a near-minimal baseline."""
    pts_pair, inlier, angles = triangulate_by_pair(q, t, k, tracks, vis,
                                                   max_reproj_error=init_max_reproj_error)
    score = torch.sum(torch.where(inlier, angles.clamp(max=10.0), torch.zeros_like(angles)), -1)
    init_rel = score.argmax()  # 0..S-2
    init_idx = init_rel + 1
    points = take(pts_pair, init_rel)
    point_valid = take(inlier, init_rel)
    pair = torch.stack([torch.zeros_like(init_idx), init_idx])
    pair_mask = torch.stack([point_valid, point_valid]).to(tracks.dtype)
    state, _ = bundle_adjust(q.index_select(0, pair), t.index_select(0, pair), points,
                             tracks.index_select(0, pair), pair_mask, k, iters=ba_iters,
                             huber_delta=init_max_reproj_error)
    return InitBAResult(
        state=BAState(q=_put(q, init_idx, state.q[1]), t=_put(t, init_idx, state.t[1]),
                      points=state.points),
        points=state.points, point_valid=point_valid, init_idx=init_idx)


def refine_poses(q: torch.Tensor, t: torch.Tensor, k: torch.Tensor, points: torch.Tensor,
                 point_valid: torch.Tensor, tracks: torch.Tensor, vis: torch.Tensor,
                 max_reproj_error: float = 12.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """refine_pose (triangulation.py:260-380): every camera's absolute pose
    re-estimated against the current cloud (PnP and LM), the new pose kept
    only where it loses no reprojection inlier."""
    s = q.shape[0]

    def inlier_count(qq, tt):
        cam = torch.einsum("nj,sji->sni", points, quat_to_matrix(qq)) + tt[:, None, :]
        err = torch.linalg.norm(to_pixels(cam, k) - tracks, dim=-1)
        return ((err < max_reproj_error) & (cam[..., 2] > 0) & (vis > 0.5)).sum(-1)

    w_base = (vis > 0.5) & point_valid
    # soft inlier selection against the current pose; where that starves
    # the gate (< 6 points), the triangulation inliers, from which the
    # reference's pycolmap absolute-pose RANSAC re-estimates
    # (triangulation.py:314-330)
    err = torch.linalg.norm(project_points(points, q, t, k) - tracks, dim=-1)
    w_err = w_base & (err < max_reproj_error)
    w = torch.where((w_err.sum(-1) >= 6)[:, None], w_err, w_base)
    res = _solve_pnp(points.expand(s, *points.shape), tracks, k.expand(s, 3, 3),
                     w.to(tracks.dtype), 10)
    # the PnP projects cam = R x + t; the scene's cam = x @ R + T takes R^T
    q_new = matrix_to_quat(res.r.transpose(-1, -2))
    better = inlier_count(q_new, res.t) >= inlier_count(q, t)
    return where(better, q_new, q), where(better, res.t, t)


def filter_points3d(points: torch.Tensor, tracks: torch.Tensor, q: torch.Tensor, t: torch.Tensor,
                    k: torch.Tensor, max_reproj_error: float = 4.0, min_tri_angle: float = 1.5,
                    check_triangle: bool = True,
                    hard_max: float = 300.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """filter_all_points3D (triangulation_helpers.py:133-300): a view is an
    inlier where the squared reprojection error is under the threshold and
    the point is in front of the camera; a point is valid with >= 2 inlier
    views, bounded coordinates and (optionally) an inlier pair subtending
    >= min_tri_angle. Returns (valid [N], inlier detail [S, N])."""
    r = quat_to_matrix(q)
    cam = torch.einsum("nj,sji->sni", points, r) + t[:, None, :]
    err2 = torch.sum((to_pixels(cam, k) - tracks) ** 2, -1)
    err2 = torch.where(cam[..., 2] > 0, err2, torch.full_like(err2, 1e6))
    inlier = err2 <= max_reproj_error ** 2  # [S, N]
    valid = inlier.sum(0) >= 2
    if hard_max > 0:
        valid = valid & (points.abs() <= hard_max).all(-1)
    if check_triangle:
        ang = triangulation_angles_deg(points, -torch.einsum("sj,sij->si", t, r))  # [S, S, N]
        pair_inl = inlier[:, None, :] & inlier[None, :, :]
        valid = valid & ((ang >= min_tri_angle) & pair_inl).any(1).any(0)
    return valid, inlier


class SceneReconstruction(NamedTuple):
    state: BAState
    valid_tracks: torch.Tensor  # [N]
    inlier_mask: torch.Tensor  # [S, N]
    rms: torch.Tensor


def reconstruct_scene(q0: torch.Tensor, t0: torch.Tensor, tracks: torch.Tensor, vis: torch.Tensor,
                      k: torch.Tensor, ba_iters: int = 15, ba_rounds: int = 2,
                      init_max_reproj_error: float = 4.0, refine_max_reproj_error: float = 12.0,
                      max_reproj_error: float = 4.0, min_tri_angle: float = 1.5,
                      min_valid_track_length: int = 3) -> SceneReconstruction:
    """The staged pipeline (Triangulator.forward's orchestration,
    comet/models/triangulator.py:30 and triangulation.py:138,260,1020,1076):

    1. init_BA: the best (frame 0, frame i) pair, triangulated, pair BA;
    2. refine_pose: per-camera PnP against the init cloud;
    3. global BA: every camera, all-view RANSAC re-triangulation;
    4. ba_rounds times: filter the points (reprojection, angle, track
       length), re-BA the survivors, re-triangulate.

    The reference runs these as four pycolmap sessions with host round
    trips between them; here the stages chain on the device."""
    init = init_ba(q0, t0, k, tracks, vis, ba_iters=ba_iters,
                   init_max_reproj_error=init_max_reproj_error)
    q, t = refine_poses(init.state.q, init.state.t, k, init.points, init.point_valid, tracks, vis,
                        max_reproj_error=refine_max_reproj_error)

    # full re-triangulation (LO-RANSAC over all view pairs) and BA on the
    # RANSAC inliers, not on raw visibility: gross outlier tracks would drag
    # the cameras even under a Huber kernel (iterative_global_BA:1102-1127)
    points, tri_inl = triangulate_tracks_ransac(projection_matrices(q, t, k), tracks, vis,
                                                threshold=refine_max_reproj_error)
    obs_mask = tri_inl & (vis > 0.5)
    # tracks need RANSAC support of min_valid_track_length views before the
    # first global BA (triangulator.py:390): two views are always consistent
    # with their own pair triangulation
    obs_mask = obs_mask & (obs_mask.sum(0) >= min_valid_track_length)[None, :]
    # the filter and robust threshold anneal from the incremental stage's
    # tolerance down to max_reproj_error
    deltas = np.geomspace(refine_max_reproj_error, max_reproj_error, ba_rounds + 1)
    state, rms = bundle_adjust(q, t, points, tracks, obs_mask, k, iters=ba_iters,
                               huber_delta=float(deltas[0]))
    q, t, points = state

    valid = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    for rnd in range(ba_rounds):
        valid, inlier = filter_points3d(points, tracks, q, t, k,
                                        max_reproj_error=float(deltas[rnd + 1]),
                                        min_tri_angle=min_tri_angle)
        valid = valid & ((inlier & (vis > 0.5)).sum(0) >= min_valid_track_length)
        obs_mask = inlier & (vis > 0.5) & valid[None, :]
        state, rms = bundle_adjust(q, t, points, tracks, obs_mask, k, iters=ba_iters,
                                   huber_delta=float(deltas[rnd + 1]))
        q, t, points = state
        if rnd + 1 < ba_rounds:
            new_pts, _ = triangulate_tracks_ransac(projection_matrices(q, t, k), tracks, vis,
                                                   threshold=float(deltas[rnd + 1]))
            # surviving tracks keep their BA-optimized coordinates
            # (iterative_global_BA:1110)
            points = where(valid, points, new_pts)
    return SceneReconstruction(state=BAState(q=q, t=t, points=points), valid_tracks=valid,
                               inlier_mask=obs_mask, rms=rms)
