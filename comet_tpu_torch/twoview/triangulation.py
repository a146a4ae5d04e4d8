"""Multi-view triangulation and dense Levenberg-Marquardt bundle adjustment.

Counterpart of ``comet_tpu/twoview/triangulation.py`` (the reference's
pycolmap BA stack, comet/utils/triangulation.py:45,138,260,677,1020,1076
and comet/models/triangulator.py:30): DLT triangulation over all views as
one batched SVD, LO-RANSAC triangulation over every view pair, and a dense
LM bundle adjuster. At COMET's sizes (S <= 16 cameras, N <= 512 points) the
dense normal equations fit on the card, and each LM step's accept or
reject stays a ``torch.where``, so an adjustment reads nothing back to the
host.

Rotations are wxyz quaternions, renormalized at every step; cameras follow
the row-vector convention x_cam = x_world @ R + T.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry.quaternions import quat_normalize, quat_to_matrix
from .estimators import dehomogenize, null_vector, take, triangulate_point, where


def _dlt(proj: torch.Tensor, pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """All-view DLT of points: proj [..., V, 3, 4], pts [..., V, 2], view
    weights w [..., V] -> [..., 3]. Each view gives the rows x P_3 - P_1 and
    y P_3 - P_2 (all x rows first); the point is the right singular vector
    of the smallest singular value."""
    rows_x = pts[..., 0:1] * proj[..., 2, :] - proj[..., 0, :]
    rows_y = pts[..., 1:2] * proj[..., 2, :] - proj[..., 1, :]
    a = torch.cat([rows_x, rows_y], dim=-2)
    w = w.to(a.dtype)
    return dehomogenize(null_vector(a * torch.cat([w, w], dim=-1)[..., None]))


def triangulate_multiview(proj: torch.Tensor, pts2d: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """All-view DLT triangulation of one point (triangulation.py:677):
    proj [S, 3, 4], pts2d [S, 2], mask [S] -> [3]."""
    return _dlt(proj, pts2d.to(proj.dtype), mask)


def triangulate_tracks(proj: torch.Tensor, pts2d: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """DLT triangulation of N tracks as one batched SVD: proj [..., S, 3,
    4], pts2d [..., S, N, 2], mask [..., S, N] -> points [..., N, 3]."""
    return _dlt(proj[..., None, :, :, :], pts2d.transpose(-3, -2).to(proj.dtype),
                mask.transpose(-2, -1))


def projection_matrices(q: torch.Tensor, t: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[S, 3, 4] projection matrices from quaternions, translations and
    intrinsics: x_cam = x_world @ R + T makes the column-vector matrix
    K [R^T | T]."""
    ext = torch.cat([quat_to_matrix(q).transpose(-1, -2), t[..., None]], dim=-1)
    return torch.einsum("ij,sjk->sik", k, ext)


def to_pixels(cam: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixel coordinates [..., 2] through K."""
    pix = torch.einsum("ij,...j->...i", k, cam)
    z = pix[..., 2:]
    return pix[..., :2] / z.abs().clamp_min(1e-8) * torch.sign(z)


def project_points(points: torch.Tensor, q: torch.Tensor, t: torch.Tensor,
                   k: torch.Tensor) -> torch.Tensor:
    """points [N, 3], cameras [S] -> pixel coordinates [S, N, 2]."""
    return to_pixels(torch.einsum("nj,sji->sni", points, quat_to_matrix(q)) + t[:, None, :], k)


class BAState(NamedTuple):
    q: torch.Tensor  # [S, 4]
    t: torch.Tensor  # [S, 3]
    points: torch.Tensor  # [N, 3]


def reprojection_residuals(state: BAState, obs: torch.Tensor, mask: torch.Tensor,
                           k: torch.Tensor) -> torch.Tensor:
    """The masked residual vector [S * N * 2]."""
    pred = project_points(state.points, state.q, state.t, k)
    return ((pred - obs) * mask[..., None]).reshape(-1)


def bundle_adjust(q0: torch.Tensor, t0: torch.Tensor, points0: torch.Tensor, obs: torch.Tensor,
                  mask: torch.Tensor, k: torch.Tensor, iters: int = 20,
                  damping_init: float = 1e-3, fix_first_camera: bool = True,
                  huber_delta: Optional[float] = None) -> Tuple[BAState, torch.Tensor]:
    """Dense Levenberg-Marquardt over every camera and point parameter
    (the capability of the reference's pycolmap global_BA,
    triangulation.py:1020): S poses and N points refined jointly under
    reprojection error, obs [S, N, 2], mask [S, N]. Dense J^T J with
    adaptive damping; the Jacobian by ``torch.func.jacfwd``. With
    huber_delta set, each step reweights the residuals IRLS-style with the
    Huber influence (hard pre-masking instead can disconnect a badly
    initialized camera). Camera 0 is held fixed (the gauge) unless
    fix_first_camera is False. Returns (refined state, final rms)."""
    mask = mask.to(obs.dtype)
    s = q0.shape[0]
    n_pts = points0.shape[0]

    def unpack(vec: torch.Tensor) -> BAState:
        q = vec[:s * 4].reshape(s, 4)
        t = vec[s * 4:s * 7].reshape(s, 3)
        return BAState(q=quat_normalize(q), t=t, points=vec[s * 7:].reshape(n_pts, 3))

    def residual_fn(vec: torch.Tensor) -> torch.Tensor:
        return reprojection_residuals(unpack(vec), obs, mask, k)

    x = torch.cat([q0.reshape(-1), t0.reshape(-1), points0.reshape(-1)])
    free = torch.ones_like(x)
    if fix_first_camera:  # gauge: freeze camera 0's quaternion and translation
        free[:4] = 0.0
        free[s * 4:s * 4 + 3] = 0.0

    def robust_w(r: torch.Tensor) -> torch.Tensor:
        if huber_delta is None:
            return torch.ones_like(r)
        # the square root of the Huber IRLS weight min(1, delta / |r|)
        return torch.sqrt(torch.clamp(huber_delta / r.abs().clamp_min(1e-8), max=1.0))

    jacobian = torch.func.jacfwd(residual_fn)
    lam = torch.full((), damping_init, dtype=obs.dtype, device=obs.device)
    floor = torch.full((), 1e-8, dtype=obs.dtype, device=obs.device)
    for _ in range(iters):
        r = residual_fn(x)
        w = robust_w(r.detach())
        jac = jacobian(x) * free[None, :] * w[:, None]  # [M, P] dense
        rw = r * w
        jtj = jac.T @ jac
        a = jtj + lam * torch.diag(torch.maximum(torch.diag(jtj), floor))
        delta = torch.linalg.solve_ex(a, -(jac.T @ rw)[:, None])[0][:, 0]
        x_new = x + delta * free
        r_new = residual_fn(x_new)
        improved = torch.sum((robust_w(r_new) * r_new) ** 2) < torch.sum(rw ** 2)
        x = torch.where(improved, x_new, x)
        lam = torch.where(improved, lam * 0.5, lam * 4.0)
    n_obs = (mask.sum() * 2).clamp_min(1.0)
    rms = torch.sqrt(torch.sum(residual_fn(x) ** 2) / n_obs)
    return unpack(x), rms


def triangulate_and_refine(q: torch.Tensor, t: torch.Tensor, tracks: torch.Tensor,
                           vis: torch.Tensor, k: torch.Tensor,
                           ba_iters: int = 15) -> Tuple[BAState, torch.Tensor]:
    """init_BA-style pipeline (triangulation.py:138): DLT-triangulate every
    track from the given poses, then refine points and poses jointly."""
    points = triangulate_tracks(projection_matrices(q, t, k), tracks, vis)
    return bundle_adjust(q, t, points, tracks, vis, k, iters=ba_iters)


def _triangulate_from_pair(proj: torch.Tensor, pts2d: torch.Tensor, i: torch.Tensor,
                           j: torch.Tensor) -> torch.Tensor:
    """DLT triangulation from views (i, j): proj [S, 3, 4], pts2d [..., S,
    2], i and j index tensors [P] -> [..., P, 3]."""
    return triangulate_point(proj[i], proj[j], pts2d[..., i, :], pts2d[..., j, :])


def _reprojection_errors(proj: torch.Tensor, x: torch.Tensor, pts2d: torch.Tensor) -> torch.Tensor:
    """Pixel errors of points x [N, ..., 3] in every view, [N, ..., S], inf
    where the point is behind the camera: proj [S, 3, 4], pts2d [N, S, 2]."""
    ph = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    pix = torch.einsum("sij,...j->...si", proj, ph)
    z = pix[..., 2:]
    uv = pix[..., :2] / torch.where(z.abs() > 1e-8, z, torch.full_like(z, 1e-8))
    obs = pts2d.reshape(pts2d.shape[0], *([1] * (x.ndim - 2)), *pts2d.shape[1:])
    err = torch.linalg.norm(uv - obs, dim=-1)
    # a point behind a camera never counts as an inlier there
    return torch.where(z[..., 0] > 0, err, torch.full_like(err, torch.inf))


def triangulate_tracks_ransac(proj: torch.Tensor, tracks: torch.Tensor, vis: torch.Tensor,
                              threshold: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """LO-RANSAC triangulation (comet/utils/triangulation.py:677,776): every
    track hypothesizes a 3-D point from each view pair (S <= 16: at most
    120), scored by the views whose reprojection error is under
    ``threshold``; the best is refit by an all-inlier-view DLT, kept where
    it loses no inlier. proj [S, 3, 4], tracks [S, N, 2], vis [S, N].
    Returns (points [N, 3], inlier mask [S, N])."""
    s = proj.shape[0]
    ii, jj = torch.triu_indices(s, s, offset=1, device=proj.device)
    pts2d = tracks.transpose(0, 1)  # [N, S, 2]
    m = vis.to(tracks.dtype).transpose(0, 1)  # [N, S]
    xs = _triangulate_from_pair(proj, pts2d, ii, jj)  # [N, P, 3]
    pair_valid = m[:, ii] * m[:, jj]  # a hypothesis needs both its views
    seen = m > 0.5
    inl = (_reprojection_errors(proj, xs, pts2d) < threshold) & seen[:, None, :]  # [N, P, S]
    scores = inl.sum(-1) * pair_valid.to(torch.int64)
    best = scores.argmax(dim=-1)  # [N]
    best_inl = take(inl, best)  # [N, S]
    x_refit = _dlt(proj, pts2d, best_inl)
    refit_inl = (_reprojection_errors(proj, x_refit, pts2d) < threshold) & seen
    better = refit_inl.sum(-1) >= take(scores, best)
    pts = where(better, x_refit, take(xs, best))
    return pts, where(better, refit_inl, best_inl).transpose(0, 1)


def global_bundle_adjust(q0: torch.Tensor, t0: torch.Tensor, tracks: torch.Tensor,
                         vis: torch.Tensor, k: torch.Tensor, rounds: int = 2, ba_iters: int = 15,
                         init_threshold: float = 8.0, filter_threshold: float = 2.0
                         ) -> Tuple[BAState, torch.Tensor, torch.Tensor]:
    """Scene-level iterative BA (the reference's pycolmap global_BA /
    iterative_global_BA, comet/utils/triangulation.py:1020,1076):
    RANSAC-triangulate, bundle adjust, filter observations by reprojection
    error, re-triangulate, repeat, with the inlier threshold annealed
    geometrically from init_threshold down to filter_threshold. Returns
    (state, observation inlier mask [S, N], final rms)."""
    thresholds = np.geomspace(init_threshold, filter_threshold, rounds + 1)
    points, _ = triangulate_tracks_ransac(projection_matrices(q0, t0, k), tracks, vis,
                                          float(thresholds[0]))
    q, t = q0, t0
    rms = torch.full((), torch.inf, dtype=tracks.dtype, device=tracks.device)
    # the first BA sees every visible observation: the Huber kernel
    # downweights outliers softly
    obs_mask = vis > 0.5
    for r in range(rounds):
        state, rms = bundle_adjust(q, t, points, tracks, obs_mask, k, iters=ba_iters,
                                   huber_delta=float(thresholds[r]))
        q, t, points = state
        err = torch.linalg.norm(project_points(points, q, t, k) - tracks, dim=-1)
        obs_mask = (err < float(thresholds[r + 1])) & (vis > 0.5)
        points = triangulate_tracks(projection_matrices(q, t, k), tracks,
                                    obs_mask.to(tracks.dtype))
    return BAState(q=q, t=t, points=points), obs_mask, rms
