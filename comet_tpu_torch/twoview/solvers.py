"""Minimal solvers: the 5-point essential, EPnP, homography decomposition.

Counterpart of ``comet_tpu/twoview/solvers.py``:

- ``run_5point`` / ``estimate_essential_5point_ransac``: the Nistér
  5-point solver (comet/two_view_geo/essential.py:111,203). The 10 x 20
  constraint system is built by evaluation and interpolation (each
  constraint's 20 monomial coefficients from its values at 20 fixed points
  against a precomputed Vandermonde inverse); the solutions come from the
  Stewénius action matrix, its eigenvalues by a fixed number of shifted-QR
  steps, its eigenvectors as smallest singular vectors, each polished by
  Gauss-Newton. Candidates from complex eigenpairs are scored out by the
  Sampson scoring downstream.
- ``efficient_pnp``: EPnP with the N = 1, 2, 3 beta cases and Procrustes
  (comet/two_view_geo/perspective_n_points.py:321).
- ``decompose_homography``: H -> 4 (R, t, n) candidates by the SVD
  (Faugeras-Lustman) construction, with the cheirality pick
  (comet/two_view_geo/homography.py:246).

Every function takes leading batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import estimators
from .align import corresponding_points_alignment
from .estimators import (
    RansacResult,
    cheirality_count,
    gather_points,
    motion_from_essential,
    normalized_coords,
    project_to_essential,
    run_8point,
    sampson_distance,
    take,
    to_homogeneous,
)

# 5-point essential (Nistér / Stewénius)

# the cubic monomial basis in (x, y, z): the 10 degree-3 monomials, then the
# 10 of lower degree that form the quotient-ring basis
_DEG3 = [
    (3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1),
    (1, 0, 2), (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3),
]
_BASIS = [
    (2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1),
    (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]
_MONOS = _DEG3 + _BASIS


def _vandermonde_inv() -> Tuple[np.ndarray, np.ndarray]:
    """inv(V)^T for the 20 evaluation points, and the points (host, float64)."""
    rng = np.random.default_rng(12345)
    pts = rng.normal(size=(20, 3))
    v = np.stack([np.prod(pts ** np.asarray(m, np.float64), axis=1) for m in _MONOS], axis=1)
    return np.linalg.inv(v).T.astype(np.float64), pts.astype(np.float64)


_VINV_T, _EVAL_PTS = _vandermonde_inv()
_CONSTANTS = {}


def _constants(dtype: torch.dtype, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The evaluation points and inv(V)^T on ``device``, copied there once."""
    key = (dtype, device)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = (torch.as_tensor(_EVAL_PTS, dtype=dtype, device=device),
                           torch.as_tensor(_VINV_T, dtype=dtype, device=device))
    return _CONSTANTS[key]


def _constraints_at(basis: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The 10 cubic constraints at (x, y, z) = p: basis [..., 4, 3, 3] (X, Y,
    Z, W), p [..., 3] -> [..., 10]: det(E), then 2 E E^T E - tr(E E^T) E."""
    x, y, z = p[..., 0, None, None], p[..., 1, None, None], p[..., 2, None, None]
    e = x * basis[..., 0, :, :] + y * basis[..., 1, :, :] + z * basis[..., 2, :, :] \
        + basis[..., 3, :, :]
    det = torch.linalg.det(e)
    eet = e @ e.transpose(-1, -2)
    trace = eet.diagonal(dim1=-2, dim2=-1).sum(-1)
    g = 2.0 * (eet @ e) - trace[..., None, None] * e
    return torch.cat([det[..., None], g.reshape(*g.shape[:-2], 9)], dim=-1)


def _action_matrix(basis: torch.Tensor) -> torch.Tensor:
    """The Stewénius 10 x 10 action matrix of multiplication by x."""
    dt, dev = basis.dtype, basis.device
    pts, vinv_t = _constants(dt, dev)
    g = _constraints_at(basis[..., None, :, :, :], pts)  # [..., 20 points, 10]
    c = g.transpose(-1, -2) @ vinv_t  # [..., 10, 20]
    a = c[..., :10]  # the degree-3 block
    b = c[..., 10:]  # the basis block
    m = -torch.linalg.solve_ex(a, b)[0]  # deg3_i = m[i] . basis
    # multiplication by x maps the basis monomials:
    #   x*x^2=x^3(0)  x*xy=x^2y(1)  x*y^2=xy^2(3)  x*xz=x^2z(2)  x*yz=xyz(4)
    #   x*z^2=xz^2(5) x*x=x^2(b0)   x*y=xy(b1)     x*z=xz(b3)    x*1=x(b6)
    e = torch.eye(10, dtype=dt, device=dev).expand(*m.shape[:-2], 10, 10)
    rows = [m[..., i, :] for i in (0, 1, 3, 2, 4, 5)] + [e[..., i, :] for i in (0, 1, 3, 6)]
    return torch.stack(rows, dim=-2)


def _qr_eigvals(t: torch.Tensor, iters: int = 120) -> torch.Tensor:
    """Real-eigenvalue candidates of nonsymmetric matrices [..., n, n] by
    shifted QR. Complex pairs do not converge; their diagonal entries are
    returned too, for the scoring downstream to filter."""
    n = t.shape[-1]
    eye = torch.eye(n, dtype=t.dtype, device=t.device)
    for _ in range(iters):
        mu = t[..., n - 1, n - 1, None, None] * eye
        q, r = torch.linalg.qr(t - mu)
        t = r @ q + mu
    return t.diagonal(dim1=-2, dim2=-1)


def _constraint_jacobian(basis: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """d constraints / d p: basis [B, 4, 3, 3], p [B, 3] -> [B, 10, 3]."""
    return torch.func.vmap(torch.func.jacfwd(_constraints_at, argnums=1))(basis, p)


def _polish(basis: torch.Tensor, p: torch.Tensor, steps: int = 10) -> torch.Tensor:
    """Gauss-Newton on the 10 constraint polynomials, basis [B, 4, 3, 3],
    p [B, 3]: it rescues f32 round-off in the action matrix and the crude
    shifted-QR eigenvalues (a complex-pair candidate converges to a real
    solution or diverges and is scored out downstream)."""
    reg = 1e-8 * torch.eye(3, dtype=p.dtype, device=p.device)
    for _ in range(steps):
        g = _constraints_at(basis, p)
        j = _constraint_jacobian(basis, p)
        jt = j.transpose(-1, -2)
        p = p - torch.linalg.solve_ex(jt @ j + reg, (jt @ g[..., None]))[0][..., 0]
    return p


def run_5point(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """5-point essential solver on normalized image coordinates:
    [..., 5, 2] -> [..., 10, 3, 3] candidate essential matrices, unit
    Frobenius norm (non-real solutions padded; score downstream)."""
    batch = pts1.shape[:-2]
    x1 = to_homogeneous(pts1)
    x2 = to_homogeneous(pts2)
    q = torch.einsum("...ni,...nj->...nij", x2, x1).reshape(*batch, 5, 9)  # x2^T E x1 = 0
    vt = torch.linalg.svd(q, full_matrices=True).Vh
    basis = vt[..., 5:9, :].reshape(*batch, 4, 3, 3)  # X, Y, Z, W (W: the smallest)
    t = _action_matrix(basis)
    xs = _qr_eigvals(t)  # [..., 10] candidate x values
    # eigenvector of T - x I: its smallest right singular vector
    eye = torch.eye(10, dtype=t.dtype, device=t.device)
    v = torch.linalg.svd(t[..., None, :, :] - xs[..., None, None] * eye).Vh[..., -1, :]
    v9 = v[..., 9:]
    p = v[..., 6:9] / torch.where(v9.abs() > 1e-12, v9, torch.full_like(v9, 1e-12))
    basis10 = basis[..., None, :, :, :].expand(*batch, 10, 4, 3, 3)
    p = _polish(basis10.reshape(-1, 4, 3, 3), p.reshape(-1, 3)).reshape(*batch, 10, 3)
    e = (p[..., 0, None, None] * basis10[..., 0, :, :] + p[..., 1, None, None] * basis10[..., 1, :, :]
         + p[..., 2, None, None] * basis10[..., 2, :, :] + basis10[..., 3, :, :])
    norm = torch.linalg.norm(e, dim=(-2, -1), keepdim=True)
    return e / torch.where(norm > 1e-12, norm, torch.ones_like(norm))


def estimate_essential_5point_ransac(pts1: torch.Tensor, pts2: torch.Tensor, k1: torch.Tensor,
                                     k2: torch.Tensor, generator: Optional[torch.Generator] = None,
                                     threshold: float = 1e-3, num_hypotheses: int = 64
                                     ) -> Tuple[RansacResult, torch.Tensor, torch.Tensor]:
    """Nistér 5-point RANSAC on normalized coordinates (essential.py:111,203
    capability), with the inlier-weighted 8-point refit projected onto the
    essential manifold (the reference's LO step, two_view_geo/utils.py:325).
    Returns (result, R, t)."""
    generator = estimators.default_generator(generator, pts1.device)
    n1 = normalized_coords(pts1, k1)
    n2 = normalized_coords(pts2, k2)
    idx = estimators.ransac_samples(n1.shape[0], num_hypotheses, 5, generator, n1.device)
    models = run_5point(gather_points(n1, idx), gather_points(n2, idx)).reshape(-1, 3, 3)
    inliers = sampson_distance(models, n1, n2) < threshold
    scores = inliers.sum(dim=-1)
    best = scores.argmax()
    e = take(models, best)
    best_inl = take(inliers, best)
    best_score = take(scores, best)

    e_refit = project_to_essential(run_8point(n1, n2, weights=best_inl.to(n1.dtype)))
    inl_r = sampson_distance(e_refit, n1, n2) < threshold
    better = inl_r.sum() >= best_score
    e = torch.where(better, e_refit, e)
    best_inl = torch.where(better, inl_r, best_inl)
    best_score = torch.maximum(inl_r.sum(), best_score)
    r, t = motion_from_essential(e, n1, n2)
    return RansacResult(model=e, inliers=best_inl, score=best_score), r, t


# EPnP


class PnPSolution(NamedTuple):
    r: torch.Tensor  # [3, 3]
    t: torch.Tensor  # [3]
    err: torch.Tensor  # mean squared reprojection error (normalized coords)


def _control_points(points3d: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """4 control points: the weighted centroid and the principal directions."""
    wsum = weights.sum().clamp_min(1e-8)
    c0 = (points3d * weights[:, None]).sum(0) / wsum
    centered = (points3d - c0) * torch.sqrt(weights)[:, None]
    _, s, vt = torch.linalg.svd(centered, full_matrices=False)
    scale = s / torch.sqrt(wsum)
    dirs = vt * scale.clamp_min(1e-6)[:, None]  # [3, 3]
    return torch.cat([c0[None], c0[None] + dirs], dim=0)  # [4, 3]


def _barycentric(points3d: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """alphas [N, 4] with X_i = sum_j a_ij C_j, sum_j a_ij = 1."""
    d = (ctrl[1:] - ctrl[0]).T  # [3, 3]
    rel = torch.linalg.solve_ex(d, (points3d - ctrl[0]).T)[0].T  # [N, 3]
    return torch.cat([1.0 - rel.sum(-1, keepdim=True), rel], dim=-1)


_PAIRS = [(i, j) for i in range(4) for j in range(i + 1, 4)]


def _pair_diffs(x: torch.Tensor) -> torch.Tensor:
    """x[i] - x[j] over the 6 pairs i < j of 4 rows -> [6, ...]."""
    return torch.stack([x[i] - x[j] for i, j in _PAIRS])


def _pairwise_dist(ctrl: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(_pair_diffs(ctrl), dim=-1)


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The least-norm least-squares solution through the SVD, singular
    values below eps * max(m, n) of the largest dropped (numpy's and JAX's
    ``lstsq``; ``torch.linalg.lstsq`` on CUDA assumes full rank)."""
    m, n = a.shape[-2:]
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * max(m, n)
    mask = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)), torch.zeros_like(s))
    return vt.transpose(-1, -2) @ (s_inv[..., None] * (u.transpose(-1, -2) @ b))


def _pose_from_ctrl_cam(ctrl_w, ctrl_c, alphas, points3d, points2d, weights) -> PnPSolution:
    """Procrustes world -> camera from the control points, the sign flipped
    where the camera-frame cloud lands behind the camera."""
    # depth positivity: the EPnP null-space vectors have an arbitrary sign
    pc = alphas @ ctrl_c  # [N, 3] camera-frame points
    sign = torch.sign(torch.sum(pc[:, 2] * weights))
    ctrl_c = ctrl_c * torch.where(sign == 0, torch.ones_like(sign), sign)
    # row convention: ctrl_c ~ ctrl_w @ R_row + t, so Xc = R_row^T Xw + t
    sim = corresponding_points_alignment(ctrl_w, ctrl_c, estimate_scale=False)
    proj = points3d @ sim.r + sim.t
    uv = proj[:, :2] / proj[:, 2:].clamp_min(1e-8)
    err = ((uv - points2d) ** 2).sum(-1)
    werr = (err * weights).sum() / weights.sum().clamp_min(1e-8)
    return PnPSolution(r=sim.r.T, t=sim.t, err=werr)


def efficient_pnp(points3d: torch.Tensor, points2d: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> PnPSolution:
    """EPnP (perspective_n_points.py:321): points3d [N, 3] in the world,
    points2d [N, 2] in normalized image coordinates (K removed). The
    control-point parameterization, the null-space beta cases N = 1, 2, 3,
    Procrustes; the case of least reprojection error."""
    n = points3d.shape[0]
    weights = torch.ones(n, dtype=points3d.dtype, device=points3d.device) if weights is None \
        else weights
    ctrl_w = _control_points(points3d, weights)
    alphas = _barycentric(points3d, ctrl_w)  # [N, 4]

    u, v = points2d[:, 0], points2d[:, 1]
    zeros = torch.zeros_like(alphas)
    # M's rows under normalized intrinsics (fx = fy = 1, cx = cy = 0)
    rx = torch.stack([alphas, zeros, -alphas * u[:, None]], dim=-1)  # [N, 4, 3]
    ry = torch.stack([zeros, alphas, -alphas * v[:, None]], dim=-1)
    m = torch.cat([rx, ry], dim=0).reshape(2 * n, 12)
    mw = m * torch.sqrt(torch.cat([weights, weights]))[:, None]
    vt = torch.linalg.svd(mw, full_matrices=False).Vh
    nullv = vt[-4:].flip(0).reshape(4, 4, 3)  # v1 (smallest singular value) first

    dist_w = _pairwise_dist(ctrl_w)  # [6]
    dv = [_pair_diffs(nullv[k]) for k in range(3)]  # [6, 3] each

    def case1():
        dd = torch.linalg.norm(dv[0], dim=-1)
        beta = (dd * dist_w).sum() / (dd * dd).sum().clamp_min(1e-12)
        return beta * nullv[0]

    def case2():
        # ||b1 dv1 + b2 dv2||^2 = d^2 in the unknowns (b1^2, b1 b2, b2^2)
        a = torch.stack([(dv[0] * dv[0]).sum(-1), 2 * (dv[0] * dv[1]).sum(-1),
                         (dv[1] * dv[1]).sum(-1)], dim=-1)  # [6, 3]
        sol = _lstsq(a, (dist_w ** 2)[:, None])[:, 0]
        b1 = torch.sqrt(sol[0].abs())
        b2 = torch.sqrt(sol[2].abs()) * torch.sign(sol[1]) * torch.sign(sol[0])
        return b1 * nullv[0] + b2 * nullv[1]

    def case3():
        # unknowns (b1^2, b1 b2, b2^2, b1 b3, b2 b3, b3^2)
        a = torch.stack([(dv[0] * dv[0]).sum(-1), 2 * (dv[0] * dv[1]).sum(-1),
                         (dv[1] * dv[1]).sum(-1), 2 * (dv[0] * dv[2]).sum(-1),
                         2 * (dv[1] * dv[2]).sum(-1), (dv[2] * dv[2]).sum(-1)], dim=-1)  # [6, 6]
        sol = _lstsq(a, (dist_w ** 2)[:, None])[:, 0]
        b1 = torch.sqrt(sol[0].abs())
        b2 = torch.sqrt(sol[2].abs()) * torch.sign(sol[1]) * torch.sign(sol[0])
        b3 = torch.sqrt(sol[5].abs()) * torch.sign(sol[3]) * torch.sign(sol[0])
        return b1 * nullv[0] + b2 * nullv[1] + b3 * nullv[2]

    sols = [_pose_from_ctrl_cam(ctrl_w, ctrl_c, alphas, points3d, points2d, weights)
            for ctrl_c in (case1(), case2(), case3())]
    errs = torch.stack([s.err for s in sols])
    best = errs.argmin()
    return PnPSolution(r=take(torch.stack([s.r for s in sols]), best),
                       t=take(torch.stack([s.t for s in sols]), best), err=take(errs, best))


# homography decomposition


def decompose_homography(h: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """H -> 4 candidates (R [4, 3, 3], t [4, 3], n [4, 3]) by the SVD
    (Faugeras-Lustman) construction (homography.py:246 capability). t is
    scaled by the inverse plane distance; select_homography_motion picks by
    cheirality."""
    hn = torch.linalg.inv_ex(k2)[0] @ h @ k1
    s = torch.linalg.svdvals(hn)
    hn = hn / s[1]
    hn = hn * torch.sign(torch.linalg.det(hn))
    _, s2, vt = torch.linalg.svd(hn.T @ hn)
    v = vt.T
    s1sq, s3sq = s2[0], s2[2]
    denom = torch.sqrt((s1sq - s3sq).clamp_min(1e-12))
    a = torch.sqrt((1.0 - s3sq).clamp_min(0.0)) / denom
    b = torch.sqrt((s1sq - 1.0).clamp_min(0.0)) / denom
    v1, v2, v3 = v[:, 0], v[:, 1], v[:, 2]

    def motion(u):
        w = torch.stack([v2, u, torch.linalg.cross(v2, u)], dim=1)
        hu = torch.stack([hn @ v2, hn @ u, torch.linalg.cross(hn @ v2, hn @ u)], dim=1)
        r = hu @ w.T
        nvec = torch.linalg.cross(v2, u)
        return r, (hn - r) @ nvec, nvec

    r1, t1, n1 = motion(a * v1 + b * v3)
    r2, t2, n2 = motion(a * v1 - b * v3)
    return (torch.stack([r1, r1, r2, r2]), torch.stack([t1, -t1, t2, -t2]),
            torch.stack([n1, -n1, n2, -n2]))


def select_homography_motion(rs: torch.Tensor, ts: torch.Tensor, ns: torch.Tensor,
                             pts1_norm: torch.Tensor, pts2_norm: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (R, t, n) candidate with the most points in front of both cameras."""
    best = cheirality_count(rs, ts, pts1_norm[None], pts2_norm[None]).argmax()
    return take(rs, best), take(ts, best), take(ns, best)
