"""Batched two-view geometry estimators: 8-, 7-point, homography and
essential RANSAC.

Counterpart of ``comet_tpu/twoview/estimators.py`` (the reference's
GPU-RANSAC side stack, comet/two_view_geo/: fundamental.py:43,254,341,
essential.py:111,203, homography.py:53,112, utils.py:90-415). Every solver
takes leading batch dimensions: RANSAC draws a fixed number of hypotheses,
solves them as one batched SVD, scores every hypothesis against every point
at once and keeps the first best, with no data-dependent control flow and
no host read.

Conventions: points are [..., N, 2] pixel or normalized coordinates;
epipolar maps act as x2^T F x1 = 0 (x1 in image 1, x2 in image 2).

Random draws: each RANSAC takes a ``torch.Generator`` (seeded 0 on the
inputs' device when none is given) and draws its samples through
``ransac_samples``, the one place that turns randomness into indices.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


def to_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, ...]`` with ``idx`` a tensor of x's leading batch shape:
    the entry of dimension ``idx.ndim`` that ``idx`` names, gathered on the
    device (indexing with a 0-d tensor would read it on the host)."""
    d = idx.ndim
    rest = x.shape[d + 1:]
    gather_idx = idx.reshape(*idx.shape, 1, *([1] * len(rest))).expand(*idx.shape, 1, *rest)
    return torch.gather(x, d, gather_idx).squeeze(d)


def where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.where`` with ``cond`` [...] broadcast over a's trailing
    dimensions (JAX's ``jnp.where`` on a vmapped scalar)."""
    return torch.where(cond.reshape(*cond.shape, *([1] * (a.ndim - cond.ndim))), a, b)


def ransac_samples(n: int, num_hypotheses: int, sample_size: int,
                   generator: torch.Generator, device: torch.device,
                   p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Indices [..., H, sample_size] of RANSAC minimal samples, each drawn
    without replacement from N points: uniformly (the top-k of uniform
    keys), or with probabilities ``p`` [..., N] (Gumbel top-k on log p, so a
    point of probability 0 is never drawn while enough others remain)."""
    batch = () if p is None else tuple(p.shape[:-1])
    u = torch.rand(*batch, num_hypotheses, n, generator=generator, device=device)
    if p is None:
        keys = u
    else:
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        keys = torch.log(p.to(u.dtype))[..., None, :] + gumbel
    return keys.topk(sample_size, dim=-1).indices


def default_generator(generator: Optional[torch.Generator],
                      device: torch.device) -> torch.Generator:
    return generator if generator is not None else torch.Generator(device=device).manual_seed(0)


def gather_points(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pts [..., N, D], idx [..., H, k] -> [..., H, k, D]."""
    batch = idx.shape[:-2]
    flat = idx.reshape(*batch, -1, 1).expand(*batch, idx.shape[-2] * idx.shape[-1], pts.shape[-1])
    return torch.gather(pts.expand(*batch, *pts.shape[-2:]), -2, flat).reshape(
        *idx.shape, pts.shape[-1])


def normalize_points(pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hartley normalization: zero mean, sqrt(2) RMS distance.

    Returns (normalized points, 3x3 transform T with x_norm = T @ x_h)."""
    mean = pts.mean(dim=-2, keepdim=True)
    d = torch.linalg.norm(pts - mean, dim=-1).mean(dim=-1)
    scale = math.sqrt(2.0) / d.clamp_min(1e-8)
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    t = torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0, 0]], dim=-1),
        torch.stack([zero, scale, -scale * mean[..., 0, 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    normed = (pts - mean) * scale[..., None, None]
    return normed, t


def sampson_distance(f: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """First-order (squared) epipolar distance (two_view_geo/utils.py:90):
    f [..., 3, 3] against pts [..., N, 2] -> [..., N]."""
    x1 = to_homogeneous(pts1)
    x2 = to_homogeneous(pts2)
    fx1 = torch.einsum("...ij,...nj->...ni", f, x1)
    ftx2 = torch.einsum("...ji,...nj->...ni", f, x2)
    num = torch.einsum("...ni,...ni->...n", x2, fx1) ** 2
    den = fx1[..., 0] ** 2 + fx1[..., 1] ** 2 + ftx2[..., 0] ** 2 + ftx2[..., 1] ** 2
    return num / den.clamp_min(1e-10)


def null_vector(a: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the smallest singular value."""
    return torch.linalg.svd(a, full_matrices=True).Vh[..., -1, :]


def _scale_by_last(m: torch.Tensor) -> torch.Tensor:
    """m / m[2, 2] where |m[2, 2]| > 1e-8."""
    m22 = m[..., 2:3, 2:3]
    return m / torch.where(m22.abs() > 1e-8, m22, torch.ones_like(m22))


def run_8point(pts1: torch.Tensor, pts2: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalized 8-point fundamental solve (fundamental.py:341):
    [..., N >= 8, 2] -> F [..., 3, 3] with the rank-2 constraint."""
    n1, t1 = normalize_points(pts1)
    n2, t2 = normalize_points(pts2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    a = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)],
                    dim=-1)
    if weights is not None:
        a = a * weights[..., None]
    f = null_vector(a).reshape(*a.shape[:-2], 3, 3)
    u, s, vt = torch.linalg.svd(f)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    f = (u * s[..., None, :]) @ vt
    f = t2.transpose(-1, -2) @ f @ t1
    return _scale_by_last(f)


def _cubic_roots(c: torch.Tensor) -> torch.Tensor:
    """The 3 complex roots of c0 t^3 + c1 t^2 + c2 t + c3 (c [..., 4]),
    in closed form (Cardano, in complex128), so that no eigenvalue solver
    runs on the host."""
    c = c.to(torch.complex128)
    a, b, cc, d = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    b, cc, d = b / a, cc / a, d / a
    p = cc - b * b / 3
    q = 2 * b ** 3 / 27 - b * cc / 3 + d
    disc = torch.sqrt(q * q / 4 + p ** 3 / 27)
    u3 = -q / 2 + disc
    u3 = torch.where(u3.abs() < (-q / 2 - disc).abs(), -q / 2 - disc, u3)
    u = torch.where(u3.abs() > 0, u3 ** (1 / 3), torch.zeros_like(u3))
    omega = complex(-0.5, math.sqrt(3) / 2)
    roots = []
    for k in range(3):
        uk = u * omega ** k
        vk = torch.where(uk.abs() > 0, -p / (3 * uk), torch.zeros_like(uk))
        roots.append(uk + vk - b / 3)
    return torch.stack(roots, dim=-1)


def run_7point(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """7-point fundamental solve (fundamental.py:254): [..., 7, 2] -> up to
    3 solutions [..., 3, 3, 3] (a complex root's slot holds the solution at
    the first root's real part)."""
    x1h = to_homogeneous(pts1)
    x2h = to_homogeneous(pts2)
    a = torch.einsum("...ni,...nj->...nij", x2h, x1h).reshape(*pts1.shape[:-2], 7, 9)
    vt = torch.linalg.svd(a, full_matrices=True).Vh
    f1 = vt[..., -1, :].reshape(*a.shape[:-2], 3, 3)
    f2 = vt[..., -2, :].reshape(*a.shape[:-2], 3, 3)
    # det(t F1 + (1 - t) F2) = 0 is a cubic in t: its coefficients by
    # interpolation at t = 0, 1, 2, 3
    vals = torch.stack([torch.linalg.det(t * f1 + (1 - t) * f2) for t in (0.0, 1.0, 2.0, 3.0)],
                       dim=-1)
    tt = torch.arange(4, dtype=vals.dtype, device=vals.device)
    vander = torch.stack([tt ** 3, tt ** 2, tt, torch.ones_like(tt)], dim=-1)
    coeffs = torch.linalg.solve_ex(vander, vals[..., None])[0][..., 0]
    roots = _cubic_roots(coeffs)
    real = torch.where(roots.imag.abs() < 1e-6, roots.real, roots.real[..., :1]).to(f1.dtype)
    r = real[..., None, None]
    return r * f1[..., None, :, :] + (1 - r) * f2[..., None, :, :]


def essential_from_fundamental(f: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """E = K2^T F K1 with the (1, 1, 0) singular-value constraint
    (essential.py:36-108)."""
    e = k2.transpose(-1, -2) @ f @ k1
    u, s, vt = torch.linalg.svd(e)
    mean = (s[..., 0] + s[..., 1]) / 2.0
    s_fixed = torch.stack([mean, mean, torch.zeros_like(mean)], dim=-1)
    return (u * s_fixed[..., None, :]) @ vt


def project_to_essential(m: torch.Tensor) -> torch.Tensor:
    """U diag(1, 1, 0) V^T of m's SVD."""
    u, _, vt = torch.linalg.svd(m)
    return u[..., :, :2] @ vt[..., :2, :]


def decompose_essential(e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """E [..., 3, 3] -> 4 candidate (R [..., 4, 3, 3], t [..., 4, 3])."""
    u, _, vt = torch.linalg.svd(e)
    u = u * torch.sign(torch.linalg.det(u))[..., None, None]
    vt = vt * torch.sign(torch.linalg.det(vt))[..., None, None]
    u0, u1, u2 = u[..., :, 0], u[..., :, 1], u[..., :, 2]
    r1 = torch.stack([u1, -u0, u2], dim=-1) @ vt  # U W V^T, W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    r2 = torch.stack([-u1, u0, u2], dim=-1) @ vt  # U W^T V^T
    t = u[..., :, 2]
    return torch.stack([r1, r1, r2, r2], dim=-3), torch.stack([t, -t, t, -t], dim=-2)


def dehomogenize(x: torch.Tensor) -> torch.Tensor:
    """x[..., :3] / x[..., 3], the divisor kept away from 0 (1e-10)."""
    h = x[..., 3:]
    return x[..., :3] / torch.where(h.abs() > 1e-10, h, torch.full_like(h, 1e-10))


def triangulate_point(p1: torch.Tensor, p2: torch.Tensor, x1: torch.Tensor,
                      x2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation from two 3x4 projections: p [..., 3, 4], x [..., 2]
    -> [..., 3]."""
    a = torch.stack([
        x1[..., 0:1] * p1[..., 2, :] - p1[..., 0, :],
        x1[..., 1:2] * p1[..., 2, :] - p1[..., 1, :],
        x2[..., 0:1] * p2[..., 2, :] - p2[..., 0, :],
        x2[..., 1:2] * p2[..., 2, :] - p2[..., 1, :],
    ], dim=-2)
    return dehomogenize(null_vector(a))


def triangulate_points(p1: torch.Tensor, p2: torch.Tensor, x1: torch.Tensor,
                       x2: torch.Tensor) -> torch.Tensor:
    """triangulate_point over N points: p [..., 3, 4], x [..., N, 2] ->
    [..., N, 3]."""
    return triangulate_point(p1[..., None, :, :], p2[..., None, :, :], x1, x2)


def cheirality_count(r: torch.Tensor, t: torch.Tensor, pts1: torch.Tensor,
                     pts2: torch.Tensor) -> torch.Tensor:
    """Number of points in front of both cameras for candidates (R [..., 3,
    3], t [..., 3]) (two_view_geo/utils.py cheirality check)."""
    eye = torch.eye(3, 4, dtype=r.dtype, device=r.device)
    p1 = eye.expand(*r.shape[:-2], 3, 4)
    p2 = torch.cat([r, t[..., None]], dim=-1)
    x = triangulate_points(p1, p2, pts1, pts2)  # [..., N, 3]
    z1 = x[..., 2]
    z2 = (torch.einsum("...ij,...nj->...ni", r, x) + t[..., None, :])[..., 2]
    return ((z1 > 0) & (z2 > 0)).sum(dim=-1)


def motion_from_essential(e: torch.Tensor, pts1: torch.Tensor,
                          pts2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (R, t) candidate with the most points in front of both cameras:
    e [..., 3, 3], pts [..., N, 2]."""
    rs, ts = decompose_essential(e)
    counts = cheirality_count(rs, ts, pts1[..., None, :, :], pts2[..., None, :, :])
    best = counts.argmax(dim=-1)
    return take(rs, best), take(ts, best)


def run_homography_dlt(pts1: torch.Tensor, pts2: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalized DLT homography (homography.py:112): [..., N, 2] -> H
    [..., 3, 3]."""
    n1, t1 = normalize_points(pts1)
    n2, t2 = normalize_points(pts2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    o = torch.ones_like(x1)
    z = torch.zeros_like(x1)
    ax = torch.stack([-x1, -y1, -o, z, z, z, x2 * x1, x2 * y1, x2], dim=-1)
    ay = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    a = torch.cat([ax, ay], dim=-2)
    if weights is not None:
        a = a * torch.cat([weights, weights], dim=-1)[..., None]
    h = null_vector(a).reshape(*a.shape[:-2], 3, 3)
    h = torch.linalg.inv_ex(t2)[0] @ h @ t1
    return _scale_by_last(h)


def homography_transfer_error(h: torch.Tensor, pts1: torch.Tensor,
                              pts2: torch.Tensor) -> torch.Tensor:
    """Squared transfer error of H [..., 3, 3] on [..., N, 2] -> [..., N]."""
    proj = torch.einsum("...ij,...nj->...ni", h, to_homogeneous(pts1))
    z = proj[..., 2:]
    proj = proj[..., :2] / z.abs().clamp_min(1e-8) * torch.sign(z)
    return ((proj - pts2) ** 2).sum(dim=-1)


class RansacResult(NamedTuple):
    model: torch.Tensor  # best model matrix
    inliers: torch.Tensor  # [N] bool
    score: torch.Tensor  # inlier count


def _ransac(solver, scorer, sample_size: int, pts1: torch.Tensor, pts2: torch.Tensor,
            generator: torch.Generator, threshold: float,
            num_hypotheses: int = 128) -> RansacResult:
    idx = ransac_samples(pts1.shape[-2], num_hypotheses, sample_size, generator, pts1.device)
    models = solver(gather_points(pts1, idx), gather_points(pts2, idx))  # [H, (3,) 3, 3]
    models = models.reshape(-1, 3, 3)  # multi-solution solvers: every candidate
    inliers = scorer(models, pts1, pts2) < threshold  # [H', N]
    scores = inliers.sum(dim=-1)
    best = scores.argmax()  # the first of equal scores, as jnp.argmax
    return RansacResult(model=take(models, best), inliers=take(inliers, best),
                        score=take(scores, best))


def local_refit(solver, scorer, pts1: torch.Tensor, pts2: torch.Tensor, res: RansacResult,
                threshold: float) -> RansacResult:
    """The reference's local-optimization step (utils.py:325): refit on the
    inliers (weighted least squares), kept where it loses no inlier."""
    refit = solver(pts1, pts2, weights=res.inliers.to(pts1.dtype))
    inl = scorer(refit, pts1, pts2) < threshold
    better = inl.sum() >= res.score
    return RansacResult(model=torch.where(better, refit, res.model),
                        inliers=torch.where(better, inl, res.inliers),
                        score=torch.maximum(inl.sum(), res.score))


def estimate_fundamental_ransac(pts1, pts2, generator=None, threshold=1.0, num_hypotheses=128,
                                sample_size=8) -> RansacResult:
    """Batched-hypothesis RANSAC 8-point fundamental (fundamental.py:43),
    with the final weighted refit on the inliers (utils.py:325)."""
    generator = default_generator(generator, pts1.device)
    res = _ransac(run_8point, sampson_distance, sample_size, pts1, pts2, generator, threshold,
                  num_hypotheses)
    return local_refit(run_8point, sampson_distance, pts1, pts2, res, threshold)


def estimate_homography_ransac(pts1, pts2, generator=None, threshold=3.0,
                               num_hypotheses=128) -> RansacResult:
    generator = default_generator(generator, pts1.device)
    res = _ransac(run_homography_dlt, homography_transfer_error, 4, pts1, pts2, generator,
                  threshold, num_hypotheses)
    return local_refit(run_homography_dlt, homography_transfer_error, pts1, pts2, res, threshold)


def normalized_coords(pts: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Pixels [..., N, 2] -> K^-1 x, [..., N, 2]."""
    kinv = torch.linalg.inv_ex(k)[0]
    return (to_homogeneous(pts) @ kinv.transpose(-1, -2))[..., :2]


def estimate_essential_ransac(pts1, pts2, k1, k2, generator=None, threshold=1e-3,
                              num_hypotheses=128
                              ) -> Tuple[RansacResult, torch.Tensor, torch.Tensor]:
    """Essential matrix by normalized-coordinate 8-point RANSAC, the
    inlier refit, and the cheirality pick of the motion (essential.py:111,203
    capability). Returns (result, R, t)."""
    generator = default_generator(generator, pts1.device)
    n1 = normalized_coords(pts1, k1)
    n2 = normalized_coords(pts2, k2)
    res = _ransac(run_8point, sampson_distance, 8, n1, n2, generator, threshold, num_hypotheses)
    # an 8-point minimal-sample model is noise-limited: refit on the whole
    # inlier set before the projection onto the essential manifold
    res = local_refit(run_8point, sampson_distance, n1, n2, res, threshold)
    e = project_to_essential(res.model)
    r, t = motion_from_essential(e, n1, n2)
    return RansacResult(model=e, inliers=res.inliers, score=res.score), r, t
