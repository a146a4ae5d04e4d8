"""Perspective-n-Point: a DLT start polished by Levenberg-Marquardt.

Counterpart of ``comet_tpu/twoview/pnp.py`` (the reference's
comet/two_view_geo/perspective_n_points.py:321 and pnp.py:38,216): at
COMET's sizes a DLT and a fixed number of LM steps match EPnP's accuracy
as one batched SVD and a short loop with no per-problem control flow. The
solver is batched over problems: each problem's step is accepted or
rejected on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..geometry.quaternions import matrix_to_quat, quat_normalize, quat_to_matrix
from .estimators import null_vector, take


class PnPResult(NamedTuple):
    r: torch.Tensor  # [3, 3] column-vector rotation (x_cam = R x_world + t)
    t: torch.Tensor  # [3]
    reproj_rms: torch.Tensor  # []


def _dlt_pose(points3d: torch.Tensor, points2d_norm: torch.Tensor,
              weights: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """DLT for the 3x4 pose matrix P with x ~ P X (normalized 2-D
    coordinates): points3d [..., N, 3], points2d_norm [..., N, 2]."""
    xh = torch.cat([points3d, torch.ones_like(points3d[..., :1])], dim=-1)
    u = points2d_norm[..., 0:1]
    v = points2d_norm[..., 1:2]
    z = torch.zeros_like(xh)
    rows_u = torch.cat([xh, z, -u * xh], dim=-1)
    rows_v = torch.cat([z, xh, -v * xh], dim=-1)
    a = torch.cat([rows_u, rows_v], dim=-2)  # [..., 2N, 12]
    if weights is not None:
        a = a * torch.cat([weights, weights], dim=-1)[..., None]
    p = null_vector(a).reshape(*a.shape[:-2], 3, 4)
    # R, t: scale so that R's last row is a unit vector, orient so that most
    # points have positive depth, orthogonalize the left 3x3 by its SVD
    scale = torch.linalg.norm(p[..., 2, :3], dim=-1)[..., None, None]
    p = p / torch.where(scale > 1e-10, scale, torch.ones_like(scale))
    depths = torch.einsum("...j,...nj->...n", p[..., 2, :3], points3d) + p[..., 2, 3:]
    sign = torch.sign(torch.sign(depths).sum(dim=-1) + 0.5)
    p = p * sign[..., None, None]
    u_m, _, vt_m = torch.linalg.svd(p[..., :3])
    r = u_m @ vt_m
    r = r * torch.sign(torch.linalg.det(r))[..., None, None]
    return r, p[..., :, 3]


def _project_norm(points3d: torch.Tensor, r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    cam = torch.einsum("...ij,...nj->...ni", r, points3d) + t[..., None, :]
    z = cam[..., 2:]
    return cam[..., :2] / z.abs().clamp_min(1e-8) * torch.sign(z)


def _residual(x: torch.Tensor, points3d: torch.Tensor, pn: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """One problem's weighted residuals [2N] at x = (quaternion, t) [7]."""
    pred = _project_norm(points3d, quat_to_matrix(quat_normalize(x[:4])), x[4:])
    return ((pred - pn) * w[:, None]).reshape(-1)


_batched_residual = torch.func.vmap(_residual)
_batched_jacobian = torch.func.vmap(torch.func.jacfwd(_residual))


def _solve_pnp(points3d: torch.Tensor, points2d: torch.Tensor, k: torch.Tensor,
               weights: Optional[torch.Tensor], lm_iters: int) -> PnPResult:
    """solve_pnp over a batch: points3d [B, N, 3], points2d [B, N, 2], k [B,
    3, 3], weights [B, N] or None."""
    kinv = torch.linalg.inv_ex(k)[0]
    pn = (torch.cat([points2d, torch.ones_like(points2d[..., :1])], dim=-1)
          @ kinv.transpose(-1, -2))[..., :2]
    w = weights if weights is not None else torch.ones_like(points3d[..., 0])
    r0, t0 = _dlt_pose(points3d, pn, w)
    x = torch.cat([matrix_to_quat(r0), t0], dim=-1)  # [B, 7]
    lam = torch.full(x.shape[:1], 1e-3, dtype=x.dtype, device=x.device)
    floor = torch.full((), 1e-10, dtype=x.dtype, device=x.device)
    for _ in range(lm_iters):
        r = _batched_residual(x, points3d, pn, w)
        jac = _batched_jacobian(x, points3d, pn, w)  # [B, 2N, 7]
        jtj = jac.transpose(-1, -2) @ jac
        damp = torch.diag_embed(torch.maximum(jtj.diagonal(dim1=-2, dim2=-1), floor))
        delta = torch.linalg.solve_ex(jtj + lam[:, None, None] * damp,
                                      -(jac.transpose(-1, -2) @ r[..., None]))[0][..., 0]
        x_new = x + delta
        better = (_batched_residual(x_new, points3d, pn, w) ** 2).sum(-1) < (r ** 2).sum(-1)
        x = torch.where(better[:, None], x_new, x)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    r = quat_to_matrix(quat_normalize(x[:, :4]))
    t = x[:, 4:]
    rms = torch.sqrt(torch.mean(torch.sum((_project_norm(points3d, r, t) - pn) ** 2, -1), -1))
    return PnPResult(r=r, t=t, reproj_rms=rms)


def solve_pnp(points3d: torch.Tensor, points2d: torch.Tensor, k: torch.Tensor,
              weights: Optional[torch.Tensor] = None, lm_iters: int = 10) -> PnPResult:
    """DLT and quaternion-parameterized LM polish: points3d [N, 3], points2d
    [N, 2] pixels, k [3, 3], weights [N] optional."""
    res = _solve_pnp(points3d[None], points2d[None], k[None],
                     None if weights is None else weights[None], lm_iters)
    return PnPResult(*(a[0] for a in res))


def solve_pnp_batched(points3d: torch.Tensor, points2d: torch.Tensor,
                      k: torch.Tensor) -> PnPResult:
    """solve_pnp over B problems that share K: points3d [B, N, 3], points2d
    [B, N, 2], k [3, 3]."""
    return _solve_pnp(points3d, points2d, k.expand(points3d.shape[0], 3, 3), None, 10)


def solve_pnp_focal_sweep(points3d: torch.Tensor, points2d: torch.Tensor, pp: torch.Tensor,
                          focal_candidates: torch.Tensor) -> Tuple[PnPResult, torch.Tensor]:
    """Unknown-focal PnP: solve at each candidate focal length [F], keep the
    lowest reprojection RMS (two_view_geo/pnp.py:216 capability)."""
    f = focal_candidates
    n = f.shape[0]
    zero = torch.zeros_like(f)
    k = torch.stack([torch.stack([f, zero, pp[0].expand(n)], -1),
                     torch.stack([zero, f, pp[1].expand(n)], -1),
                     torch.stack([zero, zero, torch.ones_like(f)], -1)], -2)
    results = _solve_pnp(points3d.expand(n, *points3d.shape), points2d.expand(n, *points2d.shape),
                         k, None, 10)
    best = results.reproj_rms.argmin()
    return PnPResult(*(take(a, best) for a in results)), take(focal_candidates, best)
