"""Ground-truth matches from depth maps and relative poses, points and lines.

Counterpart of ``comet_tpu/matching/depth_gt.py`` (glue-factory's
geometry/depth.py, gt_generation.py and epipolar.py, and its depth and
homography GT matchers): depth sampling with the nearest-neighbour fallback
of ``grid_sample``, projection into the other view with an optional
circle-consistency check, the all-pairs symmetric epipolar distance, the
point labels (``gt_generation.IGNORE`` / ``UNMATCHED``) and the line labels
from warped segment samples, under a pose with depth or a homography.

Pinhole cameras are plain (K, R, t) tensors; shapes are static and invalid
pixels carry masks. Everything runs on the inputs' device. The inverses
skip the error check (``inv_ex``: no host sync), as in ``gt_generation``;
argmins take the first minimum, as ``jnp.argmin`` does, and the line
samples sit at ``jnp.linspace``'s positions (``lines.linspace01``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..twoview.estimators import to_homogeneous
from .gt_generation import IGNORE, UNMATCHED, gt_matches_from_homography, warp_homography
from .lines import linspace01
from .registry import register_model

__all__ = [
    "sample_depth",
    "project_points_with_depth",
    "gt_matches_from_pose_depth",
    "dense_warp_consistency",
    "pose_to_essential",
    "essential_to_fundamental",
    "sym_epipolar_distance_all",
    "gt_line_matches_from_homography",
    "gt_line_matches_from_pose_depth",
]


def _inv(m: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(m)[0]


def sample_depth(pts: torch.Tensor, depth: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A [H, W] depth map at [N, 2] pixel coordinates (x, y), pixel centres
    at +0.5 (``grid_sample(align_corners=False)``): bilinear where all four
    neighbours are valid (> 0), else the nearest neighbour; valid where the
    point is inside the map and the value > 0. Returns (depth [N], valid [N])."""
    h, w = depth.shape
    x = pts[:, 0] - 0.5
    y = pts[:, 1] - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.long()
    y0i = y0.long()

    def gather(yy, xx):
        d = depth[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return d, (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w) & (d > 0)

    d00, v00 = gather(y0i, x0i)
    d01, v01 = gather(y0i, x0i + 1)
    d10, v10 = gather(y0i + 1, x0i)
    d11, v11 = gather(y0i + 1, x0i + 1)
    lin = (d00 * (1 - fy) * (1 - fx) + d01 * (1 - fy) * fx
           + d10 * fy * (1 - fx) + d11 * fy * fx)
    lin_ok = v00 & v01 & v10 & v11
    # the nearest-neighbour fallback (round half to even, as jnp.round)
    xn = torch.round(x).long().clamp(0, w - 1)
    yn = torch.round(y).long().clamp(0, h - 1)
    out = torch.where(lin_ok, lin, depth[yn, xn])
    inside = (pts[:, 0] >= 0) & (pts[:, 0] < w) & (pts[:, 1] >= 0) & (pts[:, 1] < h)
    return out, inside & (out > 0)


def _image2cam(kp: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[N, 2] pixels -> [N, 3] rays at unit depth."""
    return to_homogeneous(kp) @ _inv(k).T


def _cam2image(p3d: torch.Tensor, k: torch.Tensor,
               size: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, 3] camera points -> ([N, 2] pixels, valid): in front of the camera
    (z > 1e-4) and, with ``size`` = (width, height), inside [0, size - 1]."""
    z = p3d[:, 2]
    valid = z > 1e-4
    p2d = (p3d @ k.T)[:, :2] / z.clamp_min(1e-4)[:, None]
    if size is not None:
        w, h = size
        valid = valid & ((p2d[:, 0] >= 0) & (p2d[:, 0] <= w - 1)
                         & (p2d[:, 1] >= 0) & (p2d[:, 1] <= h - 1))
    return p2d, valid


def project_points_with_depth(
    kp_i: torch.Tensor,  # [N, 2]
    d_i: torch.Tensor,  # [N]
    k_i: torch.Tensor,
    k_j: torch.Tensor,
    r_itoj: torch.Tensor,  # [3, 3]
    t_itoj: torch.Tensor,  # [3]
    valid_i: torch.Tensor,  # [N] bool
    depth_j: Optional[torch.Tensor] = None,  # [H, W]
    cc_th: Optional[float] = None,
    size_i: Optional[Tuple[int, int]] = None,  # (width, height)
    size_j: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keypoints of view i lifted by their depth, moved into view j and
    projected: (kp_in_j [N, 2], visible [N]). With ``depth_j`` and ``cc_th``
    a point is also visible only where view j's depth takes it back within
    sqrt(cc_th) px of where it started."""
    p_i = _image2cam(kp_i, k_i) * d_i[:, None]
    kp_j, front_j = _cam2image(p_i @ r_itoj.T + t_itoj, k_j, size_j)
    visible = valid_i & front_j
    if depth_j is None or cc_th is None:
        return kp_j, visible
    d_j, dvalid_j = sample_depth(kp_j, depth_j)
    p_back = _image2cam(kp_j, k_j) * d_j[:, None]
    kp_i_back, valid_back = _cam2image((p_back - t_itoj) @ r_itoj, k_i, size_i)
    consistent = ((kp_i - kp_i_back) ** 2).sum(-1) < cc_th
    return kp_j, visible & consistent & dvalid_j & valid_back


def pose_to_essential(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """E = [t]x R for the 0 -> 1 relative pose."""
    z = torch.zeros((), dtype=t.dtype, device=t.device)
    tx = torch.stack([torch.stack([z, -t[2], t[1]]), torch.stack([t[2], z, -t[0]]),
                      torch.stack([-t[1], t[0], z])])
    return tx @ r


def essential_to_fundamental(e: torch.Tensor, k0: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """F = K1^-T E K0^-1."""
    return _inv(k1).T @ e @ _inv(k0)


def sym_epipolar_distance_all(p0: torch.Tensor, p1: torch.Tensor, f: torch.Tensor,
                              eps: float = 1e-15) -> torch.Tensor:
    """The symmetric epipolar distance of every pair of p0 [N0, 2] and p1
    [N1, 2] (pixels) under the fundamental matrix: [N0, N1]."""
    l1 = to_homogeneous(p0) @ f.T  # p0's epipolar lines in image 1
    l0 = to_homogeneous(p1) @ f  # p1's in image 0
    num = torch.einsum("ic,jc->ij", l1, to_homogeneous(p1)).abs()
    inv1 = 1.0 / (torch.sqrt(l1[:, 0] ** 2 + l1[:, 1] ** 2) + eps)
    inv0 = 1.0 / (torch.sqrt(l0[:, 0] ** 2 + l0[:, 1] ** 2) + eps)
    return num * (inv1[:, None] + inv0[None, :])


def gt_matches_from_pose_depth(
    kp0: torch.Tensor,  # [N0, 2]
    kp1: torch.Tensor,  # [N1, 2]
    depth0: torch.Tensor,  # [H, W]
    depth1: torch.Tensor,  # [H, W]
    k0: torch.Tensor,
    k1: torch.Tensor,
    r_0to1: torch.Tensor,
    t_0to1: torch.Tensor,
    pos_threshold: float = 3.0,
    neg_threshold: float = 5.0,
    cc_threshold: Optional[float] = None,
    epi_threshold: Optional[float] = None,
) -> Dict[str, torch.Tensor]:
    """Depth-warp labels: mutual nearest reprojections within
    ``pos_threshold`` px match; keypoints whose warp lands farther than
    ``neg_threshold`` from every counterpart are UNMATCHED; the rest IGNORE.
    ``epi_threshold`` (any value: as in the reference, it only enables the
    step, which compares with ``neg_threshold``) also makes UNMATCHED the
    depth-less keypoints epipolar-far from every still-ambiguous one."""
    n0, n1 = kp0.shape[0], kp1.shape[0]
    dev = kp0.device
    d0, valid0 = sample_depth(kp0, depth0)
    d1, valid1 = sample_depth(kp1, depth1)
    r_1to0 = r_0to1.T
    t_1to0 = -r_0to1.T @ t_0to1
    size0 = (depth0.shape[1], depth0.shape[0])
    size1 = (depth1.shape[1], depth1.shape[0])
    kp0_1, vis0 = project_points_with_depth(kp0, d0, k0, k1, r_0to1, t_0to1, valid0, depth1,
                                            cc_threshold, size_i=size0, size_j=size1)
    kp1_0, vis1 = project_points_with_depth(kp1, d1, k1, k0, r_1to0, t_1to0, valid1, depth0,
                                            cc_threshold, size_i=size1, size_j=size0)
    dist0 = ((kp0_1[:, None] - kp1[None]) ** 2).sum(-1)  # [N0, N1]
    dist1 = ((kp0[:, None] - kp1_0[None]) ** 2).sum(-1)
    dist = torch.where(vis0[:, None] & vis1[None, :], torch.maximum(dist0, dist1), torch.inf)

    min0 = dist.argmin(dim=1)
    min1 = dist.argmin(dim=0)
    ismin0 = torch.zeros(dist.shape, dtype=torch.bool, device=dev)
    ismin0[torch.arange(n0, device=dev), min0] = True
    ismin1 = torch.zeros(dist.shape, dtype=torch.bool, device=dev)
    ismin1[min1, torch.arange(n1, device=dev)] = True
    positive = ismin0 & ismin1 & (dist < pos_threshold ** 2)
    negative0 = (dist0.amin(dim=1) > neg_threshold ** 2) & valid0
    negative1 = (dist1.amin(dim=0) > neg_threshold ** 2) & valid1
    m0 = torch.where(positive.any(dim=1), min0, IGNORE)
    m1 = torch.where(positive.any(dim=0), min1, IGNORE)
    m0 = torch.where(negative0, UNMATCHED, m0)
    m1 = torch.where(negative1, UNMATCHED, m1)

    f = essential_to_fundamental(pose_to_essential(r_0to1, t_0to1), k0, k1)
    epi_dist = sym_epipolar_distance_all(kp0, kp1, f)
    if epi_threshold is not None:
        ignore = (m0[:, None] == IGNORE) & (m1[None, :] == IGNORE)
        epi_masked = torch.where(ignore, epi_dist, torch.inf)
        m0 = torch.where((~valid0) & (epi_masked.amin(dim=1) > neg_threshold), UNMATCHED, m0)
        m1 = torch.where((~valid1) & (epi_masked.amin(dim=0) > neg_threshold), UNMATCHED, m1)
    return {
        "assignment": positive,
        "reward": (dist < pos_threshold ** 2).float() - (epi_dist > neg_threshold).float(),
        "matches0": m0,
        "matches1": m1,
        "matching_scores0": (m0 > -1).float(),
        "matching_scores1": (m1 > -1).float(),
        "depth_keypoints0": d0,
        "depth_keypoints1": d1,
        "proj_0to1": kp0_1,
        "proj_1to0": kp1_0,
        "visible0": vis0,
        "visible1": vis1,
    }


def dense_warp_consistency(
    depth0: torch.Tensor,  # [H, W]
    depth1: torch.Tensor,
    k0: torch.Tensor,
    k1: torch.Tensor,
    r_0to1: torch.Tensor,
    t_0to1: torch.Tensor,
    cc_th: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every pixel centre of view 0 warped into view 1 through its depth:
    (warped [H, W, 2], valid [H, W])."""
    h, w = depth0.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=depth0.device),
                            torch.arange(w, device=depth0.device), indexing="ij")
    kp = torch.stack([xs + 0.5, ys + 0.5], dim=-1).reshape(-1, 2).to(depth0.dtype)
    d = depth0.reshape(-1)
    warped, valid = project_points_with_depth(
        kp, d, k0, k1, r_0to1, t_0to1, d > 0, depth1 if cc_th else None, cc_th,
        size_i=(w, h), size_j=(depth1.shape[1], depth1.shape[0]))
    return warped.reshape(h, w, 2), valid.reshape(h, w)


def _sample_segments(lines: torch.Tensor, n_samples: int) -> torch.Tensor:
    """[M, 2, 2] segments -> [M, S, 2] equally spaced sample points."""
    ts = linspace01(n_samples, lines.device)[:, None]
    return lines[:, None, 0] * (1 - ts)[None] + lines[:, None, 1] * ts[None]


def _segment_distances(samples, segs, sample_valid=None):
    """Warped samples [M, S, 2] against candidate segments [K, 2, 2]: (mean
    perpendicular distance of the samples that project inside the segment
    and are valid [M, K], the fraction of such samples [M, K])."""
    a = segs[:, 0]
    d = segs[:, 1] - segs[:, 0]
    len2 = (d ** 2).sum(-1).clamp_min(1e-9)
    rel = samples[:, :, None] - a[None, None]  # [M, S, K, 2]
    t = torch.einsum("mskc,kc->msk", rel, d) / len2
    inside = (t >= 0.0) & (t <= 1.0)
    if sample_valid is not None:
        inside = inside & sample_valid[:, :, None]
    cross = rel[..., 0] * d[None, None, :, 1] - rel[..., 1] * d[None, None, :, 0]
    perp = cross.abs() / torch.sqrt(len2)[None, None]
    overlap = inside.float().mean(dim=1)
    wsum = torch.where(inside, perp, 0.0).sum(dim=1)
    return wsum / inside.sum(dim=1).clamp_min(1), overlap


def _mutual_line_assignment(d01, ov01, d10, ov10, dist_threshold, overlap_threshold, n0, n1):
    """The symmetric cost and its mutual nearest neighbours."""
    dist = torch.maximum(d01, d10.T)
    overlap = torch.minimum(ov01, ov10.T)
    cost = torch.where(overlap > overlap_threshold, dist, torch.inf)
    nn0 = cost.argmin(dim=1)
    nn1 = cost.argmin(dim=0)
    mutual0 = torch.arange(n0, device=cost.device) == nn1[nn0]
    mutual1 = torch.arange(n1, device=cost.device) == nn0[nn1]
    return {
        "line_matches0": torch.where(mutual0 & (cost.amin(dim=1) < dist_threshold), nn0,
                                     UNMATCHED),
        "line_matches1": torch.where(mutual1 & (cost.amin(dim=0) < dist_threshold), nn1,
                                     UNMATCHED),
        "distances": dist,
        "overlaps": overlap,
    }


def gt_line_matches_from_pose_depth(
    lines0: torch.Tensor,  # [M0, 2, 2]
    lines1: torch.Tensor,  # [M1, 2, 2]
    depth0: torch.Tensor,
    depth1: torch.Tensor,
    k0: torch.Tensor,
    k1: torch.Tensor,
    r_0to1: torch.Tensor,
    t_0to1: torch.Tensor,
    n_samples: int = 8,
    dist_threshold: float = 3.0,
    overlap_threshold: float = 0.4,
) -> Dict[str, torch.Tensor]:
    """Line labels under a relative pose with depth: each segment's samples
    lifted by their depth and warped into the other view; a pair's cost is
    the mean perpendicular distance of the visible warped samples that fall
    inside the other segment, over pairs whose overlap passes; mutual
    nearest pairs under ``dist_threshold`` match."""
    size0 = (depth0.shape[1], depth0.shape[0])
    size1 = (depth1.shape[1], depth1.shape[0])
    r_1to0 = r_0to1.T
    t_1to0 = -r_0to1.T @ t_0to1

    def warp(lines, depth_i, k_i, k_j, r, t, size_i, size_j):
        pts = _sample_segments(lines, n_samples).reshape(-1, 2)
        d, valid = sample_depth(pts, depth_i)
        warped, vis = project_points_with_depth(pts, d, k_i, k_j, r, t, valid, size_i=size_i,
                                                size_j=size_j)
        m = lines.shape[0]
        return warped.reshape(m, n_samples, 2), vis.reshape(m, n_samples)

    w0, v0 = warp(lines0, depth0, k0, k1, r_0to1, t_0to1, size0, size1)
    w1, v1 = warp(lines1, depth1, k1, k0, r_1to0, t_1to0, size1, size0)
    d01, ov01 = _segment_distances(w0, lines1, v0)
    d10, ov10 = _segment_distances(w1, lines0, v1)
    return _mutual_line_assignment(d01, ov01, d10, ov10, dist_threshold, overlap_threshold,
                                   lines0.shape[0], lines1.shape[0])


def gt_line_matches_from_homography(
    lines0: torch.Tensor,  # [M0, 2, 2]
    lines1: torch.Tensor,  # [M1, 2, 2]
    h: torch.Tensor,  # [3, 3] image0 -> image1
    n_samples: int = 8,
    dist_threshold: float = 3.0,
    overlap_threshold: float = 0.5,
) -> Dict[str, torch.Tensor]:
    """Line labels under a homography: each segment's samples warped into
    the other image, scored against the other image's segments as in
    :func:`gt_line_matches_from_pose_depth`."""
    m0n, m1n = lines0.shape[0], lines1.shape[0]
    pts0w = warp_homography(_sample_segments(lines0, n_samples).reshape(-1, 2), h)
    pts1w = warp_homography(_sample_segments(lines1, n_samples).reshape(-1, 2), _inv(h))
    d01, ov01 = _segment_distances(pts0w.reshape(m0n, n_samples, 2), lines1)
    d10, ov10 = _segment_distances(pts1w.reshape(m1n, n_samples, 2), lines0)
    return _mutual_line_assignment(d01, ov01, d10, ov10, dist_threshold, overlap_threshold,
                                   m0n, m1n)


@register_model("matcher_homography", {"pos_threshold": 3.0, "neg_threshold": 6.0})
def make_homography_matcher(pos_threshold=3.0, neg_threshold=6.0):
    """GT matcher: labels from the pair's homography, called with (feats0,
    feats1, data), ``data["H_0to1"]`` a tensor on the features' device."""

    def matcher(feats0, feats1, data):
        return gt_matches_from_homography(feats0["keypoints"], feats1["keypoints"],
                                          data["H_0to1"], pos_threshold=pos_threshold,
                                          neg_threshold=neg_threshold)

    return matcher


@register_model(
    "matcher_depth",
    {"pos_threshold": 3.0, "neg_threshold": 5.0, "cc_threshold": None, "epi_threshold": None},
)
def make_depth_matcher(pos_threshold=3.0, neg_threshold=5.0, cc_threshold=None,
                       epi_threshold=None):
    """GT matcher: labels from pose and depth warps, called with (feats0,
    feats1, data), ``data`` holding depth0/1, K0/K1, R_0to1 and t_0to1."""

    def matcher(feats0, feats1, data):
        return gt_matches_from_pose_depth(
            feats0["keypoints"], feats1["keypoints"], data["depth0"], data["depth1"],
            data["K0"], data["K1"], data["R_0to1"], data["t_0to1"],
            pos_threshold=pos_threshold, neg_threshold=neg_threshold,
            cc_threshold=cc_threshold, epi_threshold=epi_threshold)

    return matcher
