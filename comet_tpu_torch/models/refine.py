"""Fine track refinement on patches, and the matching score.

Counterpart of ``comet_tpu/models/refine.py``. Quirks of the reference kept
on purpose (they decide what the camera predictor is fed):

- the patch top-left is clamped for extraction (assuming H == W) but the
  UNCLAMPED top-left is added back when mapping to image coordinates;
- the frame-0 track is reset to the query points at the end;
- the score gather is bug-exact (see :func:`compute_score_fn`); frame 0
  scores 1.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..ops.bilinear import resize_bilinear_align_corners
from ..ops.corr import extract_patches_ex


def refine_track(
    images: torch.Tensor,  # [B, S, H, W, 3]
    fine_fnet: Callable,  # [M, P, P, 3] -> [M, P', P', C]
    fine_tracker: Callable,  # (query [B', N', 2], fmaps [B', S, P', P', C], iters) -> TrackerOutput
    coarse_pred: torch.Tensor,  # [B, S, N, 2]
    pradius: int = 15,
    sradius: int = 2,
    compute_score: bool = True,
    iters: int = 6,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    b, s, n, _ = coarse_pred.shape
    h, w = images.shape[2], images.shape[3]
    psize = 2 * pradius + 1

    query_points = coarse_pred[:, 0]
    track_int = torch.floor(coarse_pred)
    track_frac = coarse_pred - track_int
    topleft_unclamped = track_int.long() - pradius  # [B, S, N, 2]
    topleft = topleft_unclamped.clamp(0, h - psize)

    patches = extract_patches_ex(
        images.reshape(b * s, h, w, images.shape[-1]),
        topleft.reshape(b * s, n, 2),
        psize,
        track_major=True,
    )  # [N, B*S, P, P, 3]
    patch_feat = fine_fnet(patches.reshape(n * b * s, psize, psize, -1))
    hp, wp, c_out = patch_feat.shape[-3:]
    patch_feat_bn = (
        patch_feat.reshape(n, b, s, hp, wp, c_out).transpose(0, 1).reshape(b * n, s, hp, wp, c_out)
    )

    patch_query = (track_frac[:, 0] + pradius).reshape(b * n, 1, 2)
    out = fine_tracker(patch_query, patch_feat_bn, iters)
    fine_rel = out.coord_preds[-1][..., 0, :]  # [B*N, S, 2], relative to the top-left
    fine_rel_bsn = fine_rel.reshape(b, n, s, 2).transpose(1, 2)

    refined = fine_rel_bsn + topleft_unclamped.to(fine_rel_bsn.dtype)
    refined = torch.cat([query_points[:, None], refined[:, 1:]], dim=1)

    score = None
    if compute_score:
        score = compute_score_fn(
            out.query_feats.reshape(b, n, c_out),
            patch_feat_bn.reshape(b, n, s, hp, wp, c_out),
            fine_rel.reshape(b, n, s, 2),
            sradius,
            psize,
        )
    return refined, score


def compute_score_fn(
    query_feat: torch.Tensor,  # [B, N, C]
    patch_feat: torch.Tensor,  # [B, N, S, P', P', C] (track-major, native size)
    fine_pred: torch.Tensor,  # [B, N, S, 2] relative to the patch top-left
    sradius: int,
    psize: int,
) -> torch.Tensor:
    """Std of the (2r+1)^2 similarity heatmap around each fine prediction;
    returns [B, S, N] with frame 0 set to 1.

    BUG-EXACT with the reference gather, which the shipped weights were
    trained and evaluated with:
    - every output element (b, s, n) reads the windows of the patch at FLAT
      index b of the (b, s, n) order (for B = 1: track 0, frame 0), not of
      its own patch;
    - the top-left list is flattened in (b, n, s) order but consumed at
      (b, s, n) positions, i.e. read transposed.
    """
    b, n, s, hp, wp, c = patch_feat.shape
    ssize = 2 * sradius + 1

    topleft = (torch.floor(fine_pred).long() - sradius).clamp(0, psize - ssize)
    tl_flat = topleft.reshape(b * n * s, 2)  # (b, n, s) order

    # flat patch index b in (b, s, n) order, mapped to the (b, n, s) storage
    src = torch.arange(b, device=patch_feat.device)
    rem = src % (s * n)
    src_my = (src // (s * n)) * (n * s) + (rem % n) * s + rem // n
    src_patches = patch_feat.reshape(b * n * s, hp, wp, c)[src_my]  # [B, P', P', C]
    if (hp, wp) != (psize, psize):
        src_patches = resize_bilinear_align_corners(src_patches, psize, psize)
    windows = extract_patches_ex(src_patches, tl_flat.reshape(b, s * n, 2), ssize).reshape(
        b, s, n, ssize * ssize, c
    )

    sim = torch.einsum("bsnkc,bnc->bsnk", windows.float(), query_feat.float())
    heat = torch.softmax(sim / c ** 0.5, dim=-1)

    lin = torch.linspace(-1.0, 1.0, ssize, device=sim.device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # [K, 2]
    mean = heat @ grid
    var = heat @ grid**2 - mean**2
    std = torch.sqrt(var.clamp_min(1e-10)).sum(dim=-1)  # [B, S, N]
    return torch.cat([torch.ones_like(std[:, :1]), std[:, 1:]], dim=1)
