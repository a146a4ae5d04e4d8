"""Keypoint patch extraction and patch heat maps.

Counterpart of ``comet_tpu/matching/patches.py``, itself glue-factory's
utils/patches.py (extract_patches, batch_extract_patches,
draw_image_patches, build_heatmap). The extraction is one gather over a
batch of corners; the drawing helpers are host numpy, for visualization.

The layout is the reference's: images channel-first, [C, H, W] or
[B, C, H, W]; patches [N, C, ps, ps]; corners (x, y). These are not
``ops.corr.extract_patches``, which is channel-last and clamps its corners
to ``dim - ps``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .viz import _np

__all__ = ["extract_patches", "batch_extract_patches", "draw_image_patches", "build_heatmap"]


def _gather(images: torch.Tensor, corners: torch.Tensor,
            ps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The patches of [B, C, H, W] at float corners [B, N, 2] (x, y),
    truncated toward zero and clamped to [0, dim - 1 - ps]: ([B, N, C, ps,
    ps], the corners as f32)."""
    h, w = images.shape[-2:]
    corner = corners.to(torch.int32)
    corner = torch.stack([corner[..., 0].clamp(0, w - 1 - ps),
                          corner[..., 1].clamp(0, h - 1 - ps)], -1).long()
    off = torch.arange(ps, device=images.device)
    yy = corner[..., 1, None, None] + off[:, None]  # [B, N, ps, 1]
    xx = corner[..., 0, None, None] + off[None, :]  # [B, N, 1, ps]
    bi = torch.arange(images.shape[0], device=images.device)[:, None, None, None]
    patches = images.permute(0, 2, 3, 1)[bi, yy, xx]  # [B, N, ps, ps, C]
    return patches.permute(0, 1, 4, 2, 3), corner.float()


def extract_patches(image: torch.Tensor, required_corners: torch.Tensor,
                    ps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ps`` x ``ps`` patches with top-left corners at integer (x, y).

    image: [C, H, W]; required_corners: [N, 2] float (x, y). Returns
    (patches [N, C, ps, ps], corners [N, 2] f32). The corners are truncated
    toward zero, then clamped to [0, dim - 1 - ps]: the reference's upper
    bound, one short of the last patch that fits, kept so that the corners
    are the reference's."""
    patches, corners = _gather(image[None], required_corners[None], ps)
    return patches[0], corners[0]


def batch_extract_patches(images: torch.Tensor, kpts: torch.Tensor,
                          ps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Patches about keypoints, batched: images [B, C, H, W], kpts [B, N, 2]
    (x, y); each top-left corner is ``kpt - ps/2 - 1``. Returns (patches
    [B, N, C, ps, ps], corners [B, N, 2])."""
    return _gather(images, kpts - ps / 2 - 1, ps)


def draw_image_patches(img: np.ndarray, patches, corners) -> None:
    """Paste patches back into ``img`` in place (host numpy). img
    [B, C, H, W]; patches [B, N, C, ps, ps]; corners [B, N, 2] (x, y)."""
    patches, corners = _np(patches), _np(corners)
    b, n = patches.shape[:2]
    ps = patches.shape[-1]
    for i in range(b):
        for k in range(n):
            x, y = int(corners[i, k, 0]), int(corners[i, k, 1])
            img[i, :, y:y + ps, x:x + ps] = patches[i, k]


def build_heatmap(img, patches, corners) -> Tuple[np.ndarray, np.ndarray]:
    """The patches' coverage drawn on zeros shaped as ``img`` and its mask
    ``heatmap > 0``: ([B, H, W] where C is 1, else [B, C, H, W]; f32 mask)."""
    hmap = np.zeros_like(_np(img))
    draw_image_patches(hmap, patches, corners)
    if hmap.ndim >= 2 and hmap.shape[1] == 1:
        hmap = hmap.squeeze(1)
    return hmap, (hmap > 0.0).astype(np.float32)
