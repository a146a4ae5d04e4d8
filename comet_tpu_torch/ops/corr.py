"""Correlation-pyramid sampling and patch extraction for the trackers.

Counterpart of ``comet_tpu/ops/corr.py`` (``corr_volume_pyramid_sample``,
``extract_patches`` and ``extract_patches_ex``, and the feature-pyramid form ``avg_pool_2x2``,
``build_fmap_pyramid`` and ``corr_pyramid_sample``, the semantic reference
the trackers' volume form equals). The TPU version replaced gathers by two-hot
selection matmuls; here the windows are plain gathers, with the same
semantics:

- correlation is taken first on the native feature maps (one batched matmul
  into scalar volumes), then the volumes are resized (the fine stage's fold
  of the fnet upsample, ``out_size``) and 2x2-average-pooled per level; by
  linearity this equals pooling and resizing the features first;
- each (2r+1)^2 window is sampled bilinearly at centroid / 2^level with zero
  padding: taps outside the map contribute nothing;
- window channels are ordered with the x offset in the outer loop.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .bilinear import resize_nchw


def _sample_windows(vol: torch.Tensor, centroid: torch.Tensor, radius: int) -> torch.Tensor:
    """vol [M, H, W] f32, centroid [M, 2] (x, y) -> [M, (2r+1)^2], x outer.

    All taps of one window share the centroid's fractional offset, so one
    (2r+2)^2 integer-aligned gather per window feeds every bilinear tap.
    """
    m, h, w = vol.shape
    k = 2 * radius + 1
    x0 = torch.floor(centroid[:, 0])
    y0 = torch.floor(centroid[:, 1])
    fx = (centroid[:, 0] - x0)[:, None, None]
    fy = (centroid[:, 1] - y0)[:, None, None]
    taps = torch.arange(-radius, radius + 2, device=vol.device)
    ri = y0.long()[:, None] + taps  # [M, K+1]
    ci = x0.long()[:, None] + taps
    flat = (ri.clamp(0, h - 1) * w)[:, :, None] + ci.clamp(0, w - 1)[:, None, :]
    patch = torch.gather(vol.reshape(m, h * w), 1, flat.reshape(m, -1)).reshape(m, k + 1, k + 1)
    inside = ((ri >= 0) & (ri < h))[:, :, None] & ((ci >= 0) & (ci < w))[:, None, :]
    patch = patch * inside  # zero padding: taps off the map contribute nothing
    top = patch[:, :-1, :-1] * (1 - fx) + patch[:, :-1, 1:] * fx
    bot = patch[:, 1:, :-1] * (1 - fx) + patch[:, 1:, 1:] * fx
    out = top * (1 - fy) + bot * fy  # [M, K (y), K (x)]
    return out.transpose(1, 2).reshape(m, k * k)


def corr_volume_pyramid_sample(
    fmaps: torch.Tensor,
    coords: torch.Tensor,
    track_feats: torch.Tensor,
    radius: int,
    num_levels: int,
    out_size: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Correlation features <track_feat, fmap(window)> / sqrt(C).

    fmaps [B, S, h0, w0, C] native maps; coords [B, S, N, 2] in level-0 space
    (out_size space when given); track_feats [B, S, N, C]. out_size (hh, ww)
    resizes the level-0 volume (align corners). Level l is the level-0
    volume 2x2-average-pooled l times (floor sizes; a map with a side below
    2 is kept as it is). Returns [B, S, N, num_levels * (2r+1)^2] in
    track_feats' dtype.
    """
    b, s, n, _ = coords.shape
    h0, w0, c = fmaps.shape[2:]
    tf = track_feats * (1.0 / c ** 0.5)
    vol = torch.matmul(
        tf.reshape(b * s, n, c), fmaps.reshape(b * s, h0 * w0, c).transpose(1, 2)
    )  # [B*S, N, h0*w0]
    vol = vol.float().reshape(b * s * n, 1, h0, w0)
    if out_size is not None:
        vol = resize_nchw(vol, *out_size)
    pts = coords.reshape(b * s * n, 2).float()
    outs = []
    for lvl in range(num_levels):
        if lvl > 0 and vol.shape[-2] >= 2 and vol.shape[-1] >= 2:
            vol = F.avg_pool2d(vol, 2)
        outs.append(_sample_windows(vol[:, 0], pts / (2.0 ** lvl), radius))
    return torch.cat(outs, dim=-1).reshape(b, s, n, -1).to(track_feats.dtype)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, on [..., H, W, C] (floor sizes); a map
    with a side below 2 is kept as it is, so deep pyramids on tiny inputs
    bottom out at 1x1."""
    h, w = x.shape[-3], x.shape[-2]
    if h < 2 or w < 2:
        return x
    h2, w2 = h // 2, w // 2
    a = x[..., 0:h2 * 2:2, 0:w2 * 2:2, :]
    b = x[..., 0:h2 * 2:2, 1:w2 * 2:2, :]
    c = x[..., 1:h2 * 2:2, 0:w2 * 2:2, :]
    d = x[..., 1:h2 * 2:2, 1:w2 * 2:2, :]
    return (a + b + c + d) * 0.25


def build_fmap_pyramid(fmaps: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """fmaps [B, S, H, W, C] -> num_levels maps, each 2x2-average-pooled
    from the one before."""
    pyramid = [fmaps]
    for _ in range(num_levels - 1):
        pyramid.append(avg_pool_2x2(pyramid[-1]))
    return pyramid


def corr_pyramid_sample(
    pyramid: Sequence[torch.Tensor],
    coords: torch.Tensor,
    track_feats: torch.Tensor,
    radius: int,
) -> torch.Tensor:
    """Correlation features <track_feat, fmap(window)> / sqrt(C) on a
    feature pyramid (the reference's CorrBlock.corr + CorrBlock.sample,
    with its zero padding).

    pyramid: [B, S, Hl, Wl, C] maps, level l downsampled 2^l; coords
    [B, S, N, 2] at level 0 (x, y); track_feats [B, S, N, C]. Returns
    [B, S, N, L * (2r+1)^2] in track_feats' dtype, levels in pyramid order.
    Every track is sampled on its own, so the result of a slice of the track
    axis is that slice of the result (track sharding).
    """
    b, s, n, _ = coords.shape
    c = track_feats.shape[-1]
    tf = (track_feats * (1.0 / c ** 0.5)).reshape(b * s, n, c)
    pts = coords.reshape(b * s * n, 2).float()
    outs = []
    for lvl, f in enumerate(pyramid):
        hl, wl = f.shape[2], f.shape[3]
        vol = torch.matmul(tf, f.reshape(b * s, hl * wl, c).transpose(1, 2)).float()
        outs.append(_sample_windows(vol.reshape(b * s * n, hl, wl), pts / (2.0 ** lvl), radius))
    return torch.cat(outs, dim=-1).reshape(b, s, n, -1).to(track_feats.dtype)


def extract_patches(images: torch.Tensor, topleft: torch.Tensor, psize: int) -> torch.Tensor:
    """Integer-aligned patches [B, N, P, P, C] of images [B, H, W, C] at
    topleft [B, N, 2] (x, y) corners, clamped into the image
    (:func:`extract_patches_ex` in batch-major order)."""
    return extract_patches_ex(images, topleft, psize, track_major=False)


def extract_patches_ex(
    images: torch.Tensor, topleft: torch.Tensor, psize: int, track_major: bool = False
) -> torch.Tensor:
    """Integer-aligned patches: images [B, H, W, C], topleft [B, N, 2]
    integer (x, y) corners, clamped into [0, (W - psize, H - psize)].

    Returns [B, N, P, P, C], or [N, B, P, P, C] with track_major.
    """
    b, h, w, c = images.shape
    x0 = topleft[..., 0].long().clamp(0, w - psize)
    y0 = topleft[..., 1].long().clamp(0, h - psize)
    lin = torch.arange(psize, device=images.device)
    rows = y0[..., None] + lin  # [B, N, P]
    cols = x0[..., None] + lin
    base = torch.arange(b, device=images.device)[:, None, None, None] * (h * w)
    idx = base + (rows * w)[..., :, None] + cols[..., None, :]  # [B, N, P, P]
    if track_major:
        idx = idx.transpose(0, 1)
    return images.reshape(b * h * w, c)[idx]
