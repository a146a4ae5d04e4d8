"""Iterative point tracker (CoTracker2-style).

Counterpart of ``comet_tpu/models/tracker.py``: correlation sampling
(ops/corr), an EfficientUpdateFormer step per iteration, a GroupNorm ->
Linear -> GELU update of the track features over flattened [B*N*S, C] rows,
and frame-0 coordinates pinned to the queries after every iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ..geometry.embeddings import embed_2d_coords, sincos_2d_pos_embed_grid
from ..ops.bilinear import resize_bilinear_align_corners, sample_features
from ..ops.corr import corr_volume_pyramid_sample
from .blocks import GroupNorm1, Linear, gelu
from .update_former import EfficientUpdateFormer


def tracker_transformer_dim(corr_levels: int, corr_radius: int, latent_dim: int, fine: bool) -> int:
    """Input width of the update transformer, with the reference's padding."""
    dim = corr_levels * (2 * corr_radius + 1) ** 2 + latent_dim * 2
    if fine:
        dim += 4 if dim % 2 == 0 else 5
    else:
        dim += (4 - dim % 4) % 4
    return dim


class TrackerOutput(NamedTuple):
    coord_preds: torch.Tensor  # [iters, B, S, N, 2] in input-image scale
    vis: Optional[torch.Tensor]  # [B, S, N] (coarse only)
    conf: Optional[torch.Tensor]  # [B, S, N] (if enabled)
    track_feats: torch.Tensor  # [B, S, N, C]
    query_feats: torch.Tensor  # [B, N, C]


class BaseTracker(nn.Module):
    def __init__(
        self,
        stride: int = 4,
        corr_levels: int = 5,
        corr_radius: int = 4,
        latent_dim: int = 128,
        hidden_size: int = 384,
        use_space_attn: bool = True,
        depth: int = 6,
        fine: bool = False,
        predict_conf: bool = False,
        dtype=torch.float32,
        corr_size: Optional[Tuple[int, int]] = None,
    ):
        super().__init__()
        self.stride, self.corr_levels, self.corr_radius = stride, corr_levels, corr_radius
        self.latent_dim, self.fine, self.compute_dtype = latent_dim, fine, dtype
        # fmaps arrive at a smaller native size; the align-corners upsample to
        # corr_size is folded into the correlation volumes (ops/corr)
        self.corr_size = corr_size
        self.tdim = tracker_transformer_dim(corr_levels, corr_radius, latent_dim, fine)
        self.updateformer = EfficientUpdateFormer(
            input_dim=self.tdim,
            space_depth=depth if use_space_attn else 0,
            time_depth=depth,
            hidden_size=hidden_size,
            output_dim=latent_dim + 2,
            add_space_attn=use_space_attn,
            dtype=dtype,
        )
        self.ffeat_norm = GroupNorm1(latent_dim)
        self.ffeat_updater = Linear(latent_dim, latent_dim, dtype)
        self.vis_predictor = None if fine else Linear(latent_dim, 1, dtype)
        self.conf_predictor = Linear(latent_dim, 1, dtype) if predict_conf else None

    def forward(
        self,
        query_points: torch.Tensor,  # [B, N, 2] pixel coords in input images
        fmaps: torch.Tensor,  # [B, S, HH, WW, C]
        iters: int = 4,
        down_ratio: int = 1,
    ) -> TrackerOutput:
        b, s, hh, ww, _ = fmaps.shape
        if self.corr_size is not None:
            hh, ww = self.corr_size
        n = query_points.shape[1]
        c = self.latent_dim

        scale = float(self.stride) * float(down_ratio)
        coords0 = query_points / scale
        coords = coords0[:, None].expand(b, s, n, 2)

        frame0 = fmaps[:, 0]
        if self.corr_size is not None:
            # only frame 0 is resized, for the query features
            frame0 = resize_bilinear_align_corners(frame0, hh, ww)
        query_feats = sample_features(frame0, coords0)  # [B, N, C]
        track_feats = query_feats[:, None].expand(b, s, n, c)

        pos_grid = sincos_2d_pos_embed_grid(self.tdim, (hh, ww), fmaps.device)
        pos_grid = pos_grid.to(self.compute_dtype)
        sampled_pos = sample_features(pos_grid[None].expand(b, hh, ww, self.tdim), coords0)

        coord_preds = []
        for _ in range(iters):
            coords = coords.detach()  # each iteration's gradient stops here, as in JAX
            fcorrs = corr_volume_pyramid_sample(
                fmaps, coords, track_feats, self.corr_radius, self.corr_levels,
                out_size=(hh, ww) if self.corr_size is not None else None,
            )  # [B, S, N, L*K]
            flows_bn = (coords - coords[:, 0:1]).permute(0, 2, 1, 3)  # [B, N, S, 2]
            flows_emb = embed_2d_coords(flows_bn, c // 2, cat_coords=False)
            tfeats_bn = track_feats.permute(0, 2, 1, 3)
            x = torch.cat(
                [flows_emb, flows_bn, fcorrs.permute(0, 2, 1, 3), tfeats_bn], dim=-1
            )
            pad = self.tdim - x.shape[-1]
            if pad > 0:
                x = torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], dim=-1)
            x = x + sampled_pos[:, :, None, :]

            delta = self.updateformer(x.to(self.compute_dtype))  # [B, N, S, C+2]
            delta_coords = delta[..., :2].to(coords.dtype)
            delta_feats = delta[..., 2:]
            normed = self.ffeat_norm(delta_feats.reshape(-1, c)).reshape(delta_feats.shape)
            update = gelu(self.ffeat_updater(normed))
            track_feats = (tfeats_bn + update).permute(0, 2, 1, 3)

            coords = coords + delta_coords.permute(0, 2, 1, 3)
            coords = torch.cat([coords0[:, None], coords[:, 1:]], dim=1)  # pin frame 0
            coord_preds.append(coords * scale)

        vis = conf = None
        if self.vis_predictor is not None:
            vis = torch.sigmoid(self.vis_predictor(track_feats))[..., 0]
        if self.conf_predictor is not None:
            conf = torch.sigmoid(self.conf_predictor(track_feats))[..., 0]
        return TrackerOutput(
            coord_preds=torch.stack(coord_preds, dim=0),
            vis=vis,
            conf=conf,
            track_feats=track_feats,
            query_feats=query_feats,
        )
