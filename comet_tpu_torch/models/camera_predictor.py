"""Camera pose predictor: ViT aggregator, trajectory fusion (T_P), temporal
reasoning (T_F) and the GAPR heads.

Counterpart of ``comet_tpu/models/camera_predictor.py``; the three ablations
are config flags. Reference quirks kept on purpose:

- the (already ImageNet-normalized) images are normalized a second time;
- attention blocks re-base the residual stream on normalized activations;
- frame-0 predictions are set to the identity pose.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..geometry.embeddings import sincos_2d_pos_embed, sincos_time_embed
from ..ops.bilinear import resize_bilinear_align_corners
from .blocks import AttnBlock, CrossAttnBlock, LayerNorm, Linear, Mlp, megatron_pair
from .vit import DinoViT

_RESNET_MEAN = (0.485, 0.456, 0.406)
_RESNET_STD = (0.229, 0.224, 0.225)


class CameraPredictions(NamedTuple):
    pred_pose_enc: torch.Tensor  # [B, S, 7] relative (trans 3, quat 4); frame 0 identity
    pre_head_feat: torch.Tensor  # [B, S, hidden]


class TrajectoryEncoder(nn.Module):
    """Linear(2 -> 256), LN, ReLU, Linear(256 -> out), LN. Under tensor
    parallelism fc1 (column-parallel) feeds a LayerNorm, which needs whole
    features, so its call all-gathers them; fc2 (row-parallel) then takes
    its slice of them and sums over the model axis."""

    def __init__(self, hidden_dim: int = 256, out_dim: int = 768, dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(2, hidden_dim, dtype)
        self.ln1 = LayerNorm(hidden_dim, 1e-6, dtype=dtype)
        self.fc2 = Linear(hidden_dim, out_dim, dtype)
        self.ln2 = LayerNorm(out_dim, 1e-6, dtype=dtype)

    def forward(self, traj):
        return self.ln2(self.fc2(F.relu(self.ln1(self.fc1(traj)))))


class ConfidenceAttention(nn.Module):
    """Linear(1 -> 32), ReLU, Linear(32 -> 1), sigmoid; a Megatron pair under
    tensor parallelism (the ReLU needs no whole features)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(1, 32, dtype)
        self.fc2 = Linear(32, 1, dtype)

    def forward(self, conf):
        return torch.sigmoid(megatron_pair(self.fc1, F.relu, self.fc2, conf))


class CameraPredictor(nn.Module):
    def __init__(
        self,
        hidden_size: int = 768,
        num_heads: int = 8,
        mlp_ratio: float = 4.0,
        att_depth: int = 4,
        trunk_depth: int = 4,
        down_size: int = 336,
        use_trajectory: bool = True,
        use_time: bool = True,
        use_gapr: bool = True,
        backbone_depth: int = 12,
        backbone_dim: int = 768,
        backbone_heads: int = 12,
        dtype=torch.float32,
        freeze_backbone: bool = True,
    ):
        super().__init__()
        c = hidden_size
        self.hidden_size, self.down_size, self.compute_dtype = c, down_size, dtype
        self.freeze_backbone = freeze_backbone
        self.use_trajectory, self.use_time, self.use_gapr = use_trajectory, use_time, use_gapr

        def blocks(cls, depth):
            return nn.ModuleList([cls(c, num_heads, mlp_ratio, dtype) for _ in range(depth)])

        self.backbone = DinoViT(
            img_size=down_size, embed_dim=backbone_dim, depth=backbone_depth,
            num_heads=backbone_heads, dtype=dtype,
        )
        self.input_transform = Mlp(backbone_dim, backbone_dim, c, dtype=dtype)
        self.norm2 = LayerNorm(c, 1e-6, affine=False, dtype=dtype)
        self.pose_token = nn.Parameter(torch.empty(1, 1, 1, c))
        self.self_att = blocks(AttnBlock, att_depth)
        self.cross_att = blocks(CrossAttnBlock, att_depth)
        if use_trajectory:
            self.traj_encoder = TrajectoryEncoder(out_dim=c, dtype=dtype)
            self.confidence_attention = ConfidenceAttention(dtype)
            self.cross_attn_block = blocks(CrossAttnBlock, att_depth)
        if use_time:
            self.trunk = blocks(AttnBlock, trunk_depth)
        if use_gapr:
            self.pose_branch = Mlp(c, c * 2, 4, dtype=dtype)
            self.fc_translation2d = Linear(c, 2, dtype)
            self.fc_depth = Linear(c, 1, dtype)
        else:
            self.pose_branch = Mlp(c, c * 2, 7, dtype=dtype)

    def init_own_params(self, generator):
        self.pose_token.normal_(0.0, 1e-6, generator=generator)

    def forward(
        self,
        images: torch.Tensor,  # [B, S, H, W, 3], ImageNet-normalized
        trajectories: Optional[torch.Tensor] = None,  # [B, S, N, 2]
        track_confidence: Optional[torch.Tensor] = None,  # [B, S, N]
    ) -> CameraPredictions:
        b, s = images.shape[:2]
        c, dt = self.hidden_size, self.compute_dtype
        rgb_feat = self._image_features(images)  # [B, S, C]

        if self.use_trajectory and trajectories is not None:
            n = trajectories.shape[2]
            traj = self.traj_encoder(trajectories.to(dt))  # [B, S, N, C]
            conf_w = self.confidence_attention(track_confidence[..., None].to(dt))
            traj_ctx = (traj * conf_w).reshape(b * s, n, c)
            rgb_flat = rgb_feat.reshape(b * s, 1, c)
            for blk in self.cross_attn_block:
                rgb_flat = blk(rgb_flat, traj_ctx)
            rgb_feat = rgb_feat + rgb_flat.reshape(b, s, c)

        if self.use_time:
            rgb_feat = rgb_feat + sincos_time_embed(c, s, images.device).to(rgb_feat.dtype)
            for blk in self.trunk:
                rgb_feat = blk(rgb_feat)

        if self.use_gapr:
            rot = self.pose_branch(rgb_feat)
            trans = torch.cat([self.fc_translation2d(rgb_feat), self.fc_depth(rgb_feat)], dim=-1)
        else:
            enc = self.pose_branch(rgb_feat)
            trans, rot = enc[..., :3], enc[..., 3:7]

        norm = torch.linalg.norm(rot.float(), dim=-1, keepdim=True).clamp_min(1e-8)
        rot = rot / norm.to(rot.dtype)
        pred = torch.cat([trans, rot], dim=-1).float()
        identity = pred.new_tensor([0, 0, 0, 1, 0, 0, 0])
        pred = torch.cat([identity.expand(b, 1, 7), pred[:, 1:]], dim=1)
        return CameraPredictions(pred_pose_enc=pred, pre_head_feat=rgb_feat)

    def _image_features(self, images: torch.Tensor) -> torch.Tensor:
        """ViT tokens (frozen under ``freeze_backbone``: no graph is
        recorded through the ViT, JAX's ``stop_gradient``), then pose-token
        aggregation: per-frame
        self-attention and cross-attention of frames 1.. to frame 0."""
        b, s, h, w, _ = images.shape
        c, dt = self.hidden_size, self.compute_dtype
        x = images.reshape(b * s, h, w, 3)
        x = resize_bilinear_align_corners(x, self.down_size, self.down_size)
        mean = x.new_tensor(_RESNET_MEAN)
        std = x.new_tensor(_RESNET_STD)
        x = (x - mean) / std  # second normalization, as in the reference

        with torch.no_grad() if self.freeze_backbone else contextlib.nullcontext():
            tokens = self.backbone(x.to(dt))  # [B*S, P, backbone_dim]
        tokens = self.norm2(self.input_transform(tokens))  # [B*S, P, C]
        p = tokens.shape[1]
        grid = int(round(p ** 0.5))
        pos = sincos_2d_pos_embed(c, (grid, grid), images.device).to(tokens.dtype)
        tokens = tokens.reshape(b, s, p, c) + pos[None, None]
        tokens = torch.cat([self.pose_token.to(tokens.dtype).expand(b, s, 1, c), tokens], dim=2)
        p1 = p + 1

        for self_blk, cross_blk in zip(self.self_att, self.cross_att):
            tokens = self_blk(tokens.reshape(b * s, p1, c)).reshape(b, s, p1, c)
            others = cross_blk(tokens[:, 1:].reshape(b, (s - 1) * p1, c), tokens[:, 0])
            tokens = torch.cat([tokens[:, :1], others.reshape(b, s - 1, p1, c)], dim=1)
        return tokens[:, :, 0]
