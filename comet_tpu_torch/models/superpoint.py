"""SuperPoint keypoint detector and descriptor.

Counterpart of ``comet_tpu/models/superpoint.py``: a VGG-style encoder, a
65-channel detector head (8 x 8 cells and a dustbin) and a 256-d descriptor
head, with static-shape keypoint extraction (iterated max-pool NMS, a score
threshold, top-k). The convolutions run on NCHW tensors; the heads' outputs
come back channel-last, as the JAX package's are. Parameter names mirror the
flax tree (``backbone.conv1a.weight``), so ``weights.module_params_from_jax``
carries a JAX checkpoint across.

The top-k keeps ``jax.lax.top_k``'s order: among equal scores the lowest
flat index first. The heatmap's sub-threshold padding is all exact zeros, so
which zero-score pixels fill the last slots depends on that order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bilinear import bilinear_sample
from .blocks import Conv2d

_CONVS = (("conv1a", 1, 64), ("conv1b", 64, 64), ("conv2a", 64, 64), ("conv2b", 64, 64),
          ("conv3a", 64, 128), ("conv3b", 128, 128), ("conv4a", 128, 128), ("conv4b", 128, 128))


class SuperPointOutput(NamedTuple):
    keypoints: torch.Tensor  # [K, 2] (x, y) pixels
    scores: torch.Tensor  # [K]
    descriptors: torch.Tensor  # [K, 256]


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True).clamp_min(1e-8)
    return x / n.to(x.dtype)


class SuperPointBackbone(nn.Module):
    """Encoder and both heads. Input [B, 1, H, W] grayscale in [0, 1], H
    and W multiples of 8 -> (semi [B, H/8, W/8, 65], unit descriptors
    [B, H/8, W/8, 256])."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        for name, cin, cout in _CONVS:
            setattr(self, name, Conv2d(cin, cout, 3, padding=1, dtype=dtype))
        self.convPa = Conv2d(128, 256, 3, padding=1, dtype=dtype)
        self.convPb = Conv2d(256, 65, 1, dtype=dtype)
        self.convDa = Conv2d(128, 256, 3, padding=1, dtype=dtype)
        self.convDb = Conv2d(256, 256, 1, dtype=dtype)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        for i, (name, _, _) in enumerate(_CONVS):
            x = F.relu(getattr(self, name)(x))
            if i in (1, 3, 5):
                x = F.max_pool2d(x, 2, 2)
        semi = self.convPb(F.relu(self.convPa(x))).permute(0, 2, 3, 1)
        desc = self.convDb(F.relu(self.convDa(x))).permute(0, 2, 3, 1)
        return semi, _l2_normalize(desc)


def scores_from_semi(semi: torch.Tensor) -> torch.Tensor:
    """[B, H/8, W/8, 65] -> dense keypoint heatmap [B, H, W]."""
    probs = torch.softmax(semi, dim=-1)[..., :64]  # drop the dustbin
    b, hc, wc, _ = probs.shape
    return probs.reshape(b, hc, wc, 8, 8).permute(0, 1, 3, 2, 4).reshape(b, hc * 8, wc * 8)


def simple_nms(scores: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Iterated max-pool NMS on [B, H, W] (gluefactory_nonfree semantics)."""
    size = 2 * radius + 1

    def max_pool(x):
        return F.max_pool2d(x[:, None], size, stride=1, padding=radius)[:, 0]

    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool(scores)
    for _ in range(2):
        supp_mask = max_pool(max_mask.to(scores.dtype)) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool(supp_scores)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def top_k(flat: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` on the last axis: the k largest values, equal ones
    in order of their index (a stable descending sort; ``torch.topk`` leaves
    the order of ties unspecified)."""
    values, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def extract_keypoints(
    heatmap: torch.Tensor,  # [H, W]
    max_keypoints: int = 512,
    threshold: float = 0.005,
    nms_radius: int = 4,
    border: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape top-k extraction -> ([K, 2] xy, [K] scores); points under
    the threshold or in the border keep score 0."""
    h, w = heatmap.shape
    s = simple_nms(heatmap[None], nms_radius)[0]
    mask = torch.zeros_like(s)
    mask[border:h - border, border:w - border] = 1.0
    s = s * mask
    s = torch.where(s >= threshold, s, 0.0)
    scores, idx = top_k(s.reshape(-1), max_keypoints)
    ys = torch.div(idx, w, rounding_mode="floor").float()
    xs = (idx % w).float()
    return torch.stack([xs, ys], dim=-1), scores


def sample_descriptors(desc_map: torch.Tensor, keypoints: torch.Tensor,
                       stride: int = 8) -> torch.Tensor:
    """Bilinear samples of the coarse descriptor map [H/8, W/8, D] at the
    keypoints (border padding), L2-normalized."""
    pts = (keypoints - stride / 2 + 0.5) / stride
    return _l2_normalize(bilinear_sample(desc_map, pts))


class SuperPoint(nn.Module):
    """Grayscale image -> keypoints, scores and descriptors."""

    def __init__(self, max_keypoints: int = 512, detection_threshold: float = 0.005,
                 nms_radius: int = 4, dtype=torch.float32):
        super().__init__()
        self.max_keypoints = max_keypoints
        self.detection_threshold = detection_threshold
        self.nms_radius = nms_radius
        self.backbone = SuperPointBackbone(dtype)

    def forward(self, image: torch.Tensor) -> SuperPointOutput:
        """image: [H, W] or [H, W, 1] grayscale in [0, 1]."""
        if image.dim() == 3:
            image = image[..., 0]
        semi, desc = self.backbone(image[None, None])
        heat = scores_from_semi(semi)[0]
        kps, scores = extract_keypoints(heat, self.max_keypoints, self.detection_threshold,
                                        self.nms_radius)
        return SuperPointOutput(kps, scores, sample_descriptors(desc[0], kps))
