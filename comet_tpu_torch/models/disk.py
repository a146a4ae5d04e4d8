"""DISK keypoint detector and dense descriptor.

Counterpart of ``comet_tpu/models/disk.py`` (glue-factory's DISK extractor,
which wraps kornia's DISK): a thin U-Net of kernel-5 conv blocks (instance
norm without affine, conv, PReLU), average-pool down and nearest up with
skip concatenation, channels down [16, 32, 64, 64, 64] and up [64, 64, 64,
desc_dim + 1], giving a dense descriptor map and a one-channel keypoint
heatmap at full resolution; windowed-NMS top-k keypoint selection.

The network runs on NCHW tensors. Parameter names mirror the flax tree
(``unet.down.0.conv.weight`` for ``unet/down_0/conv/kernel``); each block's
PReLU slope ``prelu_alpha`` keeps flax's shape [1]. The top-k keeps
``jax.lax.top_k``'s order (the stable ``superpoint.top_k``): the heatmap is
-inf wherever no peak is, and those slots fill in index order.
:func:`convert_disk_state_dict` maps kornia's checkpoint onto the flax
variables, as the JAX package's converter does.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import Conv2d, InstanceNorm
from .superpoint import top_k


class DISKOutput(NamedTuple):
    keypoints: torch.Tensor  # [B, K, 2] (x, y) pixels
    scores: torch.Tensor  # [B, K] heatmap logits at the keypoints (0 where invalid)
    descriptors: torch.Tensor  # [B, K, desc_dim] L2-normalized
    valid: torch.Tensor  # [B, K] bool: False for slots no peak filled


class ConvBlock(nn.Module):
    """Instance norm (no affine, eps 1e-5) -> conv 5x5 -> PReLU (one slope)."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.norm = InstanceNorm(1e-5)
        self.conv = Conv2d(cin, cout, 5, padding=2, dtype=dtype)
        self.prelu_alpha = nn.Parameter(torch.full((1,), 0.25))

    def init_own_params(self, generator):
        self.prelu_alpha.fill_(0.25)

    def forward(self, x):
        x = self.conv(self.norm(x))
        return torch.where(x >= 0, x, self.prelu_alpha.to(x.dtype) * x)


class DISKUnet(nn.Module):
    """Thin U-Net on [B, in_ch, H, W] (H, W multiples of 16): len(down) - 1
    average-pool downsamples, as many nearest upsamples, each concatenated
    with its skip -> [B, up[-1], H, W]."""

    def __init__(self, down: Sequence[int] = (16, 32, 64, 64, 64),
                 up: Sequence[int] = (64, 64, 64, 129), in_ch: int = 3, dtype=torch.float32):
        super().__init__()
        cins = (in_ch,) + tuple(down[:-1])
        self.down = nn.ModuleList(ConvBlock(ci, co, dtype) for ci, co in zip(cins, down))
        ups, cur = [], down[-1]
        for j, ch in enumerate(up):
            ups.append(ConvBlock(cur + down[len(down) - 2 - j], ch, dtype))
            cur = ch
        self.up = nn.ModuleList(ups)

    def forward(self, x):
        skips = []
        for i, block in enumerate(self.down):
            if i > 0:
                x = F.avg_pool2d(x, 2)
            x = block(x)
            skips.append(x)
        for j, block in enumerate(self.up):
            x = x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)  # nearest x2
            x = block(torch.cat([x, skips[len(self.down) - 2 - j]], dim=1))
        return x


def heatmap_to_keypoints(heatmap: torch.Tensor, n: int, window_size: int = 5,
                         score_threshold: float = 0.0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kornia's ``heatmap_to_keypoints`` with static shapes on [H, W] logits:
    a pixel that is the maximum of its window and above the threshold is a
    peak; the top n peaks -> (keypoints [n, 2] xy, scores [n], 0 where
    invalid, valid [n])."""
    h, w = heatmap.shape
    r = window_size // 2
    local_max = F.max_pool2d(heatmap[None, None], window_size, stride=1, padding=r)[0, 0]
    is_peak = (heatmap >= local_max) & (heatmap > score_threshold)
    scores, idx = top_k(torch.where(is_peak, heatmap, -torch.inf).reshape(-1), n)
    kpts = torch.stack([(idx % w).float(), torch.div(idx, w, rounding_mode="floor").float()], -1)
    valid = torch.isfinite(scores)
    return kpts, torch.where(valid, scores, 0.0), valid


class DISK(nn.Module):
    """U-Net -> heatmap and descriptor map -> NMS top-k -> each keypoint's
    L2-normalized descriptor."""

    def __init__(self, desc_dim: int = 128, max_keypoints: int = 512, nms_window_size: int = 5,
                 detection_threshold: float = 0.0, in_ch: int = 3, dtype=torch.float32):
        super().__init__()
        self.desc_dim, self.max_keypoints = desc_dim, max_keypoints
        self.nms_window_size, self.detection_threshold = nms_window_size, detection_threshold
        self.unet = DISKUnet(up=(64, 64, 64, desc_dim + 1), in_ch=in_ch, dtype=dtype)

    def forward(self, image: torch.Tensor) -> DISKOutput:
        """image: [B, H, W, in_ch] in [0, 1], H and W multiples of 16."""
        out = self.unet(image.permute(0, 3, 1, 2))
        heat = out[:, self.desc_dim].float()
        rows = []
        for b in range(image.shape[0]):
            kpts, scores, valid = heatmap_to_keypoints(heat[b], self.max_keypoints,
                                                       self.nms_window_size,
                                                       self.detection_threshold)
            d = out[b, :self.desc_dim, kpts[:, 1].long(), kpts[:, 0].long()].T.float()
            d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-8)
            rows.append((kpts, scores, d, valid))
        return DISKOutput(*(torch.stack(t) for t in zip(*rows)))


def convert_disk_state_dict(state_dict, template_params):
    """kornia's DISK tensors (``unet.path_down.N...``, ``unet.path_up.N...``)
    on the flax variables ``template_params`` (e.g.
    ``weights.module_params_to_jax(DISK())``), as the JAX package's converter
    maps them: conv kernels OIHW -> HWIO, PReLU slopes to shape [1]; leaves
    without a counterpart stay as the template has them."""
    import numpy as np

    from ..weights import numpy_tree

    params = numpy_tree(template_params)

    def put(path, val):
        node = params["params"]
        for p in path[:-1]:
            node = node[p]
        if node[path[-1]].shape != val.shape:
            raise ValueError(f"{'/'.join(path)}: shape {val.shape} != template "
                             f"{node[path[-1]].shape}")
        node[path[-1]] = val

    for k, v in state_dict.items():
        v = np.asarray(v)
        parts = k.split(".")
        if "path_down" in parts:
            block = ("unet", f"down_{int(parts[parts.index('path_down') + 1])}")
        elif "path_up" in parts:
            block = ("unet", f"up_{int(parts[parts.index('path_up') + 1])}")
        else:
            continue
        if parts[-1] == "weight" and v.ndim == 4:
            put(block + ("conv", "kernel"), v.transpose(2, 3, 1, 0))
        elif parts[-1] == "bias":
            put(block + ("conv", "bias"), v)
        elif v.ndim <= 1:  # a PReLU slope
            put(block + ("prelu_alpha",), v.reshape(1))
    return params
