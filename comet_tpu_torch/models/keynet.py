"""KeyNet detector and HardNet descriptor.

Counterpart of ``comet_tpu/models/keynet.py`` (glue-factory's
KeyNetAffNetHardNet extractor, wrapping kornia's KeyNetHardNet):

- KeyNet: a fixed filter bank of first and second derivatives and their
  products (10 channels) into a learned block of three 5 x 5 convs with
  BatchNorm (running statistics) and ReLU and a 1 x 1 score conv, over a
  3-level pyramid (factor 1.2); each level's score map is resized to full
  resolution and summed; NMS (radius 7) and top-k pick the keypoints;
- HardNet: upright 32 x 32 patches around the keypoints through seven convs
  with BatchNorm and ReLU, a 128-d L2-normalized descriptor. AffNet's affine
  shape and orientation are reduced to upright unit-scale patches, as in the
  JAX package (``scales`` 1, ``oris`` 0).

The pyramid's downscale is ``jax.image.resize(..., "linear")``, which
antialiases when it shrinks: here ``F.interpolate(..., antialias=True)``.
The networks run on NCHW tensors; parameter names mirror the flax tree and
the BatchNorms' statistics come from its ``batch_stats``
(``weights.module_params_from_jax``). The top-k keeps ``jax.lax.top_k``'s
order (the stable ``superpoint.top_k``). :func:`convert_hardnet_state_dict`
maps kornia's HardNet checkpoint onto the flax variables, as the JAX
package's converter does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.corr import extract_patches
from .blocks import BatchNorm, Conv2d
from .superpoint import top_k


class KeyNetOutput(NamedTuple):
    keypoints: torch.Tensor  # [K, 2] (x, y) pixels
    scores: torch.Tensor  # [K]
    descriptors: torch.Tensor  # [K, 128]
    valid: torch.Tensor  # [K] bool
    scales: torch.Tensor  # [K] 1 (upright, unit scale)
    oris: torch.Tensor  # [K] 0


def _sobel(device, dtype) -> torch.Tensor:
    gx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                      device=device, dtype=dtype) / 8.0
    return gx


def handcrafted_block(x: torch.Tensor) -> torch.Tensor:
    """[B, 1, H, W] -> [B, 10, H, W]: gx, gy, gx^2, gy^2, gx gy, gxx, gyy,
    gxy, gxx gyy, (gx gy)^2 from Sobel filters with zero padding (kornia's
    ``_HandcraftedBlock``)."""
    kx = _sobel(x.device, x.dtype)

    def dconv(t, k):
        return F.conv2d(t, k[None, None], padding=1)

    gx, gy = dconv(x, kx), dconv(x, kx.T)
    gxx, gyy, gxy = dconv(gx, kx), dconv(gy, kx.T), dconv(gx, kx.T)
    return torch.cat([gx, gy, gx * gx, gy * gy, gx * gy, gxx, gyy, gxy, gxx * gyy,
                      (gx * gy) ** 2], dim=1)


class KeyNetLearned(nn.Module):
    """Three (conv 5 x 5 -> BatchNorm -> ReLU) and a 1 x 1 score conv."""

    def __init__(self, ch: int = 8, in_ch: int = 10, dtype=torch.float32):
        super().__init__()
        for i in range(3):
            setattr(self, f"conv{i}", Conv2d(in_ch if i == 0 else ch, ch, 5, padding=2,
                                             dtype=dtype, bias=False))
            setattr(self, f"bn{i}", BatchNorm(ch))
        self.score = Conv2d(ch, 1, 1, dtype=dtype)

    def forward(self, x):
        for i in range(3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return self.score(x)


class HardNet(nn.Module):
    """[N, 1, 32, 32] patches -> [N, 128] unit descriptors: each patch
    normalized by its mean and standard deviation, six 3 x 3 convs (32, 32,
    64/2, 64, 128/2, 128 channels/stride) and a final 8 x 8 valid conv, each
    with BatchNorm (and ReLU but for the last)."""

    PLAN = ((32, 1), (32, 1), (64, 2), (64, 1), (128, 2), (128, 1))

    def __init__(self, dtype=torch.float32):
        super().__init__()
        cin = 1
        for i, (ch, stride) in enumerate(self.PLAN):
            setattr(self, f"conv{i}", Conv2d(cin, ch, 3, stride=stride, padding=1, dtype=dtype,
                                             bias=False))
            setattr(self, f"bn{i}", BatchNorm(ch))
            cin = ch
        self.conv6 = Conv2d(128, 128, 8, dtype=dtype, bias=False)
        self.bn6 = BatchNorm(128)

    def forward(self, patches):
        x = patches.float()
        sd, mu = torch.std_mean(x, dim=(1, 2, 3), keepdim=True, unbiased=False)
        x = (x - mu) / (sd + 1e-7)
        for i in range(len(self.PLAN)):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        d = self.bn6(self.conv6(x)).reshape(x.shape[0], 128).float()
        return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-8)


class KeyNetHardNet(nn.Module):
    """Multi-scale KeyNet score -> NMS top-k -> HardNet descriptors of
    upright 32 x 32 patches."""

    def __init__(self, max_keypoints: int = 512, num_levels: int = 3, scale_factor: float = 1.2,
                 nms_radius: int = 7, dtype=torch.float32):
        super().__init__()
        self.max_keypoints, self.num_levels = max_keypoints, num_levels
        self.scale_factor, self.nms_radius = scale_factor, nms_radius
        self.learned = KeyNetLearned(dtype=dtype)
        self.hardnet = HardNet(dtype=dtype)

    def forward(self, image: torch.Tensor) -> KeyNetOutput:
        """image: [H, W] or [H, W, 1 or 3] in [0, 1] (RGB weighted to gray)."""
        if image.dim() == 2:
            image = image[..., None]
        if image.shape[-1] == 3:
            image = (image * torch.tensor([0.299, 0.587, 0.114], dtype=image.dtype,
                                          device=image.device)).sum(-1, keepdim=True)
        h, w = image.shape[:2]
        x0 = image.float().permute(2, 0, 1)[None]  # [1, 1, H, W]
        total = torch.zeros(1, 1, h, w, device=image.device)
        for lvl in range(self.num_levels):
            cur = x0
            if lvl > 0:
                nh = max(int(round(h / self.scale_factor ** lvl)), 8)
                nw = max(int(round(w / self.scale_factor ** lvl)), 8)
                cur = F.interpolate(x0, size=(nh, nw), mode="bilinear", align_corners=False,
                                    antialias=True)
            score = self.learned(handcrafted_block(cur)).float()
            if score.shape[-2:] != (h, w):
                score = F.interpolate(score, size=(h, w), mode="bilinear", align_corners=False)
            total = total + score
        heat = F.relu(total[0, 0])
        r = self.nms_radius
        local_max = F.max_pool2d(heat[None, None], 2 * r + 1, stride=1, padding=r)[0, 0]
        is_peak = (heat >= local_max) & (heat > 0)
        scores, idx = top_k(torch.where(is_peak, heat, -torch.inf).reshape(-1),
                            self.max_keypoints)
        kpts = torch.stack([(idx % w).float(), torch.div(idx, w, rounding_mode="floor").float()],
                           -1)
        valid = torch.isfinite(scores)
        scores = torch.where(valid, scores, 0.0)
        # upright 32 x 32 patches (AffNet reduced to the identity shape)
        corner = kpts.long() - 16
        topleft = torch.stack([corner[:, 0].clamp(0, w - 32), corner[:, 1].clamp(0, h - 32)], -1)
        patches = extract_patches(image[None].float(), topleft[None], 32)[0]  # [K, 32, 32, 1]
        descs = self.hardnet(patches.permute(0, 3, 1, 2))
        k = self.max_keypoints
        return KeyNetOutput(kpts, scores, descs, valid,
                            torch.ones(k, device=image.device), torch.zeros(k, device=image.device))


def convert_hardnet_state_dict(state_dict, template_params):
    """kornia's HardNet ``features.N.{weight, bias, running_mean,
    running_var}`` on the flax variables ``template_params`` of a HardNet
    (e.g. ``weights.module_params_to_jax(HardNet())``), as the JAX package's
    converter maps them: kornia's Sequential holds the convs at 0, 3, ..., 18
    and the BatchNorms at 1, 4, ..., 19; conv kernels OIHW -> HWIO, running
    statistics into ``batch_stats``."""
    import numpy as np

    from ..weights import numpy_tree

    params = numpy_tree(template_params)
    conv_idx = [0, 3, 6, 9, 12, 15, 18]
    bn_idx = [1, 4, 7, 10, 13, 16, 19]

    def put(section, path, val):
        node = params[section]
        for p in path[:-1]:
            node = node[p]
        if node[path[-1]].shape != val.shape:
            raise ValueError(f"{'/'.join(path)}: shape {val.shape} != template "
                             f"{node[path[-1]].shape}")
        node[path[-1]] = val

    stat = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}
    for k, v in state_dict.items():
        v = np.asarray(v)
        parts = k.split(".")
        if parts[0] != "features":
            continue
        i, leaf = int(parts[1]), parts[-1]
        if i in conv_idx and leaf == "weight":
            put("params", (f"conv{conv_idx.index(i)}", "kernel"), v.transpose(2, 3, 1, 0))
        elif i in bn_idx and leaf in stat:
            section, name = stat[leaf]
            put(section, (f"bn{bn_idx.index(i)}", name), v)
    return params
