"""CNN feature encoders for the point tracker.

Counterpart of ``comet_tpu/models/encoders.py``. Inputs and outputs are
channel-last ([M, H, W, C]) as in the JAX package; the convolutions run on
NCHW tensors inside.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bilinear import resize_nchw
from .blocks import Conv2d, InstanceNorm, ResidualBlock


class BasicEncoder(nn.Module):
    """4-stage residual CNN -> output_dim channels at H/stride; the stages
    at 1/2, 1/4, 1/8 and 1/16 are resized to H/stride and concatenated."""

    def __init__(self, output_dim: int = 128, stride: int = 4, dtype=torch.float32):
        super().__init__()
        self.stride = stride
        half, three_q = output_dim // 2, output_dim // 4 * 3
        self.conv1 = Conv2d(3, half, 7, stride=2, padding=3, dtype=dtype)
        self.norm = InstanceNorm()

        def layer(cin, cout, stride):
            return nn.ModuleList([
                ResidualBlock(cin, cout, stride, dtype=dtype),
                ResidualBlock(cout, cout, 1, dtype=dtype),
            ])

        self.layer1 = layer(half, half, 1)
        self.layer2 = layer(half, three_q, 2)
        self.layer3 = layer(three_q, output_dim, 2)
        self.layer4 = layer(output_dim, output_dim, 2)
        self.conv2 = Conv2d(half + three_q + 2 * output_dim, output_dim * 2, 3, padding=1,
                            dtype=dtype)
        self.conv3 = Conv2d(output_dim * 2, output_dim, 1, dtype=dtype)

    def forward(self, x):
        """x [M, H, W, 3] -> [M, H/stride, W/stride, output_dim]."""
        h, w = x.shape[1], x.shape[2]
        oh, ow = h // self.stride, w // self.stride
        x = F.relu(self.norm(self.conv1(x.permute(0, 3, 1, 2))))
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer[1](layer[0](x))
            feats.append(x)
        x = torch.cat([resize_nchw(f, oh, ow) for f in feats], dim=1)
        x = F.relu(self.norm(self.conv2(x)))
        return self.conv3(x).permute(0, 2, 3, 1)


class ShallowEncoder(nn.Module):
    """3-layer CNN for the fine patches -> output_dim channels.

    resize_output=False returns the features at the CNN's native resolution
    (H/2 after conv1); the fine tracker folds the final upsample into its
    correlation volumes instead."""

    def __init__(self, output_dim: int = 32, stride: int = 1, dtype=torch.float32,
                 resize_output: bool = True):
        super().__init__()
        self.stride, self.resize_output = stride, resize_output
        self.conv1 = Conv2d(3, output_dim, 3, stride=2, padding=1, dtype=dtype)
        self.norm = InstanceNorm()
        self.layer1 = ResidualBlock(output_dim, output_dim, 2, dtype=dtype)
        self.layer2 = ResidualBlock(output_dim, output_dim, 2, dtype=dtype)
        self.conv2 = Conv2d(output_dim, output_dim, 1, dtype=dtype)

    def forward(self, x):
        """x [M, H, W, 3] -> [M, H', W', output_dim]."""
        h, w = x.shape[1], x.shape[2]
        x = F.relu(self.norm(self.conv1(x.permute(0, 3, 1, 2))))
        hh, ww = x.shape[-2:]
        tmp = self.layer1(x)
        x = x + resize_nchw(tmp, hh, ww)
        tmp = self.layer2(tmp)
        x = x + resize_nchw(tmp, hh, ww)
        x = self.conv2(x) + x
        if self.resize_output:
            x = resize_nchw(x, h // self.stride, w // self.stride)
        return x.permute(0, 2, 3, 1)
