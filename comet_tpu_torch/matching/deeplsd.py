"""DeepLSD stand-in: a CNN predicts line attraction fields, and segments are
marched out of them by the LSD stand-in's core.

Counterpart of ``comet_tpu/matching/deeplsd.py`` (glue-factory's
models/lines/deeplsd.py): an encoder-decoder regresses a distance-to-line
field and a line orientation, and extraction runs
``lines.march_segments_from_fields`` on the surrogate edge strength
``exp(-df / tau)`` with normals ``angle + pi / 2``. The angle head predicts
(cos 2a, sin 2a); its ``atan2`` decode is detached (the JAX package's
``stop_gradient``), and training supervises the vector (``angle_vec``).

The network's parameter names mirror the flax paths (``enc1.conv1``, ...),
so ``weights.module_params_from_jax`` carries the JAX package's weights
across. :class:`DeepLSDDetector` (``lines_deeplsd``) builds its network on
the CPU, with random weights from ``torch.Generator().manual_seed(0)`` (the
JAX package initializes from ``PRNGKey(0)``) or the flax tree put in its
``params``, and keeps one copy per device.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.blocks import Conv2d
from .lines import LineSegments, march_segments_from_fields
from .registry import register_model


class _ConvBlock(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = Conv2d(cin, features, 3, padding=1)
        self.conv2 = Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return torch.relu(self.conv2(torch.relu(self.conv1(x))))


class DeepLSDNet(nn.Module):
    """The encoder-decoder of the two attraction fields. Takes one image
    [H, W] or [H, W, C] and returns {"df": [H, W] >= 0, "angle": [H, W] in
    [0, pi), "angle_vec": [H, W, 2]}."""

    def __init__(self, base: int = 32, in_ch: int = 1):
        super().__init__()
        self.base = base
        self.enc1 = _ConvBlock(in_ch, base)
        self.enc2 = _ConvBlock(base, 2 * base)
        self.bottleneck = _ConvBlock(2 * base, 4 * base)
        self.dec2 = _ConvBlock(6 * base, 2 * base)
        self.dec1 = _ConvBlock(3 * base, base)
        self.df_head = Conv2d(base, 1, 1)
        self.angle_head = Conv2d(base, 2, 1)

    def forward(self, gray: torch.Tensor) -> Dict[str, torch.Tensor]:
        if gray.dim() not in (2, 3):
            raise ValueError(f"expected [H, W](, C), got {tuple(gray.shape)}")
        x = gray[..., None] if gray.dim() == 2 else gray
        x = x.permute(2, 0, 1)[None]  # [1, C, H, W]
        e1 = self.enc1(x)
        e2 = self.enc2(F.max_pool2d(e1, 2))
        b = self.bottleneck(F.max_pool2d(e2, 2))
        # jax.image.resize's "bilinear" upsampling: half-pixel centres, edges held
        u2 = F.interpolate(b, size=e2.shape[-2:], mode="bilinear", align_corners=False)
        u2 = self.dec2(torch.cat([u2, e2], dim=1))
        u1 = F.interpolate(u2, size=e1.shape[-2:], mode="bilinear", align_corners=False)
        u1 = self.dec1(torch.cat([u1, e1], dim=1))
        df = F.softplus(self.df_head(u1))[0, 0]
        ab = self.angle_head(u1)[0].permute(1, 2, 0)  # [H, W, 2]
        angle = 0.5 * torch.atan2(ab[..., 1].detach(), ab[..., 0].detach())  # [-pi/2, pi/2)
        angle = torch.where(angle < 0, angle + torch.pi, angle)
        return {"df": df, "angle": angle, "angle_vec": ab}


def extract_lines_from_fields(
    df: torch.Tensor,  # [H, W] distance-to-line field
    angle: torch.Tensor,  # [H, W] line orientation in [0, pi)
    tau: float = 1.5,
    max_lines: int = 64,
    **march_kw,
) -> LineSegments:
    """Segments from the fields: edge strength exp(-df / tau), normals
    perpendicular to the predicted orientation."""
    kw = dict(mag_threshold=0.3, angle_tol=0.4)
    kw.update(march_kw)
    return march_segments_from_fields(torch.exp(-df / tau), angle + torch.pi / 2.0,
                                      max_lines=max_lines, **kw)


def deeplsd_field_loss(
    pred: Dict[str, torch.Tensor],
    gt_df: torch.Tensor,
    gt_angle: torch.Tensor,
    df_clip: float = 5.0,
) -> torch.Tensor:
    """L1 on the clipped, normalized distance field plus the squared error
    of the normalized (cos 2a, sin 2a) vector, weighted toward pixels near
    lines."""
    p_df = pred["df"].clamp(0.0, df_clip) / df_clip
    g_df = gt_df.clamp(0.0, df_clip) / df_clip
    l_df = (p_df - g_df).abs().mean()
    w = torch.exp(-gt_df / df_clip)
    ab = pred["angle_vec"]
    abn = ab / torch.sqrt((ab * ab).sum(-1, keepdim=True) + 1e-6)
    gt_vec = torch.stack([torch.cos(2.0 * gt_angle), torch.sin(2.0 * gt_angle)], dim=-1)
    l_ang = (w * ((abn - gt_vec) ** 2).sum(-1)).sum() / w.sum().clamp_min(1e-6)
    return l_df + l_ang


class DeepLSDDetector:
    """The registry-facing detector: network and extraction. ``params``
    takes a flax tree of the JAX package's ``DeepLSDNet``; the next call
    loads it. A gray image runs where it lives; a numpy one goes to
    ``device`` (the card by default)."""

    def __init__(self, base=32, tau=1.5, max_lines=64, device=None, **march_kw):
        self.net = DeepLSDNet(base=base)
        self.tau = tau
        self.max_lines = max_lines
        self.march_kw = march_kw
        self.device = device
        self.params = None
        self._key = None  # what self.net holds: "random" or the id of the loaded params
        self._on = {}

    def init(self, generator: Optional[torch.Generator] = None) -> nn.Module:
        """Random weights drawn on the CPU from ``generator`` (seed 0 by
        default); returns the network."""
        from ..models.blocks import init_params

        init_params(self.net, generator or torch.Generator().manual_seed(0))
        self.net.eval()
        self._key, self._on = "random", {}
        return self.net

    def module(self, device, params=None) -> nn.Module:
        """The network on ``device``, with ``params`` (else ``self.params``,
        else random weights)."""
        from ..weights import module_params_from_jax

        if params is None and self.params is None and self._key is None:
            self.init()
        params = params if params is not None else self.params
        if params is not None and self._key != id(params):
            self.net.load_state_dict(module_params_from_jax(params, self.net))
            self.net.eval()
            self._key, self._on = id(params), {}
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = copy.deepcopy(self.net).to(device)
        return self._on[device]

    def __call__(self, gray, params=None) -> LineSegments:
        from .extractors import as_image

        gray = as_image(gray, self.device, "lines_deeplsd")
        with torch.no_grad():
            fields = self.module(gray.device, params)(gray)
        return extract_lines_from_fields(fields["df"], fields["angle"], tau=self.tau,
                                         max_lines=self.max_lines, **self.march_kw)


register_model("lines_deeplsd", {"base": 32, "tau": 1.5, "max_lines": 64})(DeepLSDDetector)
