"""ALIKED keypoint detector and sparse deformable descriptor head.

Counterpart of ``comet_tpu/models/aliked.py`` (glue-factory's ALIKED): a
conv / residual encoder with deformable convolutions in stages 3 and 4,
four scales squeezed to ``dim / 4`` channels each and upsampled (align
corners) to full resolution, a sigmoid score head, DKD keypoint detection
(NMS, top-k and a soft-argmax sub-pixel refinement) and the SDDH descriptor
head (M deformable samples per keypoint, aggregated by learned weights).

- :func:`deform_conv2d` is the JAX package's formulation of torchvision's
  ``deform_conv2d`` (stride 1, padding K // 2, zeros outside, torchvision's
  offset layout: tap t = i K + j has channels (2t, 2t + 1) = (dy, dx)):
  K x K bilinear gathers of the map and one matrix product, here on
  channel-last tensors as there;
- detection is a static top-k with a validity mask (score above the
  threshold); its ties (the NMS map is mostly zeros) keep ``jax.lax.top_k``'s
  index order (the stable ``superpoint.top_k``).

The encoder and heads run on NCHW tensors. Parameter names mirror the flax
tree; two keep flax's layout, as the weight bridge leaves every leaf that is
not a ``kernel``: a deformable conv's ``weight`` is [K, K, C, C_out] and
SDDH's ``agg_weights`` [M, C, C]. The BatchNorms' statistics come from
flax's ``batch_stats``. :func:`convert_aliked_state_dict` maps an upstream
torch checkpoint onto those variables, as the JAX package's converter does.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bilinear import resize_nchw, sample_features
from .blocks import BatchNorm, Conv2d, lecun_normal_
from .superpoint import simple_nms, top_k

# c1, c2, c3, c4, dim, K (sddh kernel), M (sddh positions)
ALIKED_CFGS = {
    "aliked-t16": dict(c1=8, c2=16, c3=32, c4=64, dim=64, k=3, m=16),
    "aliked-n16": dict(c1=16, c2=32, c3=64, c4=128, dim=128, k=3, m=16),
    "aliked-n16rot": dict(c1=16, c2=32, c3=64, c4=128, dim=128, k=3, m=16),
    "aliked-n32": dict(c1=16, c2=32, c3=64, c4=128, dim=128, k=3, m=32),
}

__all__ = ["ALIKED", "ALIKED_CFGS", "ALIKED_TORCH_MAP", "ALIKEDOutput", "ConvBlock",
           "DeformableConv2d", "ResBlock", "SDDH", "convert_aliked_state_dict", "deform_conv2d",
           "dkd_detect", "sddh_patch_corners", "simple_nms"]


class ALIKEDOutput(NamedTuple):
    keypoints: torch.Tensor  # [B, N, 2] (x, y) pixels
    scores: torch.Tensor  # [B, N]
    descriptors: torch.Tensor  # [B, N, dim]
    valid: torch.Tensor  # [B, N] bool (score above the detection threshold)
    dispersity: torch.Tensor  # [B, N]
    score_map: torch.Tensor  # [B, H, W]


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deformable convolution on channel-last maps: x [B, H, W, C], offsets
    [B, H, W, 2 K K] (torchvision's (dy, dx) per tap), kernel [K, K, C,
    C_out] -> [B, H, W, C_out]. Output pixel (h, w)'s tap (i, j) samples
    (h - K // 2 + i + dy, w - K // 2 + j + dx) bilinearly, zeros outside."""
    b, h, w, c = x.shape
    kh, kw, _, cout = kernel.shape
    pad = kh // 2
    off = offsets.reshape(b, h, w, kh * kw, 2)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=x.dtype, device=x.device),
                            torch.arange(w, dtype=x.dtype, device=x.device), indexing="ij")
    ky, kx = torch.meshgrid(torch.arange(kh, dtype=x.dtype, device=x.device) - pad,
                            torch.arange(kw, dtype=x.dtype, device=x.device) - pad,
                            indexing="ij")
    py = gy[..., None] + ky.reshape(-1) + off[..., 0]
    px = gx[..., None] + kx.reshape(-1) + off[..., 1]
    pts = torch.stack([px, py], dim=-1).reshape(b, h * w * kh * kw, 2)
    sampled = sample_features(x, pts, padding_mode="zeros").reshape(b, h * w, kh * kw * c)
    out = sampled @ kernel.reshape(kh * kw * c, cout).to(x.dtype)
    if bias is not None:
        out = out + bias
    return out.reshape(b, h, w, cout)


class DeformableConv2d(nn.Module):
    """A regular conv predicts each pixel's tap offsets, clipped to
    +-max(H, W) / 4, which drive a K x K deformable conv (no bias). NCHW in
    and out; ``weight`` in flax's [K, K, C, C_out] layout."""

    def __init__(self, cin: int, features: int, kernel: int = 3):
        super().__init__()
        self.kernel = kernel
        self.offset_conv = Conv2d(cin, 2 * kernel * kernel, kernel, padding=kernel // 2)
        self.weight = nn.Parameter(torch.empty(kernel, kernel, cin, features))

    def init_own_params(self, generator):
        # flax's lecun_normal over [K, K, C, C_out]: fan_in K * K * C
        lecun_normal_(self.weight.permute(3, 2, 0, 1), generator)

    def forward(self, x):
        off = self.offset_conv(x)
        max_off = max(x.shape[-2], x.shape[-1]) / 4.0
        off = off.clamp(-max_off, max_off).permute(0, 2, 3, 1)
        return deform_conv2d(x.permute(0, 2, 3, 1), off, self.weight).permute(0, 3, 1, 2)


def _conv3(cin: int, cout: int, conv_type: str) -> nn.Module:
    if conv_type == "dcn":
        return DeformableConv2d(cin, cout)
    return Conv2d(cin, cout, 3, padding=1, bias=False)


class ConvBlock(nn.Module):
    """(conv 3 x 3 -> BatchNorm -> SELU) twice."""

    def __init__(self, cin: int, features: int, conv_type: str = "conv"):
        super().__init__()
        self.conv1 = _conv3(cin, features, conv_type)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv3(features, features, conv_type)
        self.bn2 = BatchNorm(features)

    def forward(self, x):
        x = F.selu(self.bn1(self.conv1(x)))
        return F.selu(self.bn2(self.conv2(x)))


class ResBlock(nn.Module):
    """Residual block: conv -> BN -> SELU -> conv -> BN, plus a 1 x 1
    projection of the input, then SELU."""

    def __init__(self, cin: int, features: int, conv_type: str = "conv"):
        super().__init__()
        self.downsample = Conv2d(cin, features, 1)
        self.conv1 = _conv3(cin, features, conv_type)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv3(features, features, conv_type)
        self.bn2 = BatchNorm(features)

    def forward(self, x):
        idn = self.downsample(x)
        x = F.selu(self.bn1(self.conv1(x)))
        return F.selu(self.bn2(self.conv2(x)) + idn)


def dkd_detect(score_map: torch.Tensor, max_keypoints: int, nms_radius: int = 2,
               temperature: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable keypoint detection on [B, H, W] scores, static top-k:
    NMS (a border band of the radius zeroed), the top ``max_keypoints``,
    each refined by a soft-argmax over its (2r+1)^2 window -> (keypoints
    [B, N, 2] xy pixels, scores [B, N] sampled bilinearly at them,
    dispersity [B, N])."""
    b, h, w = score_map.shape
    r = nms_radius
    nms = simple_nms(score_map.detach(), r)
    ys = torch.arange(h, device=score_map.device)[:, None]
    xs = torch.arange(w, device=score_map.device)[None, :]
    border = (ys < r) | (ys >= h - r) | (xs < r) | (xs >= w - r)
    nms = torch.where(border, 0.0, nms)
    _, idx = top_k(nms.reshape(b, -1), max_keypoints)
    kx = (idx % w).to(score_map.dtype)
    ky = torch.div(idx, w, rounding_mode="floor").to(score_map.dtype)

    # each keypoint's window of the score map (which carries the gradient)
    d = torch.arange(-r, r + 1, device=score_map.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    wy = (ky.long()[..., None] + dy.reshape(-1)).clamp(0, h - 1)
    wx = (kx.long()[..., None] + dx.reshape(-1)).clamp(0, w - 1)
    bi = torch.arange(b, device=score_map.device)[:, None, None]
    patch = score_map[bi, wy, wx]  # [B, N, (2r+1)^2]
    grid = torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1).to(score_map.dtype)

    x_exp = torch.exp((patch - patch.amax(-1, keepdim=True).detach()) / temperature)
    denom = x_exp.sum(-1, keepdim=True)
    residual = (x_exp @ grid) / denom  # [B, N, 2] (dx, dy)
    dist2 = (((grid[None, None] - residual[..., None, :]) / r) ** 2).sum(-1)
    dispersity = (x_exp * dist2).sum(-1) / denom[..., 0]
    kpts = torch.stack([kx, ky], dim=-1) + residual
    score = sample_features(score_map[..., None], kpts)[..., 0]
    return kpts, score, dispersity


def sddh_patch_corners(kpts: torch.Tensor, hw: Tuple[int, int], ps: int) -> torch.Tensor:
    """The reference's patch corner: floor(kpt - ps / 2 + 1), clipped to
    [0, size - 1 - ps] (its conservative bound, kept for weight parity)."""
    h, w = hw
    corner = torch.floor(kpts - ps / 2 + 1).long()
    return torch.stack([corner[..., 0].clamp(0, w - 1 - ps), corner[..., 1].clamp(0, h - 1 - ps)],
                       dim=-1)


class _Dense(nn.Linear):
    """A bias-free flax Dense (lecun_normal)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, bias=False)

    def init_own_params(self, generator):
        lecun_normal_(self.weight, generator)


class SDDH(nn.Module):
    """Sparse deformable descriptor head: per keypoint a K x K feature patch
    gives M sample offsets (valid K x K conv, SELU, 1 x 1 conv, clipped to
    +-max(H, W) / 4); the features sampled there pass a shared bias-free
    projection and SELU and are summed with the learned ``agg_weights``
    [M, C, C]; the descriptor is L2-normalized."""

    def __init__(self, dims: int, kernel: int = 3, n_pos: int = 8):
        super().__init__()
        self.dims, self.kernel, self.n_pos = dims, kernel, n_pos
        self.offset_conv1 = Conv2d(dims, 2 * n_pos, kernel)
        self.offset_conv2 = Conv2d(2 * n_pos, 2 * n_pos, 1)
        self.sf_conv = _Dense(dims, dims)
        self.agg_weights = nn.Parameter(torch.empty(n_pos, dims, dims))

    def init_own_params(self, generator):
        self.agg_weights.uniform_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor, kpts: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] channel-last; kpts [B, N, 2] pixel (x, y) -> [B, N, C]."""
        b, h, w, c = x.shape
        n = kpts.shape[1]
        ps, m = self.kernel, self.n_pos
        bi = torch.arange(b, device=x.device)[:, None, None, None]
        if ps > 1:
            corners = sddh_patch_corners(kpts, (h, w), ps)
            lin = torch.arange(ps, device=x.device)
            rows = corners[..., 1][..., None] + lin  # [B, N, ps]
            cols = corners[..., 0][..., None] + lin
            patch = x[bi, rows[..., :, None], cols[..., None, :]]  # [B, N, ps, ps, C]
        else:  # the nearest pixel, clamped into the map (as JAX's gather clamps)
            pix = torch.round(kpts).long()
            patch = x[bi[..., 0, 0], pix[..., 1].clamp(0, h - 1), pix[..., 0].clamp(0, w - 1)]
            patch = patch.reshape(b, n, 1, 1, c)
        po = patch.reshape(b * n, ps, ps, c).permute(0, 3, 1, 2)
        po = self.offset_conv2(F.selu(self.offset_conv1(po)))
        max_off = max(h, w) / 4.0
        off = po.reshape(b, n, 2 * m).clamp(-max_off, max_off)
        off = torch.stack([off[..., :m], off[..., m:]], dim=-1)  # [B, N, M, 2]: first M x, last M y
        pos = kpts[:, :, None, :] + off
        feats = sample_features(x, pos.reshape(b, n * m, 2)).reshape(b, n, m, c)
        feats = F.selu(self.sf_conv(feats))
        desc = torch.einsum("bnmc,mcd->bnd", feats, self.agg_weights.to(feats.dtype))
        return desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp_min(1e-8)


class ALIKED(nn.Module):
    """The whole extractor on [B, H, W, in_ch] images in [0, 1] (RGB; the
    JAX package builds its network for the channels of the first image it
    sees, so a one-channel image takes a network of its own), H and W
    multiples of 32."""

    def __init__(self, model_name: str = "aliked-n16", max_keypoints: int = 512,
                 detection_threshold: float = 0.2, nms_radius: int = 2, in_ch: int = 3):
        super().__init__()
        cfg = ALIKED_CFGS[model_name]
        c1, c2, c3, c4, dim = cfg["c1"], cfg["c2"], cfg["c3"], cfg["c4"], cfg["dim"]
        self.max_keypoints, self.detection_threshold = max_keypoints, detection_threshold
        self.nms_radius = nms_radius
        self.block1 = ConvBlock(in_ch, c1, "conv")
        self.block2 = ResBlock(c1, c2, "conv")
        self.block3 = ResBlock(c2, c3, "dcn")
        self.block4 = ResBlock(c3, c4, "dcn")
        for i, c in enumerate((c1, c2, c3, c4), start=1):
            setattr(self, f"conv{i}", Conv2d(c, dim // 4, 1, bias=False))
        self.score_head0 = Conv2d(dim, 8, 1)
        self.score_head2 = Conv2d(8, 4, 3, padding=1)
        self.score_head4 = Conv2d(4, 4, 3, padding=1)
        self.score_head6 = Conv2d(4, 1, 3, padding=1)
        self.desc_head = SDDH(dim, cfg["k"], cfg["m"])

    def forward(self, image: torch.Tensor) -> ALIKEDOutput:
        _, h, w, _ = image.shape
        x1 = self.block1(image.float().permute(0, 3, 1, 2))
        x2 = self.block2(F.avg_pool2d(x1, 2))
        x3 = self.block3(F.avg_pool2d(x2, 4))
        x4 = self.block4(F.avg_pool2d(x3, 4))
        feats = []
        for i, x in enumerate((x1, x2, x3, x4), start=1):
            f = F.selu(getattr(self, f"conv{i}")(x))
            feats.append(resize_nchw(f, h, w))  # align corners; level 1 is full size
        x1234 = torch.cat(feats, dim=1)  # [B, dim, H, W]
        s = F.selu(self.score_head0(x1234))
        s = F.selu(self.score_head2(s))
        s = F.selu(self.score_head4(s))
        score_map = torch.sigmoid(self.score_head6(s)[:, 0])  # [B, H, W]
        fmap = x1234 / torch.linalg.vector_norm(x1234, dim=1, keepdim=True).clamp_min(1e-8)
        kpts, scores, dispersity = dkd_detect(score_map, self.max_keypoints, self.nms_radius)
        desc = self.desc_head(fmap.permute(0, 2, 3, 1), kpts)
        return ALIKEDOutput(kpts, scores, desc, scores > self.detection_threshold, dispersity,
                            score_map)


# upstream torch state_dict prefix -> (flax path prefix, kind) for
# :func:`convert_aliked_state_dict`: "conv" transposes OIHW -> HWIO, "bn"
# maps weight / bias / running_mean / running_var -> scale / bias / mean /
# var, "dcn_weight" is a deformable conv's kernel (``<block>.convN.
# regular_conv.weight`` -> ``<block>/convN/weight``), "raw" copies as it is
ALIKED_TORCH_MAP: Dict[str, Tuple[str, str]] = {
    **{f"block{b}.{n}": (f"block{b}/{n}", "conv" if n.startswith(("conv", "down")) else "bn")
       for b in (1, 2) for n in ("conv1", "conv2", "bn1", "bn2")},
    "block2.downsample": ("block2/downsample", "conv"),
    **{f"block{b}.conv{i}.offset_conv": (f"block{b}/conv{i}/offset_conv", "conv")
       for b in (3, 4) for i in (1, 2)},
    **{f"block{b}.conv{i}.regular_conv": (f"block{b}/conv{i}", "dcn_weight")
       for b in (3, 4) for i in (1, 2)},
    **{f"block{b}.bn{i}": (f"block{b}/bn{i}", "bn") for b in (3, 4) for i in (1, 2)},
    "block3.downsample": ("block3/downsample", "conv"),
    "block4.downsample": ("block4/downsample", "conv"),
    **{f"conv{i}": (f"conv{i}", "conv") for i in (1, 2, 3, 4)},
    **{f"score_head.{i}": (f"score_head{i}", "conv") for i in (0, 2, 4, 6)},
    "desc_head.offset_conv.0": ("desc_head/offset_conv1", "conv"),
    "desc_head.offset_conv.2": ("desc_head/offset_conv2", "conv"),
    "desc_head.sf_conv": ("desc_head/sf_conv", "conv"),
    "desc_head.agg_weights": ("desc_head/agg_weights", "raw"),
}


def convert_aliked_state_dict(state_dict, template_params):
    """An upstream torch ALIKED checkpoint (numpy-like tensors) on the flax
    variables ``template_params`` ({"params", "batch_stats"}, e.g.
    ``weights.module_params_to_jax(ALIKED(...))``) -> (variables, the
    upstream keys left unmapped), as the JAX package's converter gives them;
    ``weights.module_params_from_jax`` then loads the variables."""
    import numpy as np

    from ..weights import numpy_tree

    params = numpy_tree(template_params["params"])
    stats = numpy_tree(template_params.get("batch_stats", {}))

    def set_in(tree, path, value):
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node[p]
        old = node[parts[-1]]
        if tuple(old.shape) != tuple(value.shape):
            raise ValueError(f"{path}: shape {value.shape} != template {old.shape}")
        node[parts[-1]] = value.astype(old.dtype)

    used = set()
    for prefix, (dst, kind) in ALIKED_TORCH_MAP.items():
        if kind == "raw":
            if prefix in state_dict:
                set_in(params, dst, np.asarray(state_dict[prefix]))
                used.add(prefix)
            continue
        wkey = f"{prefix}.weight"
        if wkey not in state_dict:
            continue
        wt = np.asarray(state_dict[wkey])
        used.add(wkey)
        if kind == "bn":
            set_in(params, f"{dst}/scale", wt)
            set_in(params, f"{dst}/bias", np.asarray(state_dict[f"{prefix}.bias"]))
            set_in(stats, f"{dst}/mean", np.asarray(state_dict[f"{prefix}.running_mean"]))
            set_in(stats, f"{dst}/var", np.asarray(state_dict[f"{prefix}.running_var"]))
            used.update({f"{prefix}.bias", f"{prefix}.running_mean", f"{prefix}.running_var",
                         f"{prefix}.num_batches_tracked"})
            continue
        hwio = np.transpose(wt, (2, 3, 1, 0))  # OIHW -> HWIO
        if kind == "dcn_weight":
            set_in(params, f"{dst}/weight", hwio)
        elif dst.endswith("sf_conv"):  # a Dense kernel [C_in, C_out] from a 1 x 1 conv
            set_in(params, f"{dst}/kernel", hwio[0, 0])
        else:
            set_in(params, f"{dst}/kernel", hwio)
        bkey = f"{prefix}.bias"
        if bkey in state_dict:
            set_in(params, f"{dst}/bias", np.asarray(state_dict[bkey]))
            used.add(bkey)
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out, [k for k in state_dict if k not in used]
