"""SIFT-style keypoint detector and descriptor, static shapes.

Counterpart of ``comet_tpu/matching/sift.py`` (a compact upright SIFT, not a
byte-level clone of gluefactory's): difference-of-Gaussians extrema over a
fixed scale stack with a magnitude threshold and a static top-k, then
128-d gradient-orientation histograms (4 x 4 cells x 8 bins, bilinear in
space and orientation, a Gaussian window), normalized, clipped at 0.2 and
renormalized.

The blur sums its taps as separate multiplies and adds of shifted slices,
in one fixed order, so the card and the CPU blur bit for bit alike and
detect the same keypoints. The top-k keeps ``jax.lax.top_k``'s order for
equal scores (lowest flat index first); ``jnp.gradient``'s one-sided edges
and the truncating integer cast of the keypoint position are kept.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..models.superpoint import top_k
from .registry import register_model


def _gaussian_kernel1d(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _blur_axis(x: torch.Tensor, k, radius: int, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    pad = [0, 0, 0, 0]
    pad[(1 - dim) * 2:(1 - dim) * 2 + 2] = [radius, radius]  # F.pad's order: last axis first
    xp = F.pad(x[None, None], pad, mode="replicate")[0, 0]
    out = None
    for j, kj in enumerate(k):
        term = xp.narrow(dim, j, n) * kj
        out = term if out is None else out + term
    return out


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [H, W] with edge padding."""
    radius = max(1, int(3.0 * sigma + 0.5))
    k = _gaussian_kernel1d(sigma, radius, img.device)
    return _blur_axis(_blur_axis(img, k, radius, 0), k, radius, 1)


def dog_keypoints(
    img: torch.Tensor,  # [H, W] grayscale in [0, 1]
    max_keypoints: int = 512,
    num_scales: int = 5,
    sigma0: float = 1.6,
    threshold: float = 0.005,
    border: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DoG extrema -> ([K, 2] xy, [K] |response|), zero-score padding.

    An extremum is strictly above (below) its 26 neighbours; the spatial
    axes pad by their edge and the scale axis by -inf (+inf), so extrema at
    the first and last scale count."""
    h, w = img.shape
    sigmas = [sigma0 * (2.0 ** (i / 2.0)) for i in range(num_scales + 1)]
    stack = torch.stack([gaussian_blur(img, s) for s in sigmas])  # [S+1, H, W]
    dog = stack[1:] - stack[:-1]  # [S, H, W]
    s = dog.shape[0]
    pad_sp = F.pad(dog[None], (1, 1, 1, 1), mode="replicate")[0]
    inf = torch.full((1, h + 2, w + 2), math.inf, device=img.device)
    pad_max = torch.cat([-inf, pad_sp, -inf])
    pad_min = torch.cat([inf, pad_sp, inf])
    mx = torch.full_like(dog, -math.inf)
    mn = torch.full_like(dog, math.inf)
    for ds in (0, 1, 2):
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                if ds == 1 and dy == 1 and dx == 1:
                    continue
                mx = torch.maximum(mx, pad_max[ds:ds + s, dy:dy + h, dx:dx + w])
                mn = torch.minimum(mn, pad_min[ds:ds + s, dy:dy + h, dx:dx + w])
    is_max = (dog > mx) & (dog > threshold)
    is_min = (dog < mn) & (dog < -threshold)
    resp = torch.where(is_max | is_min, dog.abs(), 0.0).amax(dim=0)  # collapse the scales
    mask = torch.zeros_like(resp)
    mask[border:h - border, border:w - border] = 1.0
    scores, idx = top_k((resp * mask).reshape(-1), max_keypoints)
    ys = torch.div(idx, w, rounding_mode="floor").float()
    xs = (idx % w).float()
    return torch.stack([xs, ys], dim=-1), scores


def _gradient(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jnp.gradient`` of [H, W]: central differences inside, one-sided at
    the edges; (d/dy, d/dx)."""

    def along(x, dim):
        n = x.shape[dim]
        inner = (x.narrow(dim, 2, n - 2) - x.narrow(dim, 0, n - 2)) / 2.0
        first = x.narrow(dim, 1, 1) - x.narrow(dim, 0, 1)
        last = x.narrow(dim, n - 1, 1) - x.narrow(dim, n - 2, 1)
        return torch.cat([first, inner, last], dim=dim)

    return along(img, 0), along(img, 1)


def sift_descriptors(
    img: torch.Tensor,  # [H, W] grayscale
    kpts: torch.Tensor,  # [K, 2] (x, y)
    patch_radius: int = 8,
) -> torch.Tensor:
    """Upright 128-d SIFT descriptors at the keypoints -> [K, 128]."""
    h, w = img.shape
    dev = img.device
    gy, gx = _gradient(img)
    mag = torch.sqrt(gx ** 2 + gy ** 2)
    ori = torch.atan2(gy, gx)  # [-pi, pi]

    p = 2 * patch_radius
    lin = torch.arange(-patch_radius, patch_radius, device=dev)
    g = torch.exp(-0.5 * ((lin + 0.5) / (0.5 * p)) ** 2)
    win = g[:, None] * g[None, :]

    # spatial bilinear weights into the 4 x 4 cell grid
    cell_pos = (lin + patch_radius + 0.5) / (p / 4.0) - 0.5
    cell_idx0 = torch.floor(cell_pos).long().clamp(0, 3)
    cell_idx1 = (cell_idx0 + 1).clamp(0, 3)
    cell_f = (cell_pos - cell_idx0).clamp(0.0, 1.0)
    cells = torch.arange(4, device=dev)
    wrow = ((cells[None, :] == cell_idx0[:, None]) * (1 - cell_f)[:, None]
            + (cells[None, :] == cell_idx1[:, None]) * cell_f[:, None])  # [p, 4]

    # kp.astype(int32): truncation toward zero
    xi = (kpts[:, 0].trunc().long()[:, None] + lin).clamp(0, w - 1)  # [K, p]
    yi = (kpts[:, 1].trunc().long()[:, None] + lin).clamp(0, h - 1)
    m = mag[yi[:, :, None], xi[:, None, :]] * win  # [K, p, p]
    o = ori[yi[:, :, None], xi[:, None, :]]
    ob = (o + math.pi) / (2 * math.pi) * 8.0
    fl = torch.floor(ob)
    b0 = fl.long() % 8
    b1 = (b0 + 1) % 8
    f = ob - fl
    bins = torch.arange(8, device=dev)
    hist_w = ((bins == b0[..., None]) * (1 - f)[..., None]
              + (bins == b1[..., None]) * f[..., None]) * m[..., None]  # [K, p, p, 8]
    desc = torch.einsum("ya,xb,kyxo->kabo", wrow, wrow, hist_w).reshape(kpts.shape[0], -1)
    desc = desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp_min(1e-8)
    desc = desc.clamp_max(0.2)
    return desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp_min(1e-8)


def extract_sift(image: torch.Tensor, max_keypoints: int = 512,
                 threshold: float = 0.005) -> Dict[str, torch.Tensor]:
    """image [H, W] or [H, W, C] in [0, 1] -> the feature dict, on the
    image's device."""
    if image.dim() == 3:
        image = image.mean(dim=-1)
    kpts, scores = dog_keypoints(image, max_keypoints, threshold=threshold)
    return {
        "keypoints": kpts,
        "scores": scores,
        "descriptors": sift_descriptors(image, kpts),
        "valid": scores > 0,
    }


@register_model("extractor_sift", {"max_keypoints": 512, "threshold": 0.005})
def make_sift(max_keypoints=512, threshold=0.005, device=None):
    """SIFT on an image where it lives; a numpy image goes to ``device``
    (the card by default)."""
    from .extractors import as_image

    return lambda image: extract_sift(as_image(image, device, "extractor_sift"), max_keypoints,
                                      threshold)
