"""Photometric augmentation for matcher training.

Counterpart of ``comet_tpu/matching/augmentations.py`` (the ``photometric:
{name: lg}`` block of gluefactory's homography experiments): random
brightness, contrast, saturation, gamma, additive gaussian noise and a
gaussian blur, each applied with its own probability, on [H, W, C] float
images in [0, 1].

The augmentation is split in two. :func:`draw_photometric` takes every
random number from a ``torch.Generator`` on the CPU (whether each step
applies, its factor, the noise image), and :func:`apply_photometric` applies
a draw on the image's device with no further randomness (the noise image is
its one copy to the device), so the card and the CPU give the same image
from one seed. JAX draws from its
own keys, which a ``torch.Generator`` cannot reproduce; the tests feed JAX's
draws to :func:`apply_photometric` instead.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

BLUR_RADIUS = 3  # fixed taps, random sigma


class PhotometricConfig(NamedTuple):
    p: float = 0.95  # probability each step applies
    brightness: float = 0.15  # additive, in [0, 1] units
    contrast: float = 0.3  # multiplicative around the mean
    saturation: float = 0.3  # toward / away from grayscale
    gamma: float = 0.3  # log-gamma range
    noise_std: float = 0.02
    blur_sigma: float = 1.2  # max gaussian-blur sigma (0 disables)


# the "lg" preset (gluefactory configs' photometric.name: lg)
LG_PRESET = PhotometricConfig()
STEPS = ("brightness", "contrast", "saturation", "gamma", "noise", "blur")


def _uniform(generator: torch.Generator, low: float, high: float) -> float:
    return float(torch.rand((), generator=generator)) * (high - low) + low


def draw_photometric(generator: torch.Generator, shape, conf: PhotometricConfig = LG_PRESET
                     ) -> Dict[str, object]:
    """Every random number of one augmentation of an image of ``shape``
    [H, W, C], from ``generator`` (a CPU generator): ``applies`` (step name
    -> bool), the brightness offset, the contrast and saturation factors,
    the gamma exponent, the noise image (CPU, f32) and the blur sigma."""
    d: Dict[str, object] = {"applies": {s: float(torch.rand((), generator=generator)) < conf.p
                                        for s in STEPS}}
    d["brightness"] = _uniform(generator, -conf.brightness, conf.brightness)
    d["contrast"] = 1.0 + _uniform(generator, -conf.contrast, conf.contrast)
    d["saturation"] = 1.0 + _uniform(generator, -conf.saturation, conf.saturation)
    d["gamma"] = float(np.exp(_uniform(generator, -conf.gamma, conf.gamma)))
    d["noise"] = torch.randn(tuple(shape), generator=generator)
    d["blur_sigma"] = _uniform(generator, 0.1, conf.blur_sigma) if conf.blur_sigma > 0 else 0.0
    return d


def gaussian_kernel1d(sigma: float, radius: int = BLUR_RADIUS, device=None) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / max(sigma, 1e-3)) ** 2)
    return k / k.sum()


def blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable 7-tap gaussian blur of [H, W, C] with zero padding
    (``conv_general_dilated(..., "SAME")``): along W, then along H."""
    k = gaussian_kernel1d(sigma, device=x.device)  # made there: no copy to wait on
    r = BLUR_RADIUS
    xr = x.permute(2, 0, 1)[:, None]  # [C, 1, H, W]
    xr = F.conv2d(xr, k.reshape(1, 1, 1, -1), padding=(0, r))
    xr = F.conv2d(xr, k.reshape(1, 1, -1, 1), padding=(r, 0))
    return xr[:, 0].permute(1, 2, 0)


def apply_photometric(image: torch.Tensor, draw: Dict[str, object],
                      conf: PhotometricConfig = LG_PRESET) -> torch.Tensor:
    """``draw`` applied to ``image`` [H, W, C] in [0, 1], on its device, in
    the reference's order; saturation only on 3 channels, the blur only
    where ``conf.blur_sigma`` > 0. The output is clipped to [0, 1]."""
    on = draw["applies"]
    x = image.float()
    if on["brightness"]:
        x = x + draw["brightness"]
    if on["contrast"]:
        m = x.mean()
        x = (x - m) * draw["contrast"] + m
    if on["saturation"] and image.shape[-1] == 3:
        gray = x.mean(dim=-1, keepdim=True)
        x = gray + (x - gray) * draw["saturation"]
    if on["gamma"]:
        x = x.clamp(1e-6, 1.0) ** draw["gamma"]
    if on["noise"]:
        x = x + conf.noise_std * draw["noise"].to(x.device)
    if conf.blur_sigma > 0 and on["blur"]:
        x = blur(x, draw["blur_sigma"])
    return x.clamp(0.0, 1.0)


def photometric_augment(generator: torch.Generator, image: torch.Tensor,
                        conf: PhotometricConfig = LG_PRESET) -> torch.Tensor:
    """One augmentation of ``image`` [H, W, C] in [0, 1], its random numbers
    from ``generator`` (:func:`draw_photometric`, then
    :func:`apply_photometric`)."""
    return apply_photometric(image, draw_photometric(generator, image.shape, conf), conf)


def sample_homography_difficulty(rng: np.random.Generator, h: int, w: int,
                                 difficulty: float = 0.7, max_angle: float = 45.0) -> np.ndarray:
    """A difficulty-scaled random homography (3 x 3, numpy, on the host):
    difficulty in [0, 1] scales translation, scale and perspective together,
    ``max_angle`` (degrees) bounds the rotation."""
    from .benchmarks import random_homography

    d = float(difficulty)
    return random_homography(
        rng, h, w,
        max_rotation=float(max_angle) * 3.14159265 / 180.0 * d,
        max_scale=0.3 * d,
        max_translation=0.15 * d,
        max_perspective=6e-4 * d,
    )
