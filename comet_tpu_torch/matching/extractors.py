"""Registered feature extractors for the TwoViewPipeline.

Counterpart of ``comet_tpu/matching/extractors.py``: SuperPoint, ALIKED,
DISK and KeyNet+HardNet (``models/``), the dense grid detector, the dense
DISK descriptor map and the mixed extractor (a detector's keypoints with
descriptors sampled from a dense map), behind the glue-factory-style
registry. An extractor runs where its image lives (a numpy image goes to the
card unless the factory was given ``device="cpu"``), with the JAX package's
padding: SuperPoint's zeros to a multiple of 8, ALIKED's edge padding to 32,
DISK's zeros to 16; keypoints in the padding are not ``valid``.

The JAX package initializes its models lazily from ``jax.random.PRNGKey(seed)``;
those draws cannot be reproduced, so the port draws its random weights from
``torch.Generator().manual_seed(seed)`` on the CPU and moves them to the
device: the card and the CPU hold the same weights. ``params_path`` (a flax
``.msgpack`` of the JAX package's model, BatchNorm statistics included)
gives both packages the same weights.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .registry import register_model


def as_image(image, device, what: str) -> torch.Tensor:
    """A tensor stays where it is; a numpy image goes to ``device`` (the
    card by default), as f32."""
    if isinstance(image, torch.Tensor):
        return image.float()
    return torch.as_tensor(np.asarray(image, np.float32), device=resolve_device(device, what))


def _build(model, params_path: Optional[str], seed: int):
    """``model`` on the CPU in eval mode: random weights from ``seed`` or,
    with ``params_path``, the JAX package's flax ``.msgpack`` variables."""
    from ..models.blocks import init_params
    from ..utils.serialization import read_msgpack
    from ..weights import module_params_from_jax

    init_params(model, torch.Generator().manual_seed(seed))
    if params_path:
        model.load_state_dict(module_params_from_jax(read_msgpack(params_path), model))
    return model.eval()


class _Models:
    """A model per input channel count, built on the CPU at its first image
    (the JAX package initializes for the first image's shape: a one-channel
    image gets a one-channel network), and one copy of it per device."""

    def __init__(self, build):
        self.build, self.cpu, self.on = build, {}, {}

    def __call__(self, device, channels: int = 0):
        if channels not in self.cpu:
            self.cpu[channels] = self.build(channels)
        if (channels, device) not in self.on:
            self.on[channels, device] = copy.deepcopy(self.cpu[channels]).to(device)
        return self.on[channels, device]


def _pad_to(img: torch.Tensor, multiple: int, mode: str = "constant") -> torch.Tensor:
    """[H, W, C] padded at the bottom and right to multiples of ``multiple``
    (zeros, or the edge with mode "replicate")."""
    h, w = img.shape[:2]
    ph, pw = -h % multiple, -w % multiple
    if not (ph or pw):
        return img
    return F.pad(img.permute(2, 0, 1)[None], (0, pw, 0, ph), mode=mode)[0].permute(1, 2, 0)


def _rgb(image, device, what: str) -> torch.Tensor:
    """[H, W, C] as it is; [H, W] repeated to RGB."""
    img = as_image(image, device, what)
    return img if img.dim() == 3 else img[..., None].repeat(1, 1, 3)


def build_superpoint(max_keypoints: int = 512, detection_threshold: float = 0.005,
                     params_path: Optional[str] = None, seed: int = 0):
    """A SuperPoint on the CPU: random weights from ``seed`` or, with
    ``params_path``, the JAX package's flax ``.msgpack`` weights."""
    from ..models.superpoint import SuperPoint

    return _build(SuperPoint(max_keypoints=max_keypoints,
                             detection_threshold=detection_threshold), params_path, seed)


@register_model(
    "extractor_superpoint",
    {"max_keypoints": 512, "detection_threshold": 0.005, "params_path": None, "seed": 0},
)
def make_superpoint(
    max_keypoints: int = 512,
    detection_threshold: float = 0.005,
    params_path: Optional[str] = None,
    seed: int = 0,
    device=None,
):
    """SuperPoint extractor: image [H, W] or [H, W, C] in [0, 1] (padded to
    a multiple of 8) -> keypoints, scores, descriptors and ``valid``
    (positive score, inside the unpadded image)."""
    models = _Models(lambda _: build_superpoint(max_keypoints, detection_threshold, params_path,
                                                seed))

    def extract(image) -> Dict[str, torch.Tensor]:
        image = as_image(image, device, "extractor_superpoint")
        gray = image.mean(dim=-1) if image.dim() == 3 else image
        h, w = gray.shape
        hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
        gray = F.pad(gray, (0, wp - w, 0, hp - h))
        with torch.no_grad():
            out = models(gray.device)(gray)
        return {
            "keypoints": out.keypoints,
            "scores": out.scores,
            "descriptors": out.descriptors,
            "valid": (out.scores > 0) & (out.keypoints[:, 0] < w) & (out.keypoints[:, 1] < h),
        }

    return extract


@register_model("extractor_grid", {"cell_size": 14})
def make_grid_extractor(cell_size: int = 14, device=None):
    """Dense grid "detector": one keypoint at ``idx * cell + cell / 2 + 0.5``
    of every cell_size x cell_size cell (the reference's +0.5 on top of the
    cell centre); no descriptors."""

    def extract(image) -> Dict[str, torch.Tensor]:
        image = as_image(image, device, "extractor_grid")
        h, w = image.shape[:2]
        gh, gw = h // cell_size, w // cell_size
        ys = torch.arange(gh, dtype=torch.float32, device=image.device) * cell_size + cell_size / 2
        xs = torch.arange(gw, dtype=torch.float32, device=image.device) * cell_size + cell_size / 2
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        kpts = torch.stack([gx, gy], -1).reshape(-1, 2) + 0.5
        n = kpts.shape[0]
        return {
            "keypoints": kpts,
            "scores": torch.ones(n, device=image.device),
            "valid": torch.ones(n, dtype=torch.bool, device=image.device),
            "grid_shape": (gh, gw),
        }

    return extract


def _inside(out_keypoints, valid, h: int, w: int):
    return valid & (out_keypoints[:, 0] < w) & (out_keypoints[:, 1] < h)


@register_model(
    "extractor_aliked",
    {"model_name": "aliked-n16", "max_keypoints": 512, "detection_threshold": 0.2,
     "params_path": None, "seed": 0},
)
def make_aliked(model_name: str = "aliked-n16", max_keypoints: int = 512,
                detection_threshold: float = 0.2, params_path: Optional[str] = None,
                seed: int = 0, device=None):
    """ALIKED: image [H, W] (repeated to RGB) or [H, W, C] in [0, 1],
    edge-padded to a multiple of 32 -> keypoints, scores, descriptors and
    ``valid`` (score above the threshold, inside the unpadded image)."""
    from ..models.aliked import ALIKED

    models = _Models(lambda c: _build(ALIKED(model_name, max_keypoints, detection_threshold,
                                             in_ch=c), params_path, seed))

    def extract(image) -> Dict[str, torch.Tensor]:
        img = _rgb(image, device, "extractor_aliked")
        h, w = img.shape[:2]
        with torch.no_grad():
            out = models(img.device, img.shape[-1])(_pad_to(img, 32, "replicate")[None])
        kp = out.keypoints[0]
        return {"keypoints": kp, "scores": out.scores[0], "descriptors": out.descriptors[0],
                "valid": _inside(kp, out.valid[0], h, w)}

    return extract


@register_model(
    "extractor_disk",
    {"max_keypoints": 512, "detection_threshold": 0.0, "nms_window_size": 5,
     "params_path": None, "seed": 0},
)
def make_disk(max_keypoints: int = 512, detection_threshold: float = 0.0,
              nms_window_size: int = 5, params_path: Optional[str] = None, seed: int = 0,
              device=None):
    """DISK: image [H, W] (repeated to RGB) or [H, W, C] in [0, 1],
    zero-padded to a multiple of 16 -> keypoints, scores, descriptors and
    ``valid`` (a peak, inside the unpadded image)."""
    from ..models.disk import DISK

    models = _Models(lambda c: _build(DISK(max_keypoints=max_keypoints,
                                           nms_window_size=nms_window_size,
                                           detection_threshold=detection_threshold, in_ch=c),
                                      params_path, seed))

    def extract(image) -> Dict[str, torch.Tensor]:
        img = _rgb(image, device, "extractor_disk")
        h, w = img.shape[:2]
        with torch.no_grad():
            out = models(img.device, img.shape[-1])(_pad_to(img, 16)[None])
        kp = out.keypoints[0]
        return {"keypoints": kp, "scores": out.scores[0], "descriptors": out.descriptors[0],
                "valid": _inside(kp, out.valid[0], h, w)}

    return extract


@register_model(
    "extractor_keynet",
    {"max_keypoints": 512, "num_levels": 3, "params_path": None, "seed": 0},
)
def make_keynet(max_keypoints: int = 512, num_levels: int = 3, params_path: Optional[str] = None,
                seed: int = 0, device=None):
    """KeyNet+HardNet: image [H, W] or [H, W, C] in [0, 1] -> keypoints,
    scores, descriptors, ``valid``, ``scales`` (1) and ``oris`` (0)."""
    from ..models.keynet import KeyNetHardNet

    models = _Models(lambda _: _build(KeyNetHardNet(max_keypoints=max_keypoints,
                                                    num_levels=num_levels), params_path, seed))

    def extract(image) -> Dict[str, torch.Tensor]:
        img = as_image(image, device, "extractor_keynet")
        img = img if img.dim() == 3 else img[..., None]
        with torch.no_grad():
            out = models(img.device)(img)
        return out._asdict()

    return extract


@register_model("dense_disk", {"desc_dim": 128, "params_path": None, "seed": 0})
def make_dense_disk(desc_dim: int = 128, params_path: Optional[str] = None, seed: int = 0,
                    device=None):
    """The dense DISK descriptor map (the U-Net without keypoint selection):
    image [H, W] (repeated to RGB) or [H, W, C] -> [H, W, desc_dim], the
    normalization left to the caller."""
    from ..models.disk import DISKUnet

    models = _Models(lambda c: _build(DISKUnet(up=(64, 64, 64, desc_dim + 1), in_ch=c),
                                      params_path, seed))

    def dense(image) -> torch.Tensor:
        img = _rgb(image, device, "dense_disk")
        h, w = img.shape[:2]
        with torch.no_grad():
            out = models(img.device, img.shape[-1])(_pad_to(img, 16).permute(2, 0, 1)[None])[0]
        return out.permute(1, 2, 0)[:h, :w, :desc_dim]

    return dense


@register_model(
    "extractor_mixed",
    {"detector": "extractor_grid", "detector_conf": {}, "descriptor": "dense_disk",
     "descriptor_conf": {}},
)
def make_mixed_extractor(detector: str = "extractor_grid", detector_conf: Optional[Dict] = None,
                         descriptor: str = "dense_disk", descriptor_conf: Optional[Dict] = None,
                         device=None):
    """A registered detector's keypoints with descriptors sampled bilinearly
    from a registered dense descriptor map at ``kpts - 0.5`` (the reference's
    ``grid_sample(align_corners=False)``), zeros outside, L2-normalized."""
    from ..ops.bilinear import bilinear_sample
    from .registry import get_model

    det = get_model(detector, **(detector_conf or {}), device=device)
    dense = get_model(descriptor, **(descriptor_conf or {}), device=device)

    def extract(image) -> Dict[str, torch.Tensor]:
        pred = dict(det(image))
        fmap = dense(image)
        desc = bilinear_sample(fmap, pred["keypoints"] - 0.5, padding_mode="zeros")
        pred["descriptors"] = desc / torch.linalg.vector_norm(desc, dim=-1,
                                                               keepdim=True).clamp_min(1e-8)
        return pred

    return extract
