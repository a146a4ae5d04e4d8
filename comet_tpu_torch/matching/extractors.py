"""Registered feature extractors for the TwoViewPipeline.

Counterpart of ``comet_tpu/matching/extractors.py``: SuperPoint
(``models/superpoint.py``) and the dense grid detector behind the
glue-factory-style registry. An extractor runs where its image lives (a
numpy image goes to the card unless the factory was given ``device="cpu"``).

The JAX package initializes SuperPoint lazily from ``jax.random.PRNGKey(seed)``;
those draws cannot be reproduced, so the port draws its random weights from
``torch.Generator().manual_seed(seed)`` on the CPU and moves them to the
device: the card and the CPU hold the same weights. ``params_path`` (a flax
``.msgpack`` of the JAX package's SuperPoint) gives both packages the same
weights.

``extractor_aliked``, ``extractor_disk``, ``extractor_keynet``,
``dense_disk`` and ``extractor_mixed`` keep their names in the registry;
building one raises NotImplementedError (ROADMAP Queue 1 item 7c).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .registry import not_ported, register_model


def as_image(image, device, what: str) -> torch.Tensor:
    """A tensor stays where it is; a numpy image goes to ``device`` (the
    card by default), as f32."""
    if isinstance(image, torch.Tensor):
        return image.float()
    return torch.as_tensor(np.asarray(image, np.float32), device=resolve_device(device, what))


def build_superpoint(max_keypoints: int = 512, detection_threshold: float = 0.005,
                     params_path: Optional[str] = None, seed: int = 0):
    """A SuperPoint on the CPU: random weights from ``seed`` or, with
    ``params_path``, the JAX package's flax ``.msgpack`` weights."""
    from ..models.blocks import init_params
    from ..models.superpoint import SuperPoint
    from ..utils.serialization import read_msgpack
    from ..weights import module_params_from_jax

    model = SuperPoint(max_keypoints=max_keypoints, detection_threshold=detection_threshold)
    init_params(model, torch.Generator().manual_seed(seed))
    if params_path:
        model.load_state_dict(module_params_from_jax(read_msgpack(params_path), model))
    return model.eval()


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
    cpu_model = build_superpoint(max_keypoints, detection_threshold, params_path, seed)
    models = {}

    def extract(image) -> Dict[str, torch.Tensor]:
        image = as_image(image, device, "extractor_superpoint")
        gray = image.mean(dim=-1) if image.dim() == 3 else image
        h, w = gray.shape
        hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
        gray = F.pad(gray, (0, wp - w, 0, hp - h))
        if gray.device not in models:
            models[gray.device] = copy.deepcopy(cpu_model).to(gray.device)
        with torch.no_grad():
            out = models[gray.device](gray)
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


not_ported("extractor_aliked", "7c", {"model_name": "aliked-n16", "max_keypoints": 512,
                                      "detection_threshold": 0.2, "params_path": None, "seed": 0})
not_ported("extractor_disk", "7c", {"max_keypoints": 512, "detection_threshold": 0.0,
                                    "nms_window_size": 5, "params_path": None, "seed": 0})
not_ported("extractor_keynet", "7c", {"max_keypoints": 512, "num_levels": 3,
                                      "params_path": None, "seed": 0})
not_ported("dense_disk", "7c", {"desc_dim": 128, "params_path": None, "seed": 0})
not_ported("extractor_mixed", "7c", {"detector": "extractor_grid", "detector_conf": {},
                                     "descriptor": "dense_disk", "descriptor_conf": {}})
