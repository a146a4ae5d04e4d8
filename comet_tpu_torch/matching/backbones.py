"""Registered dense backbones for the matching framework.

Counterpart of ``comet_tpu/matching/backbones.py`` (glue-factory's DINOv2
backbone): a DINOv2 ViT (``models/vit.py``, ViT-S/14 by default) over an
image, giving the patch-token feature map, the cls-token global descriptor
and the per-patch descriptors. Random weights from
``torch.Generator().manual_seed(seed)`` unless ``params_path`` names the JAX
package's flax ``.msgpack`` of its ``DinoViT``.

The attention goes through ``ops.attn.fused_attention``: on the card the ViT
runs in bf16 (its weights cast once, the LayerNorms' statistics in f32, as
the main path's ViT after ``cast_params_for_inference``), so every block's
attention is K1; K1 takes no f32. On the CPU it runs in f32, as the JAX
package's backbone does. The outputs are f32 on both.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .extractors import _build, as_image
from .registry import register_model

PATCH = 14


@register_model(
    "backbone_dinov2",
    {"size": 224, "allow_resize": False, "embed_dim": 384, "depth": 12, "num_heads": 6,
     "num_register_tokens": 0, "params_path": None, "seed": 0},
)
def make_dinov2_backbone(size: int = 224, allow_resize: bool = False, embed_dim: int = 384,
                         depth: int = 12, num_heads: int = 6, num_register_tokens: int = 0,
                         params_path: Optional[str] = None, seed: int = 0, device=None):
    """The backbone: an image [H, W, 3] (or [H, W, 1]), [C, H, W] or a batch
    [B, C, H, W] (the reference's layout) -> {"features" [B, C, h, w],
    "global_descriptor" [B, C], "descriptors" [B, h w, C]}. The input must be
    ``size`` x ``size``; with ``allow_resize`` each side is shrunk to the
    nearest lower multiple of 14 (bilinear, antialiased, as
    ``jax.image.resize`` shrinks) and the position embedding resampled to
    that grid."""
    from ..models.vit import DinoViT
    from ..utils.serialization import cast_params_for_inference

    def vit(dtype):
        return DinoViT(img_size=size, patch_size=PATCH, embed_dim=embed_dim, depth=depth,
                       num_heads=num_heads, num_register_tokens=num_register_tokens, dtype=dtype)

    cpu_model = _build(vit(torch.float32), params_path, seed)
    models = {}

    def model_on(dev: torch.device):
        if dev not in models:
            if dev.type == "cuda":
                m = vit(torch.bfloat16)
                m.load_state_dict(cpu_model.state_dict())
                models[dev] = cast_params_for_inference(m.eval().to(dev), torch.bfloat16)
            else:
                models[dev] = copy.deepcopy(cpu_model).to(dev)
        return models[dev]

    def backbone(image) -> Dict[str, torch.Tensor]:
        image = as_image(image, device, "backbone_dinov2")
        if image.dim() == 3 and image.shape[-1] in (1, 3):  # [H, W, C]
            image = image[None]
        elif image.dim() == 3:  # [C, H, W]
            image = image.permute(1, 2, 0)[None]
        elif image.dim() == 4:  # [B, C, H, W]
            image = image.permute(0, 2, 3, 1)
        if image.shape[-1] == 1:
            image = image.expand(*image.shape[:-1], 3)
        h, w = image.shape[1], image.shape[2]
        if allow_resize:
            nh, nw = max(h // PATCH, 1) * PATCH, max(w // PATCH, 1) * PATCH
            if (nh, nw) != (h, w):
                image = F.interpolate(image.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
                                      align_corners=False, antialias=True).permute(0, 2, 3, 1)
        elif h != size or w != size:
            raise ValueError(
                f"backbone_dinov2 configured for {size}x{size} inputs, got {h}x{w}; set "
                "allow_resize=True to run at the nearest lower multiple-of-14 resolution")
        with torch.no_grad():
            tokens, cls = model_on(image.device)(image, return_cls=True)
        tokens, cls = tokens.float(), cls.float()
        b, _, c = tokens.shape
        gh, gw = image.shape[1] // PATCH, image.shape[2] // PATCH
        return {"features": tokens.reshape(b, gh, gw, c).permute(0, 3, 1, 2),
                "global_descriptor": cls, "descriptors": tokens}

    return backbone
