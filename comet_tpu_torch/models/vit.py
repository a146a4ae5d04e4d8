"""DINOv2-style ViT with registers, used frozen as the image encoder.

Counterpart of ``comet_tpu/models/vit.py``: patch size 14, 1 cls token and 4
register tokens, LayerScale on both branches, a final LayerNorm; returns the
normalized patch tokens. The position embedding is stored at the target
grid (img_size / 14), so no resampling happens at run time.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.attn import fused_attention
from .blocks import Conv2d, LayerNorm, Linear, gelu


class ViTAttention(nn.Module):
    """Fused-qkv attention; Q, K and V reach K1 as column slices of qkv.
    Under tensor parallelism qkv is column-parallel and ``proj`` (no
    row-parallel name) replicated, so the qkv call all-gathers its output
    features before the heads are split."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)

    def forward(self, x):
        c = x.shape[-1]
        q, k, v = self.qkv(x).split(c, dim=-1)
        return self.proj(fused_attention(q, k, v, self.num_heads))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.init_value = init_value
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def init_own_params(self, generator):
        self.gamma.fill_(self.init_value)

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.attn = ViTAttention(dim, num_heads, dtype)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.mlp_fc1 = Linear(dim, int(dim * mlp_ratio), dtype)
        self.mlp_fc2 = Linear(int(dim * mlp_ratio), dim, dtype)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(x)))))


class DinoViT(nn.Module):
    def __init__(
        self,
        img_size: int = 336,
        patch_size: int = 14,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        num_register_tokens: int = 4,
        dtype=torch.float32,
    ):
        super().__init__()
        self.img_size, self.patch_size, self.embed_dim = img_size, patch_size, embed_dim
        self.num_register_tokens, self.compute_dtype = num_register_tokens, dtype
        grid = img_size // patch_size
        self.patch_embed = Conv2d(3, embed_dim, patch_size, stride=patch_size, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, grid * grid + 1, embed_dim))
        self.register_tokens = (
            nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim))
            if num_register_tokens else None
        )
        self.blocks = nn.ModuleList(
            [ViTBlock(embed_dim, num_heads, mlp_ratio, dtype) for _ in range(depth)]
        )
        self.norm = LayerNorm(embed_dim, 1e-6, dtype=dtype)

    def init_own_params(self, generator):
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        if self.register_tokens is not None:
            self.register_tokens.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, img_size, img_size, 3] -> patch tokens [B, P, C]."""
        b, h, w, _ = images.shape
        if (h, w) != (self.img_size, self.img_size):
            raise ValueError(f"DinoViT expects {self.img_size}px inputs, got {h}x{w}")
        dt, c = self.compute_dtype, self.embed_dim
        x = self.patch_embed(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.to(dt).expand(b, 1, c), x], dim=1)
        x = x + self.pos_embed.to(dt)
        if self.register_tokens is not None:
            regs = self.register_tokens.to(dt).expand(b, self.num_register_tokens, c)
            x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return x[:, 1 + (self.num_register_tokens or 0):]
