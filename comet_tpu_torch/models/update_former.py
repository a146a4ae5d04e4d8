"""EfficientUpdateFormer: factorized time/space track-update transformer.

Counterpart of ``comet_tpu/models/update_former.py``. Time attention runs
over (B*N, T) sequences (K2, or K3 unfused); space attention over (B*T, N)
through 64 learnable virtual tracks, with cross-attention both ways (K1, or
K4 whole); the input tokens are added back before the flow head. The
blocks' ``route`` chooses, as ``models/blocks.py`` says.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .blocks import AttnBlock, CrossAttnBlock, Linear


class EfficientUpdateFormer(nn.Module):
    def __init__(
        self,
        input_dim: int,
        space_depth: int = 6,
        time_depth: int = 6,
        hidden_size: int = 384,
        num_heads: int = 8,
        output_dim: int = 130,
        mlp_ratio: float = 4.0,
        add_space_attn: bool = True,
        num_virtual_tracks: int = 64,
        dtype=torch.float32,
    ):
        super().__init__()
        self.hidden_size, self.compute_dtype = hidden_size, dtype
        self.add_space_attn = add_space_attn
        self.num_virtual_tracks = num_virtual_tracks
        self.time_depth = time_depth
        self.space_every = time_depth // space_depth if add_space_attn else 0
        self.input_transform = Linear(input_dim, hidden_size, dtype)
        self.time_blocks = nn.ModuleList(
            [AttnBlock(hidden_size, num_heads, mlp_ratio, dtype) for _ in range(time_depth)]
        )
        if add_space_attn:
            self.virtual_tracks = nn.Parameter(torch.empty(1, num_virtual_tracks, 1, hidden_size))
            n_space = len(range(0, time_depth, self.space_every))

            def blocks(cls):
                return nn.ModuleList(
                    [cls(hidden_size, num_heads, mlp_ratio, dtype) for _ in range(n_space)]
                )

            self.space_virtual2point_blocks = blocks(CrossAttnBlock)
            self.space_virtual_blocks = blocks(AttnBlock)
            self.space_point2virtual_blocks = blocks(CrossAttnBlock)
        self.flow_head = Linear(hidden_size, output_dim, dtype)

    def init_own_params(self, generator):
        if self.add_space_attn:
            self.virtual_tracks.normal_(0.0, 1.0, generator=generator)

    def forward(self, x):
        """x [B, N, T, D_in] -> flow [B, N, T, output_dim]."""
        b, _, t, _ = x.shape
        hs, nv = self.hidden_size, self.num_virtual_tracks
        tokens = self.input_transform(x)
        init_tokens = tokens
        if self.add_space_attn:
            virtual = self.virtual_tracks.to(self.compute_dtype).expand(b, nv, t, hs)
            tokens = torch.cat([tokens, virtual], dim=1)
        n = tokens.shape[1]
        j = 0
        for i in range(self.time_depth):
            tokens = self.time_blocks[i](tokens.reshape(b * n, t, hs)).reshape(b, n, t, hs)
            if self.add_space_attn and i % self.space_every == 0:
                space = tokens.permute(0, 2, 1, 3).reshape(b * t, n, hs)
                point, virtual = space[:, : n - nv], space[:, n - nv :]
                virtual = self.space_virtual2point_blocks[j](virtual, point)
                virtual = self.space_virtual_blocks[j](virtual)
                point = self.space_point2virtual_blocks[j](point, virtual)
                space = torch.cat([point, virtual], dim=1)
                tokens = space.reshape(b, t, n, hs).permute(0, 2, 1, 3)
                j += 1
        if self.add_space_attn:
            tokens = tokens[:, : n - nv]
        return self.flow_head(tokens + init_tokens)
