"""Sine/cosine positional embeddings.

Counterpart of ``comet_tpu/geometry/embeddings.py`` (same channel layouts).
Computed in f32 on the given device; none of them hold parameters.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch


def sincos_1d_from_grid(embed_dim: int, pos: torch.Tensor) -> torch.Tensor:
    """pos [M] -> [M, embed_dim] = [sin(pos*omega), cos(pos*omega)] with
    omega_d = 1 / 10000^(d / (D/2))."""
    if embed_dim % 2:
        raise ValueError("embed_dim must be even")
    omega = torch.arange(embed_dim // 2, dtype=torch.float32, device=pos.device)
    omega = 1.0 / (10000.0 ** (omega / (embed_dim / 2.0)))
    out = pos.reshape(-1).float()[:, None] * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)


def sincos_time_embed(embed_dim: int, length: int, device=None) -> torch.Tensor:
    """[1, length, embed_dim] time embedding."""
    return sincos_1d_from_grid(embed_dim, torch.arange(length, device=device))[None]


def _grid_hw(grid_size: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return tuple(grid_size) if isinstance(grid_size, tuple) else (grid_size, grid_size)


def sincos_2d_pos_embed(
    embed_dim: int, grid_size: Union[int, Tuple[int, int]], device=None
) -> torch.Tensor:
    """2-D sincos embedding [H*W, embed_dim]: the first half of the channels
    encodes the w (column) index, the second half the h (row) index."""
    gh, gw = _grid_hw(grid_size)
    ww, hh = torch.meshgrid(
        torch.arange(gw, device=device), torch.arange(gh, device=device), indexing="xy"
    )
    emb_h = sincos_1d_from_grid(embed_dim // 2, ww.reshape(-1))
    emb_w = sincos_1d_from_grid(embed_dim // 2, hh.reshape(-1))
    return torch.cat([emb_h, emb_w], dim=-1)


def sincos_2d_pos_embed_grid(embed_dim: int, grid_size, device=None) -> torch.Tensor:
    """:func:`sincos_2d_pos_embed` shaped [H, W, embed_dim]."""
    gh, gw = _grid_hw(grid_size)
    return sincos_2d_pos_embed(embed_dim, (gh, gw), device).reshape(gh, gw, embed_dim)


def embed_2d_coords(xy: torch.Tensor, C: int, cat_coords: bool = True) -> torch.Tensor:
    """Per-coordinate sincos embedding of 2-D points: [..., 2] -> [..., 2C]
    (or [..., 2C + 2] with cat_coords). div_k = 2k * (1000 / C); sin on
    even channels, cos on odd ones, x channels before y channels."""
    if C % 2:
        raise ValueError("C must be even")
    x = xy[..., 0:1]
    y = xy[..., 1:2]
    div_term = torch.arange(0, C, 2, dtype=torch.float32, device=xy.device) * (1000.0 / C)

    def interleave(t):
        return torch.stack([torch.sin(t), torch.cos(t)], dim=-1).reshape(*t.shape[:-1], C)

    pe = torch.cat([interleave(x * div_term), interleave(y * div_term)], dim=-1)
    if cat_coords:
        pe = torch.cat([xy, pe], dim=-1)
    return pe


def harmonic_embedding(
    x: torch.Tensor,
    n_harmonic_functions: int = 6,
    omega_0: float = 1.0,
    logspace: bool = True,
    append_input: bool = False,
) -> torch.Tensor:
    """NeRF-style harmonic embedding: x [..., D] -> [..., D * 2 * n (+ D)],
    laid out [sin(x*f1), ..., sin(x*fn), cos(x*f1), ..., cos(x*fn), (x)]
    per input channel group, frequencies 2^k (logspace) or evenly spaced
    from 1 to 2^(n-1)."""
    if logspace:
        freqs = 2.0 ** torch.arange(n_harmonic_functions, dtype=torch.float32, device=x.device)
    else:
        freqs = torch.linspace(1.0, 2.0 ** (n_harmonic_functions - 1), n_harmonic_functions,
                               device=x.device)
    embed = (x[..., None] * (freqs * omega_0)).reshape(*x.shape[:-1], -1)
    out = torch.cat([torch.sin(embed), torch.cos(embed)], dim=-1)
    return torch.cat([out, x], dim=-1) if append_input else out
