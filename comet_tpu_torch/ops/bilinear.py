"""Bilinear sampling and align-corners resizing, channel-last.

Counterpart of ``comet_tpu/ops/bilinear.py`` (``bilinear_sample``,
``sample_features``, ``resize_bilinear_align_corners`` and the torch-bicubic
``resize_bicubic_torch``). Coordinates are in pixels (x, y): 0 is
the center of the first pixel and W-1 / H-1 the center of the last
(align_corners=True).
"""

from __future__ import annotations

import functools

import torch


def sample_features(
    fmaps: torch.Tensor, pts: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """fmaps [B, H, W, C] sampled at pts [B, N, 2] -> [B, N, C].

    "border" clamps the taps to the map; "zeros" drops out-of-range taps.
    The interpolation weights are cast to the feature dtype.
    """
    b, h, w, _ = fmaps.shape
    x = pts[..., 0]
    y = pts[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0).to(fmaps.dtype)[..., None]
    dy = (y - y0).to(fmaps.dtype)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    bi = torch.arange(b, device=fmaps.device)[:, None]

    def tap(yi, xi):
        vals = fmaps[bi, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        if padding_mode == "zeros":
            inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            vals = vals * inside[..., None].to(vals.dtype)
        elif padding_mode != "border":
            raise ValueError(f"unknown padding_mode {padding_mode}")
        return vals

    top = tap(y0i, x0i) * (1 - dx) + tap(y0i, x0i + 1) * dx
    bot = tap(y0i + 1, x0i) * (1 - dx) + tap(y0i + 1, x0i + 1) * dx
    return top * (1 - dy) + bot * dy


def bilinear_sample(
    fmap: torch.Tensor, pts: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """One map [H, W, C] sampled at pts [..., 2] (x, y pixels) -> [..., C],
    with :func:`sample_features`'s padding modes."""
    lead = pts.shape[:-1]
    out = sample_features(fmap[None], pts.reshape(1, -1, 2), padding_mode)
    return out.reshape(*lead, fmap.shape[-1])


def interp_matrix_align_corners(
    n_in: int, n_out: int, device=None, dtype=torch.float32
) -> torch.Tensor:
    """[n_out, n_in] 1-D align-corners bilinear weights: output i reads the
    source coordinate i * (n_in - 1) / (n_out - 1). Cached, except while
    ``torch.export`` traces (its tensors are fake: the graph computes the
    weights itself)."""
    if torch.compiler.is_compiling():
        return _interp_matrix(n_in, n_out, device).to(dtype)
    return _cached_interp_matrix(n_in, n_out, device, dtype)


@functools.lru_cache(maxsize=None)
def _cached_interp_matrix(n_in: int, n_out: int, device, dtype) -> torch.Tensor:
    # made outside inference mode so that autograd may save them
    with torch.inference_mode(False):
        return _interp_matrix(n_in, n_out, device).to(dtype)


def _interp_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    if n_out == 1:
        src = torch.zeros(1, device=device)
    else:
        src = torch.arange(n_out, dtype=torch.float32, device=device) * ((n_in - 1) / (n_out - 1))
    i0 = torch.floor(src).long().clamp(0, n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    frac = src - i0
    rows = torch.arange(n_out, device=device)
    m = torch.zeros(n_out, n_in, device=device)
    m.index_put_((rows, i0), 1.0 - frac, accumulate=True)
    m.index_put_((rows, i1), frac, accumulate=True)
    return m


def resize_nchw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Align-corners bilinear resize of [..., H, W] maps (an NCHW tensor, or
    any leading dims) as two flat matrix products, the weights in x's dtype.
    (PyTorch's NCHW upsample kernel loops over batch x channels inside every
    thread, which is slow for the fine stage's many one-channel maps.)"""
    *lead, h, w = x.shape
    if (h, w) == (out_h, out_w):
        return x
    mh = interp_matrix_align_corners(h, out_h, x.device, x.dtype)
    mw = interp_matrix_align_corners(w, out_w, x.device, x.dtype)
    y = (x.reshape(-1, w) @ mw.t()).reshape(-1, h, out_w).transpose(1, 2)
    y = y.reshape(-1, h) @ mh.t()  # [maps * out_w, out_h]
    return y.reshape(*lead, out_w, out_h).transpose(-1, -2)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize [..., H, W, C] to [..., out_h, out_w, C] (align_corners=True)."""
    if tuple(x.shape[-3:-1]) == (out_h, out_w):
        return x
    return resize_nchw(x.movedim(-1, -3), out_h, out_w).movedim(-3, -1)


def interp_matrix_bicubic_torch(n_in: int, n_out: int, a: float = -0.75,
                                device=None) -> torch.Tensor:
    """[n_out, n_in] 1-D bicubic weights of ``F.interpolate(mode="bicubic",
    align_corners=False, antialias=False)``: half-pixel source coordinates,
    the Keys kernel with ``a`` = -0.75, taps clamped to the border. Built in
    f32 as the JAX package builds it."""
    src = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * (n_in / n_out) - 0.5
    f = torch.floor(src)
    frac = src - f
    i0 = f.long()

    def kernel(t):
        at = t.abs()
        near = (a + 2.0) * at ** 3 - (a + 3.0) * at ** 2 + 1.0
        far = a * at ** 3 - 5.0 * a * at ** 2 + 8.0 * a * at - 4.0 * a
        return torch.where(at <= 1.0, near, torch.where(at < 2.0, far, 0.0))

    rows = torch.arange(n_out, device=device)
    m = torch.zeros(n_out, n_in, device=device)
    for j in (-1, 0, 1, 2):
        m.index_put_((rows, (i0 + j).clamp(0, n_in - 1)), kernel(j - frac), accumulate=True)
    return m


def resize_bicubic_torch(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize [..., H, W, C] to [..., out_h, out_w, C] with torch-bicubic
    weights (:func:`interp_matrix_bicubic_torch`) as two matrix products,
    the weights in x's dtype (DINOv2's position-embedding resample)."""
    h, w = x.shape[-3], x.shape[-2]
    mh = interp_matrix_bicubic_torch(h, out_h, device=x.device).to(x.dtype)
    mw = interp_matrix_bicubic_torch(w, out_w, device=x.device).to(x.dtype)
    x = torch.einsum("oh,...hwc->...owc", mh, x)
    return torch.einsum("ow,...hwc->...hoc", mw, x)
