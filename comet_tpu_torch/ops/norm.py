"""Row LayerNorm (K5).

Counterpart of ``comet_tpu/ops/pallas_norm.py::fused_layer_norm``. On a
CUDA tensor every call launches the hand-written kernel ``csrc/norm.cu``; on
a CPU tensor it runs :func:`layer_norm_reference`, the plain PyTorch version
of the same function.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from . import kernels

MAX_WIDTH = 1024


def layer_norm_reference(
    x: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """LayerNorm over the last axis: f32 mean, the variance as the mean of
    the squared centered values, rsqrt(var + eps), scale and bias in f32
    (None: ones and zeros), the result in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def fused_layer_norm(
    x: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """LayerNorm over the last axis of a contiguous bf16 or f32 tensor, with
    f32 statistics; scale and bias are f32 [C], both or neither. Returns a
    tensor of x's shape and dtype."""
    if (scale is None) != (bias is None):
        raise ValueError("fused_layer_norm: give scale and bias together, or neither")
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps)
    c = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_layer_norm: x has dtype {x.dtype}")
    if c % 8 or not 8 <= c <= MAX_WIDTH:
        raise ValueError(f"fused_layer_norm: width {c} must be a multiple of 8 in [8, {MAX_WIDTH}]")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_layer_norm: x must be contiguous and 16-byte aligned")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (
            t.dtype != torch.float32 or t.shape != (c,) or t.device != x.device
            or not t.is_contiguous() or t.data_ptr() % 16
        ):
            raise ValueError(
                f"fused_layer_norm: {name} must be a contiguous, 16-byte aligned f32 [{c}] "
                f"on {x.device}"
            )
    out = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return out
    rc = kernels.library().comet_layer_norm_fwd(
        x.data_ptr(),
        scale.data_ptr() if scale is not None else None,
        bias.data_ptr() if bias is not None else None,
        out.data_ptr(), rows, c, int(x.dtype == torch.bfloat16), float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check_launch(rc, "fused_layer_norm")
    fused_layer_norm.launches += 1
    fused_layer_norm.launch_shapes[(rows, c, str(x.dtype).replace("torch.", ""), scale is not None)] += 1
    return out


# launches of the kernel, in all and by (rows, C, dtype, affine)
fused_layer_norm.launches = 0
fused_layer_norm.launch_shapes = Counter()
