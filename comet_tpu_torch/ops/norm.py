"""Row LayerNorm (K5).

Counterpart of ``comet_tpu/ops/pallas_norm.py::fused_layer_norm``. On a
CUDA tensor every call launches the hand-written kernel ``csrc/norm.cu``; on
a CPU tensor it runs :func:`layer_norm_reference`, the plain PyTorch version
of the same function: the wrapper calls the registered operator
``comet::layer_norm`` (``ops/library.py``), whose dispatch key picks one.
The gradient is the plain version's, recomputed from the saved inputs, as
``pallas_norm.py::_ln_bwd``.
"""

from __future__ import annotations

import functools
from collections import Counter
from typing import Callable, NamedTuple, Optional

import torch

from . import kernels

MAX_WIDTH = 1024
# K5 as compiled: CTAs of 256 threads, at most 8 16-byte vectors a lane
NORM_THREADS = 256
NORM_MAX_VECTORS = 8
# the group widths (lanes per row) the kernel is compiled for
NORM_GROUPS = (16, 32)
# dtype -> (name in the launch counter, is_bf16)
_DTYPES = {torch.bfloat16: ("bfloat16", 1), torch.float32: ("float32", 0)}


class NormPlan(NamedTuple):
    group: int  # lanes per row
    vectors: int  # 16-byte vectors each lane holds
    two: bool  # a group may take more than one row (the next one's loads go out early)
    grid: int  # CTAs; group g of CTA b takes rows g * grid + b + k * (256 / group) * grid


def norm_group(c: int, itemsize: int) -> tuple:
    """(lanes per row, vectors per lane) for rows of ``c`` values of
    ``itemsize`` bytes, as 16-byte vectors: 32 lanes where they all hold the
    same number of vectors and at least two (so each lane's later loads queue
    behind its first), or where 16 lanes would need more than the compiled
    8 vectors each; else 16 lanes (bf16 C 256 and 384: 2 and 3 vectors each,
    no lane idle)."""
    nvec = c * itemsize // 16
    group = 32 if (nvec % 32 == 0 and nvec >= 64) or -(-nvec // 16) > NORM_MAX_VECTORS else 16
    return group, -(-nvec // group)


def norm_plan(rows: int, c: int, itemsize: int, sms: int,
              resident: Callable[[int, bool], int]) -> NormPlan:
    """K5's launch for ``rows`` rows of ``c`` values: the group from
    :func:`norm_group`, and a persistent grid of at most as many CTAs as the
    card holds at once (``resident(group, two)`` per SM, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), so no CTA waits for a
    second wave. Where the card holds a group for every row at once, each
    group takes one row (the kernel without a second row buffer), and since
    consecutive rows go to different CTAs, rows that would leave SMs empty
    get a CTA for each SM (or row); else every CTA the card holds, each group
    walking its rows with the next one's loads in flight."""
    group, vectors = norm_group(c, itemsize)
    per_step = NORM_THREADS // group  # rows a CTA takes at once
    steps = -(-rows // per_step)
    if steps <= sms * resident(group, False):
        return NormPlan(group, vectors, False, max(steps, min(rows, sms)))
    return NormPlan(group, vectors, True, sms * resident(group, True))


@functools.lru_cache(maxsize=None)
def _resident(index: int, c: int, is_bf16: int, group: int, two: bool, affine: bool) -> int:
    with torch.cuda.device(index):
        n = kernels.library().comet_layer_norm_resident(c, is_bf16, group, int(two), int(affine))
    if n < 1:
        raise RuntimeError("fused_layer_norm: cudaOccupancyMaxActiveBlocksPerMultiprocessor failed")
    return n


@functools.lru_cache(maxsize=4096)
def _card_plan(index: int, rows: int, c: int, is_bf16: int, affine: bool) -> NormPlan:
    return norm_plan(rows, c, 2 if is_bf16 else 4, kernels.sm_count(index),
                     lambda g, two: _resident(index, c, is_bf16, g, two, affine))


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
    return torch.ops.comet.layer_norm.default(x, scale, bias, float(eps))


def launch(x, scale, bias, eps: float) -> torch.Tensor:
    """K5 on CUDA tensors (``comet::layer_norm``'s CUDA implementation):
    check, plan, launch and count."""
    c = x.shape[-1]
    kind = _DTYPES.get(x.dtype)
    if kind is None:
        raise ValueError(f"fused_layer_norm: x has dtype {x.dtype}")
    if c % 8 or not 8 <= c <= MAX_WIDTH:
        raise ValueError(f"fused_layer_norm: width {c} must be a multiple of 8 in [8, {MAX_WIDTH}]")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_layer_norm: x must be contiguous and 16-byte aligned")
    device = x.device
    affine = scale is not None
    if affine:
        for name, t in (("scale", scale), ("bias", bias)):
            if (t.dtype != torch.float32 or t.shape != (c,) or t.device != device
                    or not t.is_contiguous() or t.data_ptr() % 16):
                raise ValueError(
                    f"fused_layer_norm: {name} must be a contiguous, 16-byte aligned f32 [{c}] "
                    f"on {device}"
                )
    out = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return out
    index = device.index
    plan = _card_plan(index, rows, c, kind[1], affine)
    rc = kernels.library().comet_layer_norm_fwd(
        x.data_ptr(), scale.data_ptr() if affine else None, bias.data_ptr() if affine else None,
        out.data_ptr(), rows, c, kind[1], float(eps), plan.group, int(plan.two), plan.grid,
        kernels.stream(index),
    )
    kernels.check_launch(rc, "fused_layer_norm")
    fused_layer_norm.launches += 1
    fused_layer_norm.launch_shapes[(rows, c, kind[0], affine)] += 1
    return out


# launches of the kernel, in all and by (rows, C, dtype, affine)
fused_layer_norm.launches = 0
fused_layer_norm.launch_shapes = Counter()
