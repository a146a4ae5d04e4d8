"""Neural building blocks, PyTorch idiom, JAX layouts at the edges.

Counterpart of ``comet_tpu/models/blocks.py``. Parameters are kept in f32
(as the JAX package keeps them) and cast to the compute dtype at use, so
the weight bridge loads them exactly. Reference quirks kept on purpose:

- AttnBlock / CrossAttnBlock re-base the residual stream on the normalized
  input (``x = norm1(x); x = x + attn(x)``);
- GELU is exact (erf) in f32 and the tanh form in bf16;
- LayerNorm statistics are f32 whatever the compute dtype.

Every mask-free attention goes through ``ops.attn.fused_attention`` (K1, or
K3 for many short sequences). Where the JAX package has a kernel switch, a
:class:`~comet_tpu_torch.config.KernelRoute` on the module chooses, with the
JAX gates: an AttnBlock over short sequences (L <= 64, rows >= 256) runs as
``ops.block.fused_attn_block`` (K2) under ``fused_block``; a CrossAttnBlock
with Lq <= 512, Lk <= 1024 and rows >= 256 as ``ops.block.fused_cross_block``
(K4) under ``fused_cross``; every LayerNorm as ``ops.norm.fused_layer_norm``
(K5) under ``fused_ln``. :func:`set_route` sets the route on a whole model.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import KernelRoute
from ..ops.attn import fused_attention
from ..ops.block import fused_attn_block, fused_cross_block, gelu
from ..ops.norm import fused_layer_norm

__all__ = [
    "AttnBlock", "Conv2d", "CrossAttnBlock", "GroupNorm1", "InstanceNorm", "LayerNorm",
    "Linear", "Mlp", "MultiHeadAttention", "ResidualBlock", "gelu", "init_params",
    "lecun_normal_", "set_route",
]


def lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """flax ``lecun_normal``: truncated normal (2 std) with variance
    1 / fan_in, fan_in = in_features * kernel area."""
    fan_in = w.shape[1] * (w[0, 0].numel() if w.dim() > 2 else 1)
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_params(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Initialize every parameter of ``module`` with the JAX package's
    initializers, drawing from ``generator``."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "init_own_params"):
                m.init_own_params(generator)


class Linear(nn.Linear):
    """nn.Dense: f32 parameters, computes in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def init_own_params(self, generator):
        lecun_normal_(self.weight, generator)
        self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv2d(nn.Conv2d):
    """nn.Conv on NCHW tensors: f32 parameters, computes in ``dtype``."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, dtype=torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def init_own_params(self, generator):
        lecun_normal_(self.weight, generator)
        self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with f32 statistics (the JAX package's
    FusedLayerNorm): the result is cast to the input dtype, then to
    ``dtype``. K5 under ``route.fused_ln``."""

    def __init__(self, dim: int, eps: float = 1e-6, affine: bool = True, dtype=torch.float32):
        super().__init__()
        self.dim, self.eps, self.compute_dtype = dim, eps, dtype
        self.route = KernelRoute()
        if affine:
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def init_own_params(self, generator):
        if self.weight is not None:
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        if self.route.fused_ln:
            y = fused_layer_norm(x.contiguous(), self.weight, self.bias, self.eps)
            return y.to(self.compute_dtype)
        y = F.layer_norm(x.float(), (self.dim,), self.weight, self.bias, self.eps)
        return y.to(x.dtype).to(self.compute_dtype)


class GroupNorm1(nn.Module):
    """flax ``nn.GroupNorm(num_groups=1)`` on [rows, C]: per-row statistics
    over C in f32, eps 1e-6, affine; returns f32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def init_own_params(self, generator):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return F.group_norm(x.float(), 1, self.weight, self.bias, self.eps)


class InstanceNorm(nn.Module):
    """InstanceNorm2d without affine on NCHW: f32 statistics over H, W."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(-2, -1), keepdim=True, unbiased=False)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2."""

    def __init__(self, in_features: int, hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        hidden = hidden_features or in_features
        self.fc1 = Linear(in_features, hidden, dtype)
        self.fc2 = Linear(hidden, out_features or in_features, dtype)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class MultiHeadAttention(nn.Module):
    """torch nn.MultiheadAttention semantics with a packed in-projection
    (``in_proj_weight`` [3E, E]); the projections are handed to K1 as column
    slices, with no head-split copy."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.num_heads, self.compute_dtype = num_heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim, dtype)

    def init_own_params(self, generator):
        lecun_normal_(self.in_proj_weight, generator)
        self.in_proj_bias.zero_()

    def forward(self, q, k, v):
        e = q.shape[-1]
        dt = self.compute_dtype
        w = self.in_proj_weight.to(dt)
        b = self.in_proj_bias.to(dt)
        if q is k and k is v:
            wq, wk, wv = F.linear(q.to(dt), w, b).split(e, dim=-1)
        else:
            wq = F.linear(q.to(dt), w[:e], b[:e])
            if k is v:
                wk, wv = F.linear(k.to(dt), w[e:], b[e:]).split(e, dim=-1)
            else:
                wk = F.linear(k.to(dt), w[e : 2 * e], b[e : 2 * e])
                wv = F.linear(v.to(dt), w[2 * e :], b[2 * e :])
        lead = wq.shape[:-2]
        lq, lk = wq.shape[-2], wk.shape[-2]
        out = fused_attention(
            wq.reshape(-1, lq, e), wk.reshape(-1, lk, e), wv.reshape(-1, lk, e), self.num_heads
        ).reshape(*lead, lq, e)
        return self.out_proj(out)


class AttnBlock(nn.Module):
    """Self-attention block; the residual stream is re-based on the
    normalized input. Short sequences with many rows (L <= 64, rows >= 256:
    the update-formers' time and virtual blocks) run as one K2 launch under
    ``route.fused_block``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.compute_dtype = num_heads, dtype
        self.route = KernelRoute()
        self.norm1 = LayerNorm(dim, 1e-6, affine=False, dtype=dtype)
        self.attn = MultiHeadAttention(dim, num_heads, dtype)
        self.norm2 = LayerNorm(dim, 1e-6, affine=False, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x):
        if (
            self.route.fused_block
            and x.dim() == 3 and x.shape[1] <= 64 and x.shape[0] * x.shape[1] >= 256
        ):
            dt = self.compute_dtype
            a, m = self.attn, self.mlp
            return fused_attn_block(
                x.to(dt).contiguous(),
                a.in_proj_weight.to(dt), a.in_proj_bias.to(dt),
                a.out_proj.weight.to(dt), a.out_proj.bias.to(dt),
                m.fc1.weight.to(dt), m.fc1.bias.to(dt),
                m.fc2.weight.to(dt), m.fc2.bias.to(dt),
                self.num_heads,
            )
        x = self.norm1(x)
        x = x + self.attn(x, x, x)
        return x + self.mlp(self.norm2(x))


class CrossAttnBlock(nn.Module):
    """Cross-attention block with an affine ``norm_context``; the residual
    stream is re-based on the normalized query. Under ``route.fused_cross``
    the JAX gate (Lq <= 512, Lk <= 1024, rows >= 256: the coarse
    update-former's space blocks) sends it to one K4 kernel."""

    def __init__(self, dim: int, num_heads: int = 1, mlp_ratio: float = 4.0, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.compute_dtype = num_heads, dtype
        self.route = KernelRoute()
        self.norm1 = LayerNorm(dim, 1e-6, affine=False, dtype=dtype)
        self.norm_context = LayerNorm(dim, 1e-6, affine=True, dtype=dtype)
        self.cross_attn = MultiHeadAttention(dim, num_heads, dtype)
        self.norm2 = LayerNorm(dim, 1e-6, affine=False, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x, context):
        if (
            self.route.fused_cross
            and x.dim() == 3 and context.dim() == 3
            and x.shape[1] <= 512 and context.shape[1] <= 1024
            and x.shape[0] * x.shape[1] >= 256
        ):
            dt, e = self.compute_dtype, x.shape[-1]
            a, m, nc = self.cross_attn, self.mlp, self.norm_context
            w, b = a.in_proj_weight.to(dt), a.in_proj_bias.to(dt)
            return fused_cross_block(
                x.to(dt).contiguous(), context.to(dt).contiguous(),
                nc.weight.to(dt), nc.bias.to(dt),
                w[:e], b[:e], w[e:], b[e:],
                a.out_proj.weight.to(dt), a.out_proj.bias.to(dt),
                m.fc1.weight.to(dt), m.fc1.bias.to(dt),
                m.fc2.weight.to(dt), m.fc2.bias.to(dt),
                self.num_heads,
            )
        x = self.norm1(x)
        context = self.norm_context(context)
        x = x + self.cross_attn(x, context, context)
        return x + self.mlp(self.norm2(x))


def set_route(module: nn.Module, route: KernelRoute) -> None:
    """Set ``route`` on every AttnBlock, CrossAttnBlock and LayerNorm under
    ``module``. Parameters are untouched: one state_dict serves every route."""
    for m in module.modules():
        if isinstance(m, (AttnBlock, CrossAttnBlock, LayerNorm)):
            m.route = route


class ResidualBlock(nn.Module):
    """Two 3x3 convs with a residual (instance norm), NCHW; a 1x1 conv +
    norm on the shortcut when stride != 1."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride, padding=1, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, dtype=dtype)
        self.norm = InstanceNorm()
        self.downsample = (
            Conv2d(in_planes, planes, 1, stride=stride, dtype=dtype) if stride != 1 else None
        )

    def forward(self, x):
        y = F.relu(self.norm(self.conv1(x)))
        y = F.relu(self.norm(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm(self.downsample(x))
        return F.relu(x + y)
