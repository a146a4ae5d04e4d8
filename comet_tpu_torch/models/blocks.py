"""Neural building blocks, PyTorch idiom, JAX layouts at the edges.

Counterpart of ``comet_tpu/models/blocks.py``. Parameters are kept in f32
(as the JAX package keeps them) and cast to the compute dtype at use, so
the weight bridge loads them exactly; after
``utils.serialization.cast_params_for_inference`` those casts are no-ops,
and the norms read their scale and bias in f32, as JAX does. Reference
quirks kept on purpose:

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

Tensor parallelism (``parallel.shard_params_tp``, the Megatron layout over
the mesh's model axis) leaves each rank a slice of the weights the rules
name and hands the modules the axis: a :class:`Linear` alone still gives its
whole output (a column-parallel one all-gathers its features, a row-parallel
one takes its slice of the input and sums over the axis), :func:`megatron_pair`
runs fc1 column-parallel, the activation on the local slice and fc2
row-parallel with one all-reduce, and :class:`MultiHeadAttention` runs K1 on
this rank's heads. K2 and K4 take whole-block weights: their blocks
all-gather the slices and launch the kernel unchanged, as GSPMD does for the
JAX package's Pallas calls. The collectives differentiate as Megatron's
pairs (``parallel.ModelAxis``): every column-parallel product, the
attention's in-projection over local heads too, is ``ModelAxis.column``,
whose backward sums the ranks' shares of its input's gradient, so the
parameters upstream of it get their whole gradient on every rank.
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
    "AttnBlock", "BatchNorm", "Conv2d", "CrossAttnBlock", "GroupNorm", "GroupNorm1", "InstanceNorm",
    "LayerNorm", "Linear", "Mlp", "MultiHeadAttention", "PoseEmbedding", "ResidualBlock",
    "SimplePoseEmbedding", "gelu", "init_params", "lecun_normal_", "megatron_pair", "set_route",
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
    """nn.Dense: f32 parameters, computes in ``dtype``.

    Under tensor parallelism ``tp`` is the model axis and the weight this
    rank's slice: column-parallel (``tp_dim`` 0, output features) or
    row-parallel (1, input features); the bias stays whole. The call still
    gives the whole output; :meth:`local` and :meth:`row` are the two halves
    of a Megatron pair, with no collective between them."""

    tp = None  # parallel.ModelAxis under tensor parallelism
    tp_dim = None

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def init_own_params(self, generator):
        lecun_normal_(self.weight, generator)
        self.bias.zero_()

    def forward(self, x):
        if self.tp is None:
            dt = self.compute_dtype
            return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))
        if self.tp_dim == 0:
            return self.tp.all_gather(self.local(x), -1)
        return self.row(self.tp.chunk(x, -1))

    def local(self, x):
        """Column-parallel: this rank's output features."""
        dt = self.compute_dtype
        return self.tp.column(x.to(dt), self.weight.to(dt), self.tp.chunk(self.bias, 0).to(dt))

    def row(self, x_local):
        """Row-parallel on this rank's input features: the whole output,
        summed over the model axis, then the bias. The partial products are
        taken and summed in f32 and rounded to the compute dtype once, as the
        unsharded product rounds its f32 accumulator once: partial sums
        rounded to bf16 before the sum put the sharded model's gradients
        further from f32 than the unsharded model's."""
        dt = self.compute_dtype
        partial = F.linear(x_local.to(dt).float(), self.weight.to(dt).float())
        return (self.tp.all_reduce(partial) + self.bias).to(dt)

    def full_weight(self, dt):
        """The whole weight in ``dt`` (all-gathered under tensor parallelism)."""
        w = self.weight.to(dt)
        return w if self.tp is None else self.tp.all_gather(w, self.tp_dim)


def megatron_pair(fc1: Linear, act, fc2: Linear, x):
    """``fc2(act(fc1(x)))``. With fc1 column- and fc2 row-parallel on one
    model axis the activation stays split between them: one all-reduce."""
    if fc1.tp is not None and fc1.tp_dim == 0 and fc2.tp is fc1.tp and fc2.tp_dim == 1:
        return fc2.row(act(fc1.local(x)))
    return fc2(act(fc1(x)))


class Conv2d(nn.Conv2d):
    """nn.Conv on NCHW tensors: f32 parameters, computes in ``dtype``;
    ``bias=False`` for flax's ``use_bias=False``."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, dtype=torch.float32,
                 bias: bool = True):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = dtype

    def init_own_params(self, generator):
        lecun_normal_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


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
        # f32 scale and bias, also after a one-time cast to the compute dtype
        # (JAX reads its cast parameters in f32 here)
        w = b = None
        if self.weight is not None:
            w, b = self.weight.float(), self.bias.float()
        if self.route.fused_ln:
            y = fused_layer_norm(x.contiguous(), w, b, self.eps)
            return y.to(self.compute_dtype)
        y = F.layer_norm(x.float(), (self.dim,), w, b, self.eps)
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
        return F.group_norm(x.float(), 1, self.weight.float(), self.bias.float(), self.eps)


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(use_running_average=True)`` on NCHW maps: always
    the running statistics (eps 1e-5), in train mode too; the statistics come
    from flax's ``batch_stats`` through the weight bridge."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean.to(x.dtype), self.running_var.to(x.dtype),
                            self.weight.to(x.dtype), self.bias.to(x.dtype), False, 0.0, self.eps)


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
        return megatron_pair(self.fc1, gelu, self.fc2, x)


class MultiHeadAttention(nn.Module):
    """torch nn.MultiheadAttention semantics with a packed in-projection
    (``in_proj_weight`` [3E, E]); the projections are handed to K1 as column
    slices, with no head-split copy. Under tensor parallelism (``tp``) the
    in-projection holds the q, k and v rows of this rank's heads, K1 runs on
    those heads, and ``out_proj`` is row-parallel: one all-reduce."""

    tp = None  # parallel.ModelAxis under tensor parallelism

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

    def forward(self, q, k, v, mask=None):
        """``mask`` (broadcast against the [..., heads, Lq, Lk] logits, True
        where a key is seen) takes the plain masked path: f32 logits, masked
        entries at the f32 minimum, softmax, in PyTorch ops (K1 is
        mask-free)."""
        dt = self.compute_dtype
        w = self.in_proj_weight.to(dt)
        b, heads = self.in_proj_bias, self.num_heads
        linear = F.linear
        if self.tp is not None:  # this rank's heads: their entries of q, k and v
            b = torch.cat([self.tp.chunk(part, 0) for part in b.chunk(3)])
            heads //= self.tp.size
            linear = self.tp.column
        b = b.to(dt)
        e = w.shape[0] // 3  # the width of (this rank's heads of) q, k and v
        if q is k and k is v:
            wq, wk, wv = linear(q.to(dt), w, b).split(e, dim=-1)
        else:
            wq = linear(q.to(dt), w[:e], b[:e])
            if k is v:
                wk, wv = linear(k.to(dt), w[e:], b[e:]).split(e, dim=-1)
            else:
                wk = linear(k.to(dt), w[e : 2 * e], b[e : 2 * e])
                wv = linear(v.to(dt), w[2 * e :], b[2 * e :])
        lead = wq.shape[:-2]
        lq, lk = wq.shape[-2], wk.shape[-2]
        if mask is None:
            out = fused_attention(
                wq.reshape(-1, lq, e), wk.reshape(-1, lk, e), wv.reshape(-1, lk, e), heads
            ).reshape(*lead, lq, e)
        else:
            out = _masked_attention(wq, wk, wv, heads, mask)
        return self.out_proj(out) if self.tp is None else self.out_proj.row(out)

    def full_in_proj(self, dt):
        """The whole [3E, E] in-projection in ``dt``, q | k | v (all-gathered
        and put back in that order under tensor parallelism)."""
        w = self.in_proj_weight.to(dt)
        if self.tp is None:
            return w
        n, e = self.tp.size, w.shape[1]
        return self.tp.all_gather(w, 0).reshape(n, 3, e // n, e).transpose(0, 1).reshape(3 * e, e)


def _masked_attention(wq, wk, wv, heads: int, mask):
    """Attention over projected [..., L, E] q, k, v with a key mask: the JAX
    package's masked path (scale folded into q in the compute dtype, logits
    in f32, masked logits at the f32 minimum)."""
    dt, e = wq.dtype, wq.shape[-1]
    hd = e // heads

    def split(x):
        return x.reshape(*x.shape[:-1], heads, hd)

    scale = torch.tensor(1.0 / hd ** 0.5, dtype=dt)
    logits = torch.einsum("...qhd,...khd->...hqk", (split(wq) * scale).float(), split(wk).float())
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(dt)
    out = torch.einsum("...hqk,...khd->...qhd", weights, split(wv))
    return out.reshape(*out.shape[:-2], e)


class SimplePoseEmbedding(nn.Module):
    """Learned pose-encoding embedding: fc1 -> GELU -> LN -> fc2 -> LN,
    hidden output_dim // 2; its LayerNorms take torch's eps 1e-5, not the
    blocks' 1e-6."""

    def __init__(self, in_dim: int, output_dim: int = 768, dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(in_dim, output_dim // 2, dtype)
        self.norm1 = LayerNorm(output_dim // 2, 1e-5, dtype=dtype)
        self.fc2 = Linear(output_dim // 2, output_dim, dtype)
        self.norm2 = LayerNorm(output_dim, 1e-5, dtype=dtype)

    def forward(self, x):
        return self.norm2(self.fc2(self.norm1(gelu(self.fc1(x)))))


class PoseEmbedding(nn.Module):
    """Pose encoding -> token embedding: the learned
    :class:`SimplePoseEmbedding` (``emb``), or, with ``learned=False``, the
    parameter-free harmonic encoding it replaced."""

    def __init__(self, in_dim: int, target_dim: int = 768, n_harmonic_functions: int = 10,
                 append_input: bool = True, learned: bool = True, dtype=torch.float32):
        super().__init__()
        self.n_harmonic_functions, self.append_input = n_harmonic_functions, append_input
        self.emb = SimplePoseEmbedding(in_dim, target_dim, dtype) if learned else None

    def forward(self, pose_encoding):
        if self.emb is not None:
            return self.emb(pose_encoding)
        from ..geometry.embeddings import harmonic_embedding

        return harmonic_embedding(pose_encoding, n_harmonic_functions=self.n_harmonic_functions,
                                  append_input=self.append_input)


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
                a.full_in_proj(dt), a.in_proj_bias.to(dt),
                a.out_proj.full_weight(dt), a.out_proj.bias.to(dt),
                m.fc1.full_weight(dt), m.fc1.bias.to(dt),
                m.fc2.full_weight(dt), m.fc2.bias.to(dt),
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
            w, b = a.full_in_proj(dt), a.in_proj_bias.to(dt)
            return fused_cross_block(
                x.to(dt).contiguous(), context.to(dt).contiguous(),
                nc.weight.to(dt), nc.bias.to(dt),
                w[:e], b[:e], w[e:], b[e:],
                a.out_proj.full_weight(dt), a.out_proj.bias.to(dt),
                m.fc1.full_weight(dt), m.fc1.bias.to(dt),
                m.fc2.full_weight(dt), m.fc2.bias.to(dt),
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


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on NCHW maps: statistics in f32 over each
    group's channels and the spatial axes, eps 1e-6, affine."""

    def __init__(self, num_groups: int, dim: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def init_own_params(self, generator):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class ResidualBlock(nn.Module):
    """Two 3x3 convs with a residual, NCHW; a 1x1 conv + norm on the
    shortcut when stride != 1. ``norm_fn``: "instance" (no parameters),
    "group" (planes // 8 groups, affine ``norm1``..``norm3``) or "none"."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1, norm_fn: str = "instance",
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride, padding=1, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, dtype=dtype)
        self.downsample = (
            Conv2d(in_planes, planes, 1, stride=stride, dtype=dtype) if stride != 1 else None
        )

        def norm():
            if norm_fn == "instance":
                return InstanceNorm()
            if norm_fn == "group":
                return GroupNorm(planes // 8, planes)
            if norm_fn == "none":
                return nn.Identity()
            raise NotImplementedError(norm_fn)

        self.norm1, self.norm2 = norm(), norm()
        self.norm3 = norm() if stride != 1 else None

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm3(self.downsample(x))
        return F.relu(x + y)
