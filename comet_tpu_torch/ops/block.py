"""One whole self-attention block over many short sequences (K2).

Counterpart of ``comet_tpu/ops/pallas_block.py::fused_attn_block``. On a CUDA
tensor every call launches the hand-written kernel ``csrc/block.cu``; on a
CPU tensor it runs :func:`block_reference`, the plain PyTorch version with
the kernel's rounding points. Weights are in the port's [out, in] layout.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

from . import kernels

# (C, num_heads) the kernel is compiled for: the coarse (384, 8) and fine
# (256, 8) update-former time blocks.
SUPPORTED_WIDTHS = ((384, 8), (256, 8))


def layer_norm_plain(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Scale- and bias-free LayerNorm with f32 statistics, in x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in f32, the tanh form on bf16 values."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def block_reference(
    x, wqkv, bqkv, wout, bout, w1, b1, w2, b2, num_heads: int
) -> torch.Tensor:
    """AttnBlock on [B, L, C]: per-sequence attention, residual re-based on
    ln1(x), each matmul rounded to x's dtype before its bias add."""
    b, l, c = x.shape
    d = c // num_heads
    dt = x.dtype
    xn = layer_norm_plain(x)
    qkv = torch.matmul(xn, wqkv.t()).to(dt) + bqkv
    q, k, v = (t.reshape(b, l, num_heads, d) for t in qkv.split(c, dim=-1))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / d ** 0.5)
    w = torch.softmax(logits, dim=-1).to(dt)
    a = torch.einsum("bhqk,bkhd->bqhd", w, v).to(dt).reshape(b, l, c)
    x1 = xn + (torch.matmul(a, wout.t()).to(dt) + bout)
    y = layer_norm_plain(x1)
    h = gelu(torch.matmul(y, w1.t()).to(dt) + b1)
    return x1 + (torch.matmul(h, w2.t()).to(dt) + b2)


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.bfloat16:
        if t.dtype == torch.float32:
            raise NotImplementedError("fused_attn_block on CUDA takes bfloat16 only")
        raise ValueError(f"fused_attn_block: {name} has dtype {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"fused_attn_block: {name} is on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_attn_block: {name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_attn_block: {name} must be contiguous and 16-byte aligned")


def fused_attn_block(
    x: torch.Tensor,  # [B, L, C], L divides 64
    wqkv: torch.Tensor,  # [3C, C] packed in-projection
    bqkv: torch.Tensor,  # [3C]
    wout: torch.Tensor,  # [C, C]
    bout: torch.Tensor,  # [C]
    w1: torch.Tensor,  # [hidden, C]
    b1: torch.Tensor,  # [hidden]
    w2: torch.Tensor,  # [C, hidden]
    b2: torch.Tensor,  # [C]
    num_heads: int,
) -> torch.Tensor:
    """One AttnBlock application: x1 = ln1(x) + attn(ln1(x));
    out = x1 + mlp(ln2(x1)). Returns [B, L, C] in x's dtype."""
    if x.device.type == "cpu":
        return block_reference(x, wqkv, bqkv, wout, bout, w1, b1, w2, b2, num_heads)
    b, l, c = x.shape
    hidden = w1.shape[0]
    if (c, num_heads) not in SUPPORTED_WIDTHS:
        raise ValueError(f"fused_attn_block: (C, heads) = {(c, num_heads)} not compiled")
    if l < 1 or 64 % l or hidden % 128:
        raise ValueError(f"fused_attn_block: L {l} must divide 64, hidden {hidden} % 128 == 0")
    for name, t, shape in (
        ("x", x, (b, l, c)), ("wqkv", wqkv, (3 * c, c)), ("bqkv", bqkv, (3 * c,)),
        ("wout", wout, (c, c)), ("bout", bout, (c,)), ("w1", w1, (hidden, c)),
        ("b1", b1, (hidden,)), ("w2", w2, (c, hidden)), ("b2", b2, (c,)),
    ):
        _check(name, t, shape)
        if t.device != x.device:
            raise ValueError(f"fused_attn_block: {name} is on {t.device}, x on {x.device}")
    out = torch.empty_like(x)
    if b == 0:
        return out
    rc = kernels.library().comet_attn_block_fwd(
        x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wout.data_ptr(), bout.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        b * l, l, c, num_heads, hidden, torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check_launch(rc, "fused_attn_block")
    fused_attn_block.launches += 1
    fused_attn_block.launch_shapes[(b, l, c, num_heads, hidden)] += 1
    return out


# launches of the kernel, in all and by (B, L, C, heads, hidden)
fused_attn_block.launches = 0
fused_attn_block.launch_shapes = Counter()
