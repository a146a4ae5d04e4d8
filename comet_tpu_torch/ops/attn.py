"""Multi-head attention on the [B, L, H*D] projection layout (K1 and K3).

Counterpart of ``comet_tpu/ops/pallas_attn.py::fused_attention`` and its two
regimes. On a CUDA tensor :func:`fused_attention` sends many short
sequences (Lq <= 64, Lk <= 64 and B*Lq >= 256, the JAX packed regime) to
K3, :func:`short_attention` (``csrc/short_attn.cu``), and every other call
to K1 (``csrc/attn.cu``), including the shapes the JAX package sends to its
reference. On a CPU tensor both run :func:`attention_reference`, the plain
PyTorch version of the same function.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from . import kernels

SUPPORTED_HEAD_DIMS = (32, 48, 64, 96)
# K3 takes sequences up to this long when there are at least this many rows
SHORT_MAX_LEN = 64
SHORT_MIN_ROWS = 256


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """Plain MHA on [B, L, C]: f32 logits (scale on the logits), f32
    softmax, weights cast to the input dtype before the value product."""
    b, lq, c = q.shape
    lk = k.shape[1]
    d = c // num_heads
    qh = q.reshape(b, lq, num_heads, d)
    kh = k.reshape(b, lk, num_heads, d)
    vh = v.reshape(b, lk, num_heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * scale
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, vh)
    return out.reshape(b, lq, c)


def _stride(t: torch.Tensor, dim: int) -> int:
    # a size-1 dimension is never stepped over, whatever stride it reports
    return 0 if t.shape[dim] == 1 else t.stride(dim)


def kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """t as the kernels take it: t itself, or a contiguous copy when a
    dimension longer than 1 has stride 0 (an ``expand``), since the kernels
    step over every such dimension in memory."""
    if any(n > 1 and s == 0 for n, s in zip(t.shape, t.stride())):
        return t.contiguous()
    return t


def _check_operand(name: str, t: torch.Tensor, length: int, c: int) -> None:
    if t.dtype != torch.bfloat16:
        if t.dtype == torch.float32:
            raise NotImplementedError("attention on CUDA takes bfloat16 only")
        raise ValueError(f"attention: {name} has dtype {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"attention: {name} is on {t.device}")
    if t.dim() != 3 or t.shape[1] != length or t.shape[2] != c:
        raise ValueError(f"attention: {name} has shape {tuple(t.shape)}")
    if t.stride(2) != 1 or _stride(t, 1) % 8 or _stride(t, 0) % 8 or t.data_ptr() % 16:
        raise ValueError(
            f"attention: {name} needs unit column stride and 16-byte aligned rows"
        )


def _launch(entry: str, q, k, v, num_heads: int, scale: float) -> torch.Tensor:
    """Check the operands and launch the kernel behind the C entry point
    ``entry`` (no launch for an empty output)."""
    b, lq, c = q.shape
    lk = k.shape[1]
    if c % num_heads or c // num_heads not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"attention: head dim {c / num_heads} not in {SUPPORTED_HEAD_DIMS}")
    q, k, v = (kernel_operand(t) for t in (q, k, v))
    _check_operand("q", q, lq, c)
    _check_operand("k", k, lk, c)
    _check_operand("v", v, lk, c)
    if k.shape[0] != b or v.shape[0] != b or k.device != q.device or v.device != q.device:
        raise ValueError("attention: q, k, v disagree in batch or device")
    out = torch.empty((b, lq, c), dtype=q.dtype, device=q.device)
    if b == 0 or lq == 0:
        return out
    if lk == 0:
        raise ValueError("attention: no keys")
    rc = getattr(kernels.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, num_heads, c // num_heads, lq, lk,
        _stride(q, 0), _stride(q, 1), _stride(k, 0), _stride(k, 1),
        _stride(v, 0), _stride(v, 1),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check_launch(rc, entry)
    return out


def is_short(b: int, lq: int, lk: int) -> bool:
    """The JAX packed regime: many short sequences."""
    return lq <= SHORT_MAX_LEN and lk <= SHORT_MAX_LEN and b * lq >= SHORT_MIN_ROWS


def short_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K3: :func:`fused_attention` for Lq, Lk <= 64, one (sequence, head)
    pair computed directly per warp. Same arguments and result."""
    b, lq, c = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = 1.0 / (c // num_heads) ** 0.5
    if q.device.type == "cpu":
        return attention_reference(q, k, v, num_heads, scale)
    if lq > SHORT_MAX_LEN or lk > SHORT_MAX_LEN:
        raise ValueError(f"short_attention: Lq {lq} and Lk {lk} must be <= {SHORT_MAX_LEN}")
    out = _launch("comet_short_attn_fwd", q, k, v, num_heads, scale)
    if out.numel():
        short_attention.launches += 1
        short_attention.launch_shapes[(b, lq, lk, c, num_heads)] += 1
    return out


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """softmax(scale * Q_h K_h^T) V_h per head, on [B, Lq, C] / [B, Lk, C].

    Returns [B, Lq, C] (before the output projection) in the input dtype.
    q, k and v may be column slices of one packed projection: only unit
    column stride is required, rows and batches may be strided. On CUDA,
    the packed regime (:func:`is_short`) goes to K3 and the rest to K1;
    ``fused_attention.launches`` counts K1's launches.
    """
    b, lq, c = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = 1.0 / (c // num_heads) ** 0.5
    if is_short(b, lq, lk):
        return short_attention(q, k, v, num_heads, scale)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, num_heads, scale)
    out = _launch("comet_attn_fwd", q, k, v, num_heads, scale)
    if out.numel():
        fused_attention.launches += 1
        fused_attention.launch_shapes[(b, lq, lk, c, num_heads)] += 1
    return out


# launches of each kernel, in all and by (B, Lq, Lk, C, heads): K1, K3
fused_attention.launches = 0
fused_attention.launch_shapes = Counter()
short_attention.launches = 0
short_attention.launch_shapes = Counter()
