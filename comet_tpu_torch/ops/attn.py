"""Multi-head attention on the [B, L, H*D] projection layout (K1).

Counterpart of ``comet_tpu/ops/pallas_attn.py::fused_attention``. On a CUDA
tensor every call launches the hand-written kernel ``csrc/attn.cu``; on a CPU
tensor it runs :func:`attention_reference`, the plain PyTorch version of the
same function. There is no shape gate: the TPU's gates were measured on a TPU.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from . import kernels

SUPPORTED_HEAD_DIMS = (32, 48, 64, 96)


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


def _check_operand(name: str, t: torch.Tensor, length: int, c: int) -> None:
    if t.dtype != torch.bfloat16:
        if t.dtype == torch.float32:
            raise NotImplementedError("fused_attention on CUDA takes bfloat16 only")
        raise ValueError(f"fused_attention: {name} has dtype {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"fused_attention: {name} is on {t.device}")
    if t.dim() != 3 or t.shape[1] != length or t.shape[2] != c:
        raise ValueError(f"fused_attention: {name} has shape {tuple(t.shape)}")
    if t.stride(2) != 1 or _stride(t, 1) % 8 or _stride(t, 0) % 8 or t.data_ptr() % 16:
        raise ValueError(
            f"fused_attention: {name} needs unit column stride and 16-byte aligned rows"
        )


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
    column stride is required, rows and batches may be strided.
    """
    b, lq, c = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = 1.0 / (c // num_heads) ** 0.5
    if q.device.type == "cpu":
        return attention_reference(q, k, v, num_heads, scale)
    if c % num_heads or c // num_heads not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"fused_attention: head dim {c / num_heads} not in {SUPPORTED_HEAD_DIMS}"
        )
    _check_operand("q", q, lq, c)
    _check_operand("k", k, lk, c)
    _check_operand("v", v, lk, c)
    if k.shape[0] != b or v.shape[0] != b or k.device != q.device or v.device != q.device:
        raise ValueError("fused_attention: q, k, v disagree in batch or device")
    out = torch.empty((b, lq, c), dtype=q.dtype, device=q.device)
    if b == 0 or lq == 0:
        return out
    if lk == 0:
        raise ValueError("fused_attention: no keys")
    rc = kernels.library().comet_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, num_heads, c // num_heads, lq, lk,
        _stride(q, 0), _stride(q, 1), _stride(k, 0), _stride(k, 1),
        _stride(v, 0), _stride(v, 1),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check_launch(rc, "fused_attention")
    fused_attention.launches += 1
    fused_attention.launch_shapes[(b, lq, lk, c, num_heads)] += 1
    return out


# launches of the kernel, in all and by (B, Lq, Lk, C, heads)
fused_attention.launches = 0
fused_attention.launch_shapes = Counter()
