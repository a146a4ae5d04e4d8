"""Whole transformer blocks as single kernels: self-attention over many
short sequences (K2) and cross-attention (K4).

Counterparts of ``comet_tpu/ops/pallas_block.py::fused_attn_block`` and
``fused_cross_block``. On a CUDA tensor every call launches the hand-written
kernel (``csrc/block.cu``, ``csrc/cross_block.cu``) or raises; on a CPU
tensor it runs :func:`block_reference` or :func:`cross_block_reference`, the
plain PyTorch versions with the kernels' rounding points: the wrappers call
the registered operators ``comet::attn_block`` and ``comet::cross_block``
(``ops/library.py``), whose dispatch key picks one. Weights are in the
port's [out, in] layout. The gradient is the plain version's, recomputed
from the saved inputs, as ``pallas_block.py::_fb_bwd`` and ``_cb_bwd``.
"""

from __future__ import annotations

import functools
from collections import Counter
from typing import Optional

import torch
import torch.nn.functional as F

from . import kernels
from .attn import attention_reference

# (C, num_heads) K2 and K4 are compiled for: the coarse (384, 8) and fine
# (256, 8) update-former widths.
SUPPORTED_WIDTHS = ((384, 8), (256, 8))
# K2's tiles, as compiled: 64 block rows per CTA (whole sequences) and MLP
# hidden chunks of 128 columns; a tile is shared by at most 8 CTAs (the
# portable cluster size)
K2_ROWS = 64
K2_CHUNK = 128
K2_MAX_SPLIT = 8
# K4's 64-row tiles
K4_ROWS = 64
# int64 counters a timed launch of K2 / K4 fills (``clocks=``)
K2_CLOCKS = 18
K4_CLOCKS = 30


def block_split(rows: int, hidden: int, sms: int) -> int:
    """K2's plan: how many CTAs, one cluster, share each 64-row tile of a
    call with ``rows`` block rows, each running the MLP's hidden chunks c
    with c % split == its rank. The largest split up to 8 that divides the
    chunks evenly and keeps every CTA of the launch resident at once (tiles
    * split <= sms); 1 when the tiles alone fill more than half the card."""
    tiles = -(-rows // K2_ROWS)
    chunks = hidden // K2_CHUNK
    return max(n for n in range(1, K2_MAX_SPLIT + 1)
               if chunks % n == 0 and (n == 1 or tiles * n <= sms))


def cross_split(rows: int, heads: int, resident) -> int:
    """K4's plan for its query side: how many CTAs, one cluster, share each
    64-row tile of a call with ``rows`` query rows, rank r computing the
    attention of the heads h with h % split == r and the MLP's hidden chunks
    c with c % split == r (a rank runs at most one chunk more than another).
    The largest split of 1, 2, 4 or 8 that divides the heads and whose
    clusters are all resident at once: ``resident(n)`` is how many clusters
    of n of the kernel's CTAs the card holds (``cudaOccupancyMaxActiveClusters``,
    about sms // n), so 1 where the tiles alone fill more than half the
    card."""
    tiles = -(-rows // K4_ROWS)
    return max(n for n in (1, 2, 4, 8) if heads % n == 0 and (n == 1 or tiles <= resident(n)))


def card_cross_split(rows: int, heads: int, c: int, index: int) -> int:
    """:func:`cross_split` on CUDA card ``index``, from the clusters of K4's
    query-side kernel at width ``c`` that it holds at once."""
    return cross_split(rows, heads, lambda n: _resident_clusters(index, c, n))


def cross_kv_groups(rows: int, sms: int) -> int:
    """K4's plan for its kv projection over ``rows`` context rows: into how
    many column groups (1, 2 or 4; each recomputes the context LayerNorm)
    the 2C columns of each 64-row tile are split, so that the CTAs reach as
    many SMs as there are, resident at once."""
    tiles = -(-rows // K4_ROWS)
    return max(n for n in (1, 2, 4) if n == 1 or tiles * n <= sms)


@functools.lru_cache(maxsize=None)
def _resident_clusters(index: int, c: int, split: int) -> int:
    """How many clusters of ``split`` CTAs of K4's query-side kernel card
    ``index`` holds at once."""
    with torch.cuda.device(index):
        n = kernels.library().comet_cross_block_clusters(c, split)
    if n < 0:
        raise RuntimeError("fused_cross_block: cudaOccupancyMaxActiveClusters failed")
    return n


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


def _check(who: str, name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.bfloat16:
        if t.dtype == torch.float32:
            raise NotImplementedError(f"{who} on CUDA takes bfloat16 only")
        raise ValueError(f"{who}: {name} has dtype {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{who}: {name} is on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{who}: {name} must be contiguous and 16-byte aligned")


def _check_all(who: str, device: torch.device, operands) -> None:
    for name, t, shape in operands:
        _check(who, name, t, shape)
        if t.device != device:
            raise ValueError(f"{who}: {name} is on {t.device}, x on {device}")


def _check_clocks(who: str, clocks: Optional[torch.Tensor], n: int, device) -> None:
    if clocks is not None and (clocks.dtype != torch.int64 or clocks.device != device
                               or clocks.numel() < n or not clocks.is_contiguous()):
        raise ValueError(f"{who}: clocks must be {n} contiguous int64 on x's device")


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
    *,
    clocks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One AttnBlock application: x1 = ln1(x) + attn(ln1(x));
    out = x1 + mlp(ln2(x1)). Returns [B, L, C] in x's dtype.

    ``clocks``, for measurement only: an int64 tensor of 18 on x's device
    that receives where the kernel's first CTA spends its cycles, from a
    separately compiled timed instance of the kernel (the layout is
    ``comet_attn_block_fwd``'s in ``csrc/block.cu``); the kernel is then
    launched directly (:func:`block_launch`, not differentiable)."""
    args = (x, wqkv, bqkv, wout, bout, w1, b1, w2, b2, num_heads)
    if clocks is not None:
        return block_launch(*args, clocks)
    return torch.ops.comet.attn_block.default(*args)


def block_launch(x, wqkv, bqkv, wout, bout, w1, b1, w2, b2, num_heads: int, clocks=None):
    """K2 on CUDA tensors (``comet::attn_block``'s CUDA implementation):
    check, plan, launch and count."""
    b, l, c = x.shape
    hidden = w1.shape[0]
    if (c, num_heads) not in SUPPORTED_WIDTHS:
        raise ValueError(f"fused_attn_block: (C, heads) = {(c, num_heads)} not compiled")
    if l < 1 or K2_ROWS % l or hidden % K2_CHUNK:
        raise ValueError(
            f"fused_attn_block: L {l} must divide {K2_ROWS}, hidden {hidden} % {K2_CHUNK} == 0"
        )
    _check_clocks("fused_attn_block", clocks, K2_CLOCKS, x.device)
    _check_all("fused_attn_block", x.device, (
        ("x", x, (b, l, c)), ("wqkv", wqkv, (3 * c, c)), ("bqkv", bqkv, (3 * c,)),
        ("wout", wout, (c, c)), ("bout", bout, (c,)), ("w1", w1, (hidden, c)),
        ("b1", b1, (hidden,)), ("w2", w2, (c, hidden)), ("b2", b2, (c,)),
    ))
    out = torch.empty_like(x)
    if b == 0:
        return out
    rc = kernels.library().comet_attn_block_fwd(
        x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wout.data_ptr(), bout.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        b * l, l, c, num_heads, hidden,
        block_split(b * l, hidden, kernels.sm_count(x.device.index)),
        None if clocks is None else clocks.data_ptr(),
        kernels.stream(x.device.index),
    )
    kernels.check_launch(rc, "fused_attn_block")
    fused_attn_block.launches += 1
    fused_attn_block.launch_shapes[(b, l, c, num_heads, hidden)] += 1
    return out


# launches of the kernel, in all and by (B, L, C, heads, hidden)
fused_attn_block.launches = 0
fused_attn_block.launch_shapes = Counter()


def cross_block_reference(
    x, ctx, gamma, beta, wq, bq, wkv, bkv, wout, bout, w1, b1, w2, b2, num_heads: int
) -> torch.Tensor:
    """CrossAttnBlock on [B, Lq, C] / [B, Lk, C] with K4's rounding points:
    the context LN is cast to x's dtype before its affine, which runs in
    that dtype (not the f32 affine of the unfused norm_context); each
    matmul is rounded before its bias add; the residual is re-based on
    ln1(x)."""
    c = x.shape[-1]
    dt = x.dtype
    xn = layer_norm_plain(x)
    cn = layer_norm_plain(ctx) * gamma + beta
    q = torch.matmul(xn, wq.t()).to(dt) + bq
    k, v = (torch.matmul(cn, wkv.t()).to(dt) + bkv).split(c, dim=-1)
    a = attention_reference(q, k, v, num_heads, 1.0 / (c // num_heads) ** 0.5)
    x1 = xn + (torch.matmul(a, wout.t()).to(dt) + bout)
    y = layer_norm_plain(x1)
    h = gelu(torch.matmul(y, w1.t()).to(dt) + b1)
    return x1 + (torch.matmul(h, w2.t()).to(dt) + b2)


def fused_cross_block(
    x: torch.Tensor,  # [B, Lq, C] query stream, Lq % 16 == 0
    ctx: torch.Tensor,  # [B, Lk, C] context (keys and values)
    gamma: torch.Tensor,  # [C] norm_context scale
    beta: torch.Tensor,  # [C] norm_context bias
    wq: torch.Tensor,  # [C, C] query projection (in_proj[:C])
    bq: torch.Tensor,  # [C]
    wkv: torch.Tensor,  # [2C, C] packed kv projection (in_proj[C:])
    bkv: torch.Tensor,  # [2C]
    wout: torch.Tensor,  # [C, C]
    bout: torch.Tensor,  # [C]
    w1: torch.Tensor,  # [hidden, C]
    b1: torch.Tensor,  # [hidden]
    w2: torch.Tensor,  # [C, hidden]
    b2: torch.Tensor,  # [C]
    num_heads: int,
    *,
    split: Optional[int] = None,
    clocks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One CrossAttnBlock application: x1 = ln1(x) + attn(ln1(x),
    norm_context(ctx)); out = x1 + mlp(ln2(x1)). Returns [B, Lq, C] in x's
    dtype. On CUDA it takes the shapes it was compiled for or raises; the
    caller's gate is the only gate.

    For measurement and tests only: ``split`` overrides :func:`cross_split`
    (1, 2, 4 or 8), and ``clocks``, an int64 tensor of 30 on x's device,
    receives where the kernel's first CTAs spend their cycles, from
    separately compiled timed instances (the layout is
    ``comet_cross_block_fwd``'s in ``csrc/cross_block.cu``). With either,
    the kernel is launched directly (:func:`cross_launch`, not
    differentiable)."""
    args = (x, ctx, gamma, beta, wq, bq, wkv, bkv, wout, bout, w1, b1, w2, b2, num_heads)
    if split is not None or clocks is not None:
        return cross_launch(*args, split, clocks)
    return torch.ops.comet.cross_block.default(*args)


def cross_launch(x, ctx, gamma, beta, wq, bq, wkv, bkv, wout, bout, w1, b1, w2, b2,
                 num_heads: int, split: Optional[int] = None, clocks=None):
    """K4 on CUDA tensors (``comet::cross_block``'s CUDA implementation):
    check, plan (or take ``split``), launch and count."""
    args = (x, ctx, gamma, beta, wq, bq, wkv, bkv, wout, bout, w1, b1, w2, b2)
    b, lq, c = x.shape
    lk = ctx.shape[1]
    hidden = w1.shape[0]
    if (c, num_heads) not in SUPPORTED_WIDTHS:
        raise ValueError(f"fused_cross_block: (C, heads) = {(c, num_heads)} not compiled")
    if lq % 16 or lk < 1 or hidden % K2_CHUNK:
        raise ValueError(
            f"fused_cross_block: Lq {lq} % 16 == 0, Lk {lk} >= 1, hidden {hidden} % 128 == 0"
        )
    if split is not None and split not in (1, 2, 4, 8):
        raise ValueError(f"fused_cross_block: split {split} is not 1, 2, 4 or 8")
    _check_clocks("fused_cross_block", clocks, K4_CLOCKS, x.device)
    _check_all("fused_cross_block", x.device, (
        ("x", x, (b, lq, c)), ("ctx", ctx, (b, lk, c)), ("gamma", gamma, (c,)),
        ("beta", beta, (c,)), ("wq", wq, (c, c)), ("bq", bq, (c,)), ("wkv", wkv, (2 * c, c)),
        ("bkv", bkv, (2 * c,)), ("wout", wout, (c, c)), ("bout", bout, (c,)),
        ("w1", w1, (hidden, c)), ("b1", b1, (hidden,)), ("w2", w2, (c, hidden)),
        ("b2", b2, (c,)),
    ))
    out = torch.empty_like(x)
    if b == 0:
        return out
    kv = torch.empty((b * lk, 2 * c), dtype=x.dtype, device=x.device)  # K and V, bf16
    index = x.device.index
    if split is None:
        split = card_cross_split(b * lq, num_heads, c, index)
    rc = kernels.library().comet_cross_block_fwd(
        *(t.data_ptr() for t in args), kv.data_ptr(), out.data_ptr(),
        b, lq, lk, c, num_heads, hidden, split, cross_kv_groups(b * lk, kernels.sm_count(index)),
        None if clocks is None else clocks.data_ptr(),
        kernels.stream(x.device.index),
    )
    kernels.check_launch(rc, "fused_cross_block")
    fused_cross_block.launches += 1
    fused_cross_block.launch_shapes[(b, lq, lk, c, num_heads, hidden)] += 1
    return out


# launches of the kernel (its two launches count once), in all and by
# (B, Lq, Lk, C, heads, hidden)
fused_cross_block.launches = 0
fused_cross_block.launch_shapes = Counter()
