"""The yardstick of the kernels: peaks of the card, and each kernel's least
work from its shapes.

Copied from the port's on-card smoke script (its ``_bound_ms`` and the
per-kernel counts beside each check), so that the benchmark keeps its own:
operations and bytes are what a call's shapes need, every input read once
and every output written once, bf16 tensors (2 bytes) on the tensor cores;
LayerNorm's arithmetic is float32 off them. A call's least time is the
larger of operations over the peak rate and bytes over the memory
bandwidth.

The operators are the port's registered ``comet::`` operators; the counts
read only their argument shapes, so they count the same work whatever
implements the operator.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

# one H100 SXM (NVIDIA data sheet, dense): bf16 on the tensor cores, f32
# off them, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BF16 = 2


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> Tuple[float, str]:
    """(least seconds, "operations" or "bytes"): what bounds the call."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention(b: int, lq: int, lk: int, c: int) -> Tuple[int, int]:
    """K1 (``comet::attention``) and K3 (``comet::short_attention``, lq = lk):
    two products of 2 * lq * lk * c each; q, k, v read once, out written once."""
    return 4 * b * lq * lk * c, BF16 * (2 * b * lq * c + 2 * b * lk * c)


def attn_block(b: int, l: int, c: int, hid: int) -> Tuple[int, int]:
    """K2 (``comet::attn_block``): qkv, out-projection and MLP products per
    row, and the attention; x in, y out and the block's weights once."""
    rows = b * l
    flops = rows * 2 * c * (3 * c + c + 2 * hid) + 4 * rows * l * c
    nbytes = BF16 * (2 * rows * c + 4 * c * c + 2 * c * hid + 4 * c + hid + c)
    return flops, nbytes


def cross_block(b: int, lq: int, lk: int, c: int, hid: int) -> Tuple[int, int]:
    """K4 (``comet::cross_block``): q, out-projection and MLP products per
    query row, k and v per context row, and the attention."""
    rq, rk = b * lq, b * lk
    flops = 2 * c * (rq * (2 * c + 2 * hid) + rk * 2 * c) + 4 * rq * lk * c
    nbytes = BF16 * (2 * rq * c + rk * c + 4 * c * c + 2 * c * hid)
    return flops, nbytes


def layer_norm(rows: int, c: int, affine: bool) -> Tuple[int, int]:
    """K5 (``comet::layer_norm``): sum, center, square, sum, scale, affine in
    f32; x in and y out in bf16, f32 scale and bias."""
    return 8 * rows * c, BF16 * 2 * rows * c + (8 * c if affine else 0)


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def operator_work(name: str, shapes: Sequence[Sequence[int]]) -> Optional[Tuple[int, int, float]]:
    """(flops, bytes, peak rate) of one call of operator ``name`` (with or
    without its ``comet::`` prefix) from its arguments' shapes, as the
    profiler records them; None for a name that is no kernel operator."""
    name = name.split("::")[-1]
    if name in ("attention", "short_attention"):
        (b, lq, c), (_, lk, _) = shapes[0], shapes[1]
        return (*attention(b, lq, lk, c), PEAK_BF16_FLOPS)
    if name == "attn_block":
        (b, l, c), hid = shapes[0], shapes[5][0]
        return (*attn_block(b, l, c, hid), PEAK_BF16_FLOPS)
    if name == "cross_block":
        (b, lq, c), (_, lk, _), hid = shapes[0], shapes[1], shapes[10][0]
        return (*cross_block(b, lq, lk, c, hid), PEAK_BF16_FLOPS)
    if name == "layer_norm":
        x = shapes[0]
        affine = len(shapes) > 1 and len(shapes[1]) > 0
        return (*layer_norm(_numel(x[:-1]), x[-1], affine), PEAK_F32_FLOPS)
    return None


def operator_backward_work(name: str, shapes: Sequence[Sequence[int]]
                           ) -> Optional[Tuple[int, int, float]]:
    """(flops, bytes, peak rate) that the backward of an attention operator
    needs from its inputs' shapes: the logits recomputed, then dP, dV, dQ,
    dK, five products of 2 * lq * lk * c (FlashAttention's count); q, k, v
    and the output's gradient read once, dq, dk, dv written once. None for
    the other operators."""
    name = name.split("::")[-1]
    if name not in ("attention", "short_attention"):
        return None
    (b, lq, c), (_, lk, _) = shapes[0], shapes[1]
    return (10 * b * lq * lk * c, BF16 * (2 * b * lq * c + 2 * b * lk * c)
            + BF16 * (b * lq * c + 2 * b * lk * c), PEAK_BF16_FLOPS)


KERNEL_OPERATORS = ("comet::attention", "comet::short_attention", "comet::attn_block",
                    "comet::cross_block", "comet::layer_norm")
