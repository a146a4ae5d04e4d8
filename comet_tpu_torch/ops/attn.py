"""Multi-head attention on the [B, L, H*D] projection layout (K1 and K3).

Counterpart of ``comet_tpu/ops/pallas_attn.py::fused_attention`` and its two
regimes. On a CUDA tensor :func:`fused_attention` sends many short
sequences (Lq <= 64, Lk <= 64 and B*Lq >= 256, the JAX packed regime) to
K3, :func:`short_attention` (``csrc/short_attn.cu``), and every other call
to K1 (``csrc/attn.cu``), including the shapes the JAX package sends to its
reference. On a CPU tensor both run :func:`attention_reference`, the plain
PyTorch version of the same function. Both call the registered operators
``comet::attention`` and ``comet::short_attention`` (``ops/library.py``),
whose dispatch key picks the kernel or the plain version, and which are
differentiable: the gradient is the plain version's, recomputed from the
saved inputs, as the JAX package's ``custom_vjp`` does.

``fused_attention(..., softmax=form)`` computes one of the two inexact A/B
softmax forms of ``tools/micro_softmax_variants.py`` (``nomax``: the
exponent of the logits with no row maximum; ``bf16e``: the maximum taken in
f32, the exponent in bf16) through instances of K1 at head dimensions 64
and 96; :func:`attention_form_reference` is their plain version.
"""

from __future__ import annotations

import functools
from collections import Counter
from typing import Callable, NamedTuple, Optional

import torch

from . import kernels

SUPPORTED_HEAD_DIMS = (32, 48, 64, 96)
# the softmax forms of fused_attention: K1's own, then the A/B forms (their
# number in csrc/attn.cu) and the head dimensions they are built for
SOFTMAX_FORMS = ("base", "nomax", "bf16e")
FORM_HEAD_DIMS = (64, 96)
# K3 takes sequences up to this long when there are at least this many rows
SHORT_MAX_LEN = 64
SHORT_MIN_ROWS = 256
# K3 as compiled: at most 16 warps (one per head and 16 query rows) and a
# ring of at most 3 stages per CTA
SHORT_MAX_WARPS = 16
SHORT_MAX_STAGES = 3


def short_max_warps(d: int, lk: int) -> int:
    """The most warps a K3 CTA at head dimension ``d`` and ``lk`` keys has:
    8 where its instance needs more than the 128 registers a thread of a
    512-thread CTA may have (D 96, and D 64 with more than 48 keys)."""
    return SHORT_MAX_WARPS // 2 if d == 96 or (d == 64 and lk > 48) else SHORT_MAX_WARPS


class ShortPlan(NamedTuple):
    heads: int  # heads of one sequence per unit of work (a warp per head and 16 query rows)
    warps: int  # per CTA
    stages: int  # units in the ring
    # CTAs; unit u (sequence u // (H / heads), head group u % (H / heads)) goes to CTA u % grid
    grid: int


def short_smem(lq: int, lk: int, cols: int, stages: int) -> int:
    """K3's dynamic shared memory for units of ``cols`` columns: 1024 bytes
    to align the tiles, the ring of q, k, v tiles (rows padded to 16, columns
    read as whole boxes of 64), the output tile and the barriers
    (``short_smem`` in ``csrc/short_attn.cu``)."""
    lqp, lkp, read = -(-lq // 16) * 16, -(-lk // 16) * 16, -(-cols // 64) * 64
    return 1024 + stages * (lqp + 2 * lkp) * read * 2 + lqp * cols * 2 + 8 * SHORT_MAX_STAGES


def short_plan(b: int, lq: int, lk: int, c: int, heads: int, sms: int,
               resident: Callable[[int, int], int]) -> ShortPlan:
    """K3's launch for B sequences of Lq queries and Lk keys at width C.

    A unit of work is some heads of one sequence: the most heads (dividing
    H, one warp per head and 16 query rows, at most :func:`short_max_warps`)
    whose units
    still number at least one per SM, so at L <= 16 a whole sequence per
    unit; where no count does, one head per unit (the most units). The grid
    is persistent: ``resident(threads, smem)`` is how many CTAs of that size
    an SM holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).
    Where the card holds every unit at once with one stage, each CTA takes
    one unit; else the ring has 3 stages where the card holds as many CTAs
    with 3 as with 2, else 2, and the grid is as many CTAs as it holds. A
    head count whose units do not fit the shared memory is passed over."""
    d = c // heads
    slices = -(-lq // 16)
    counts = [n for n in range(1, heads + 1)
              if heads % n == 0 and n * slices <= short_max_warps(d, lk)]
    filling = sorted((n for n in counts if b * heads // n >= sms), reverse=True)
    for n in filling + [n for n in counts if n not in filling]:
        warps, cols, units = n * slices, n * d, b * heads // n
        fits = {s: resident(32 * warps, short_smem(lq, lk, cols, s))
                for s in range(1, SHORT_MAX_STAGES + 1)}
        if fits[1] < 1:
            continue
        if units <= sms * fits[1]:
            stages, grid = 1, units
        else:
            stages = 3 if fits[3] >= 1 and fits[3] == fits[2] else (2 if fits[2] >= 1 else 1)
            grid = sms * fits[stages]
        return ShortPlan(n, warps, stages, grid)
    raise ValueError(f"short_attention: no plan fits Lq {lq}, Lk {lk}, C {c}, {heads} heads")


@functools.lru_cache(maxsize=None)
def _short_resident(index: int, d: int, lk: int, threads: int, smem: int) -> int:
    with torch.cuda.device(index):
        return kernels.library().comet_short_attn_resident(d, lk, threads, smem)


@functools.lru_cache(maxsize=4096)
def _card_short_plan(index: int, b: int, lq: int, lk: int, c: int, heads: int) -> ShortPlan:
    return short_plan(b, lq, lk, c, heads, kernels.sm_count(index),
                      lambda threads, smem: _short_resident(index, c // heads, lk, threads, smem))


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


def attention_form_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float,
    softmax: str,
) -> torch.Tensor:
    """Plain version of a softmax form, step by step as the TPU tool's
    whole-row form (``_heads_attend_variant``): f32 logits (scale on the
    logits); ``nomax``: w = exp(logits) / its row sum, in f32; ``bf16e``: x =
    logits - row max rounded to bf16, e = exp(x), its row sum and e / sum in
    bf16; ``base``: :func:`attention_reference`. The weights are cast to the
    input dtype before the value product, as there."""
    if softmax == "base":
        return attention_reference(q, k, v, num_heads, scale)
    if softmax not in SOFTMAX_FORMS:
        raise ValueError(f"attention: softmax form {softmax!r} not in {SOFTMAX_FORMS}")
    b, lq, c = q.shape
    lk = k.shape[1]
    d = c // num_heads
    qh = q.reshape(b, lq, num_heads, d)
    kh = k.reshape(b, lk, num_heads, d)
    vh = v.reshape(b, lk, num_heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * scale
    if softmax == "nomax":
        e = torch.exp(logits)
    else:
        e = torch.exp((logits - logits.amax(dim=-1, keepdim=True)).to(torch.bfloat16))
    w = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, vh)
    return out.reshape(b, lq, c)


def kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """t as the kernels take it: t itself, or a contiguous copy when a
    dimension longer than 1 has stride 0 (an ``expand``), since the kernels
    step over every such dimension in memory."""
    strides = t.stride()
    if 0 in strides and any(n > 1 and s == 0 for n, s in zip(t.shape, strides)):
        return t.contiguous()
    return t


def _check_operand(name: str, t: torch.Tensor, length: int, c: int) -> tuple:
    """Check one operand; return its batch and row strides in elements (0
    for a size-1 dimension, which is never stepped over, whatever stride it
    reports)."""
    if t.dtype != torch.bfloat16:
        if t.dtype == torch.float32:
            raise NotImplementedError("attention on CUDA takes bfloat16 only")
        raise ValueError(f"attention: {name} has dtype {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"attention: {name} is on {t.device}")
    shape = t.shape
    if len(shape) != 3 or shape[1] != length or shape[2] != c:
        raise ValueError(f"attention: {name} has shape {tuple(shape)}")
    bs, rs, cs = t.stride()
    bs, rs = (0 if shape[0] == 1 else bs), (0 if length == 1 else rs)
    if cs != 1 or rs % 8 or bs % 8 or t.data_ptr() % 16:
        raise ValueError(
            f"attention: {name} needs unit column stride and 16-byte aligned rows"
        )
    return bs, rs


def _launch(entry: str, q, k, v, num_heads: int, scale: float, plan=None,
            form: Optional[int] = None) -> torch.Tensor:
    """Check the operands and launch the kernel behind the C entry point
    ``entry`` (no launch for an empty output). ``plan``, for K3: a function
    of (card, B, Lq, Lk, C, heads) giving its :class:`ShortPlan`; ``form``,
    for K1's A/B forms: the softmax form's number."""
    b, lq, c = q.shape
    lk = k.shape[1]
    if c % num_heads or c // num_heads not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"attention: head dim {c / num_heads} not in {SUPPORTED_HEAD_DIMS}")
    q, k, v = kernel_operand(q), kernel_operand(k), kernel_operand(v)
    q_strides = _check_operand("q", q, lq, c)
    k_strides = _check_operand("k", k, lk, c)
    v_strides = _check_operand("v", v, lk, c)
    device = q.device
    if k.shape[0] != b or v.shape[0] != b or k.device != device or v.device != device:
        raise ValueError("attention: q, k, v disagree in batch or device")
    out = torch.empty((b, lq, c), dtype=q.dtype, device=device)
    if b == 0 or lq == 0:
        return out
    if lk == 0:
        raise ValueError("attention: no keys")
    index = device.index
    if plan is not None:
        p = plan(index, b, lq, lk, c, num_heads)
        extra = (p.heads, p.stages, p.grid)
    else:
        extra = () if form is None else (form,)
    rc = getattr(kernels.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, num_heads, c // num_heads, lq, lk, *q_strides, *k_strides, *v_strides,
        float(scale), *extra, kernels.stream(index),
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
    *,
    plan: Optional[ShortPlan] = None,
) -> torch.Tensor:
    """K3: :func:`fused_attention` for Lq, Lk <= 64, each (sequence, head)
    computed directly by one warp per 16 query rows. Same arguments and
    result, differentiable through the plain version. ``plan``, for tests
    and measurement on the card: launch K3 directly (:func:`short_launch`,
    not differentiable) with this plan instead of :func:`short_plan`'s."""
    c = q.shape[2]
    if scale is None:
        scale = 1.0 / (c // num_heads) ** 0.5
    if plan is not None:
        return short_launch(q, k, v, num_heads, scale, plan)
    return torch.ops.comet.short_attention.default(q, k, v, num_heads, float(scale))


def short_launch(q, k, v, num_heads: int, scale: float, plan: Optional[ShortPlan] = None):
    """K3 on CUDA tensors (``comet::short_attention``'s CUDA implementation):
    check, plan (or take ``plan``), launch and count."""
    b, lq, c = q.shape
    lk = k.shape[1]
    if lq > SHORT_MAX_LEN or lk > SHORT_MAX_LEN:
        raise ValueError(f"short_attention: Lq {lq} and Lk {lk} must be <= {SHORT_MAX_LEN}")
    out = _launch("comet_short_attn_fwd", q, k, v, num_heads, scale,
                  _card_short_plan if plan is None else (lambda *_: plan))
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
    softmax: str = "base",
) -> torch.Tensor:
    """softmax(scale * Q_h K_h^T) V_h per head, on [B, Lq, C] / [B, Lk, C].

    Returns [B, Lq, C] (before the output projection) in the input dtype.
    q, k and v may be column slices of one packed projection: only unit
    column stride is required, rows and batches may be strided. On CUDA,
    the packed regime (:func:`is_short`) goes to K3 and the rest to K1;
    ``fused_attention.launches`` counts K1's launches. ``softmax``: K1's
    form ("base") or one of the inexact A/B forms "nomax" and "bf16e"
    (:func:`attention_form_reference`), which run on K1's instances for
    them at every shape, at head dimensions 64 and 96;
    ``fused_attention.form_launches`` counts those by (form, B, Lq, Lk, C,
    heads). The gradient is the plain version's (of the form), recomputed
    from the saved inputs, as the JAX package's ``_fa_bwd``.
    """
    b, lq, c = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = 1.0 / (c // num_heads) ** 0.5
    if softmax not in SOFTMAX_FORMS:
        raise ValueError(f"attention: softmax form {softmax!r} not in {SOFTMAX_FORMS}")
    if softmax == "base" and is_short(b, lq, lk):
        return short_attention(q, k, v, num_heads, scale)
    return torch.ops.comet.attention.default(q, k, v, num_heads, float(scale), softmax)


def k1_launch(q, k, v, num_heads: int, scale: float, softmax: str):
    """K1 or one of its softmax forms on CUDA tensors (``comet::attention``'s
    CUDA implementation): check, launch and count."""
    b, lq, c = q.shape
    lk = k.shape[1]
    if softmax != "base":
        if c % num_heads or c // num_heads not in FORM_HEAD_DIMS:
            raise ValueError(f"attention: softmax form {softmax!r} is built for head dims "
                             f"{FORM_HEAD_DIMS}, not {c / num_heads}")
        out = _launch("comet_attn_form_fwd", q, k, v, num_heads, scale,
                      form=SOFTMAX_FORMS.index(softmax))
        if out.numel():
            fused_attention.form_launches[(softmax, b, lq, lk, c, num_heads)] += 1
        return out
    out = _launch("comet_attn_fwd", q, k, v, num_heads, scale)
    if out.numel():
        fused_attention.launches += 1
        fused_attention.launch_shapes[(b, lq, lk, c, num_heads)] += 1
    return out


# launches of each kernel, in all and by (B, Lq, Lk, C, heads): K1, K3;
# and of K1's A/B softmax forms by (form, B, Lq, Lk, C, heads)
fused_attention.launches = 0
fused_attention.launch_shapes = Counter()
fused_attention.form_launches = Counter()
short_attention.launches = 0
short_attention.launch_shapes = Counter()
