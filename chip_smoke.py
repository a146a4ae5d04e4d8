"""GPU smoke check of the PyTorch/CUDA port (``comet_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py                         # the check, a few minutes
    python3 chip_smoke.py --profile profile.txt   # + torch.profiler tables

Phases, each of which makes the script exit nonzero when it fails:

1. the card: its name, and its name and power limit from ``nvidia-smi``;
2. the build of the hand-written kernels (K1 ``csrc/attn.cu``, K2
   ``csrc/block.cu``, K3 ``csrc/short_attn.cu``, K4 ``csrc/cross_block.cu``,
   K5 ``csrc/norm.cu``) with ``nvcc`` for sm_90a, timed, with ptxas's
   registers and spills of every kernel instance;
3. every kernel at every shape either route gives it, in bf16: the kernel
   against its plain PyTorch version run in f32 on the same bf16 inputs,
   with the kernel's, the plain version's (bf16, on the card) and, where one
   PyTorch call computes the same function (``F.scaled_dot_product_attention``
   for K1 and K3, ``F.layer_norm`` for K5), that call's median device times
   over 25 runs, and the host time to issue one call of the kernel's wrapper
   (and of the library call); for K3 and K5 two yardsticks beside the
   bound, the launch floor (an empty launch between the same two events)
   and a copy of the bytes the bound counts; K3 also at every ring depth of
   its plan (1 to 3 stages); for K2 and K4 where their first CTAs
   spend their cycles (``clocks=``, from separately compiled timed
   instances; K4's timed output must equal the forward's bit for bit); K4
   at both of its shapes also at every split of its query tiles (1, 2, 4,
   8), each timed, with its cycles also at split 8 where the plan splits;
   then, for correctness only, every kernel at edge shapes of its
   tilings (Lq and Lk of 1, 63, 65, 129 and 577, packed qkv slices at D 48
   and 96, keys and values expanded over the batch; block rows not a
   multiple of 64, L 16 and 64 at both widths, cluster splits of 2 to 8;
   K4 at Lq 16, 32, 64 and 512 against Lk 1, 63, 65, 512 and 1024 at both
   widths and splits 2, 4 and 8; K3 at L 1 to 64, Lq != Lk, D 32 to 96,
   packed, separate and expanded operands; K5 at 1 to 9,296 rows of 8 to
   1,024 columns in bf16 and f32, affine or not) against the same plain f32
   versions and tolerances (a K4 shape in ``K4_KNOWN_MISS`` that misses is
   printed as such, and held to the plain version in bf16 instead);
4. a reference check on small inputs: the full-width ``ours`` model's coarse
   and fine update-formers and its camera predictor, on the card in bf16
   (through the kernels) against the same weights in f32 on the CPU (plain
   versions), on the default route and on ``FUSED_ROUTE``;
5. the main path, once per route: ``build_comet(get_config("ours"))`` on the
   card at full width (16 frames, 512 px, 512 tracks, bf16, random weights
   from seed 0) answers 3 seeded requests through ``COMET.forward`` and
   ``decode_predictions`` on the default route (K1 and K2), then the same
   model, switched with ``COMET.set_route(FUSED_ROUTE)``, answers 3 more
   (K1, K3, K4 and K5); the kernels' launch counts are set to 0 just before
   each route's requests and read just after, and must rise by that route's
   per-forward counts at the expected shapes.

The line before the last holds the kernels' JSON record, and the last line
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script prints no result and exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# peaks of one H100 SXM (data sheet, dense): bf16 tensor cores, f32 outside
# them, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# K1 at the main path's shapes: (where, B, Lq, Lk, C, heads, packed qkv,
# calls per forward on the default route, on FUSED_ROUTE)
K1_SHAPES = [
    ("vit self", 16, 581, 581, 768, 12, True, 12, 12),
    ("aggregator self", 16, 577, 577, 768, 8, True, 4, 4),
    ("aggregator cross to frame 0", 1, 8655, 577, 768, 8, False, 4, 4),
    ("update-former virtual<-point", 16, 64, 512, 384, 8, False, 24, 0),
    ("trajectory cross", 16, 1, 512, 768, 8, False, 4, 4),
    ("trunk self", 1, 16, 16, 768, 8, True, 4, 4),
    ("update-former point<-virtual", 16, 512, 64, 384, 8, False, 24, 0),
]
# K2 (default route): (where, B, L, C, heads, hidden, calls per forward)
K2_SHAPES = [
    ("coarse time blocks", 576, 16, 384, 8, 1536, 24),
    ("coarse virtual blocks", 16, 64, 384, 8, 1536, 24),
    ("fine time blocks", 512, 16, 256, 8, 1024, 24),
]
# K3 (FUSED_ROUTE: the AttnBlocks above, unfused): (where, B, L, C, heads,
# calls per forward); q, k, v are column slices of the qkv projection
K3_SHAPES = [
    ("coarse time blocks", 576, 16, 384, 8, 24),
    ("coarse virtual blocks", 16, 64, 384, 8, 24),
    ("fine time blocks", 512, 16, 256, 8, 24),
]
# K4 (FUSED_ROUTE: the coarse update-former's space cross blocks; the
# camera's cross blocks miss the gate): (where, B, Lq, Lk, C, heads, hidden,
# calls per forward)
K4_SHAPES = [
    ("virtual<-point", 16, 64, 512, 384, 8, 1536, 24),
    ("point<-virtual", 16, 512, 64, 384, 8, 1536, 24),
]
# K5 (FUSED_ROUTE: every LayerNorm the forward reaches, bf16 throughout):
# (where, rows, C, affine, calls per forward). Per forward: ViT 2 x 12 + 1;
# camera input norm 1; aggregator 4 self blocks x 2 and 4 cross blocks x
# (2 + norm_context); trajectory encoder 2; T_P 4 cross blocks x (2 +
# norm_context); trunk 4 x 2; coarse 4 iterations x 6 x (time + virtual
# block) x 2; fine 6 iterations x 4 time blocks x 2. The coarse space
# cross blocks are inside K4.
K5_SHAPES = [
    ("ViT norm1, norm2, final norm", 16 * 581, 768, True, 25),
    ("camera input norm", 16 * 576, 768, False, 1),
    ("aggregator self blocks", 16 * 577, 768, False, 8),
    ("aggregator cross norm1, norm2", 15 * 577, 768, False, 8),
    ("aggregator cross norm_context", 577, 768, True, 4),
    ("trajectory encoder ln1", 16 * 512, 256, True, 1),
    ("trajectory encoder ln2, T_P norm_context", 16 * 512, 768, True, 5),
    ("T_P cross norm1, norm2, trunk", 16, 768, False, 16),
    ("coarse time blocks", 576 * 16, 384, False, 48),
    ("coarse virtual blocks", 16 * 64, 384, False, 48),
    ("fine time blocks", 512 * 16, 256, False, 48),
]
# correctness-only edge shapes of K1's and K2's tilings: K1 (B, Lq, Lk, C,
# heads, layout), the layout "packed" meaning q, k, v are slices of one
# [B, L, 3C] projection (Lq == Lk) or k, v of one [B, Lk, 2C], "expanded"
# that k and v are one [1, Lk, C] each, expanded over the batch; K2 (B, L, C)
K1_EDGE = ([(2, n, 577, 768, 8, "plain") for n in (1, 63, 65, 129, 577)]
           + [(2, 577, n, 768, 8, "packed") for n in (1, 63, 65, 129)]
           + [(3, 129, 129, 384, 8, "packed"), (2, 65, 65, 768, 8, "packed"),
              (4, 63, 63, 384, 8, "packed"), (4, 100, 577, 768, 8, "expanded")])
K2_EDGE = [(7, 16, 256), (20, 64, 384), (5, 16, 384), (3, 64, 256), (1, 1, 384), (9, 32, 256),
           (30, 64, 384), (40, 64, 384), (50, 64, 256)]
# K4 (B, Lq, Lk, C): Lq 16, 32, 64 and 512 (B * Lq not a multiple of 64 below
# Lq 64) against Lk 1, 63, 65, 512 and 1024, at both widths; each at the
# plan's split and at splits 2, 4 and 8
K4_EDGE = [({16: 17, 32: 9, 64: 5, 512: 1}[lq], lq, lk, c)
           for c in (384, 256) for lq in (16, 32, 64, 512) for lk in (1, 63, 65, 512, 1024)]
K4_SPLITS = (1, 2, 4, 8)
# K3 (B, Lq, Lk, C, heads, layout): L 1, 15, 17, 33, 63 and 64 and Lq != Lk
# around its 16-row slices, D 32, 48, 64 and 96, 12 heads, batches that are
# not a multiple of a CTA's units; "packed": q, k, v slices of one [B, L,
# 3C] projection (k, v of one [B, Lk, 2C] where Lq != Lk), "separate": three
# tensors, "expanded": k and v one [1, Lk, C] each, expanded over the batch
K3_EDGE = [(300, 1, 1, 256, 8, "packed"), (20, 15, 15, 384, 8, "packed"),
           (17, 17, 17, 512, 8, "separate"), (9, 33, 33, 768, 8, "packed"),
           (5, 63, 63, 384, 8, "separate"), (5, 64, 64, 256, 8, "expanded"),
           (20, 16, 64, 384, 8, "separate"), (8, 64, 17, 256, 8, "packed"),
           (19, 16, 16, 384, 8, "packed"), (20, 16, 16, 768, 12, "packed"),
           (33, 16, 1, 768, 8, "expanded"), (7, 40, 40, 512, 8, "packed")]
# K5 (rows, C, dtype, affine): rows around a CTA's step and the card's
# resident CTAs, widths that leave lanes idle, both dtypes, affine or not
K5_EDGE = [(r, c, dt, affine) for r in (1, 7, 9, 1055, 1057, 9296)
           for c in (8, 264, 392, 1000, 1024) for dt in ("bfloat16", "float32")
           for affine in (False, True)]
# K5 in f32 against the plain version in f32 (the tests' tolerance)
K5_F32_TOL = 1e-5
# K4 edge shapes that miss atol 3e-2 + 2^-6 |y| against the plain f32
# version, and where the plain version in bf16 (K4's rounding points) misses
# it by the same amount on the same inputs: with Lk 1 every row of a
# sequence shares one attention output, so one bf16 rounding of each of its
# columns reaches all Lq rows. The miss is printed, and K4 is held there to
# the plain bf16 version at the same tolerance; a shape whose plain bf16
# version meets the tolerance fails the check until it leaves this list.
K4_KNOWN_MISS = {(1, 512, 1, 384)}
PER_FORWARD = {
    "default": dict(K1=sum(s[-2] for s in K1_SHAPES), K2=sum(s[-1] for s in K2_SHAPES),
                    K3=0, K4=0, K5=0),  # K1 76, K2 72
    "fused": dict(K1=sum(s[-1] for s in K1_SHAPES), K2=0, K3=sum(s[-1] for s in K3_SHAPES),
                  K4=sum(s[-1] for s in K4_SHAPES), K5=sum(s[-1] for s in K5_SHAPES)),
    # K1 28, K3 72, K4 48, K5 212
}
K1_ATOL = 3e-2
# K2's and K4's output and residual stream are each rounded to bf16 at their
# own magnitude (|y| reaches ~8, where one bf16 step is 0.0625): atol plus
# two bf16 steps relative to the value.
K2_ATOL, K2_RTOL = 3e-2, 2.0 ** -6
# K5: one bf16 rounding of the output (half a step, 2^-8 |y|, with room)
K5_ATOL, K5_RTOL = 1e-3, 2.0 ** -7
# bf16 on the card against f32 on the CPU, relative to the output's range:
# a stack of 12 bf16 blocks drifts by ~1 % of it (0.9 % for PyTorch's own
# bf16 of the same stack on the CPU), a wrong kernel by its whole size.
REF_RTOL = 3e-2
TIMING_RUNS = 25
# ~25 ms of the card's clock: longer than the host takes to queue TIMING_RUNS calls
SLEEP_CYCLES = 50_000_000
REQUESTS = 3
KERNELS = ("K1", "K2", "K3", "K4", "K5")


class SmokeError(RuntimeError):
    pass


def _nvidia_smi() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() else "not available"
    except (OSError, subprocess.TimeoutExpired):
        return "not available"


def _median_ms(torch, fn, runs=TIMING_RUNS):
    """Median device time of one call of fn, in ms, with a warm L2. The runs
    are queued behind a sleep kernel, so the events around each run time
    the card and not the host's launch path (which is longer than the
    smaller kernels themselves)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    events = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _host_us(torch, fn, runs=TIMING_RUNS):
    """Host time to issue one call of fn, in us: the card is kept busy by a
    sleep kernel, so no call waits for it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    host = (time.perf_counter() - t0) / runs * 1e6
    torch.cuda.synchronize()
    return host


def _floor_ms(torch):
    """The launch floor on this clock: the median device time of an empty
    launch (a sleep kernel of one cycle) between the same two events."""
    return _median_ms(torch, lambda: torch.cuda._sleep(1))


def _copy_ms(torch, nbytes, dev):
    """A practical bandwidth yardstick: the median device time of
    ``dst.copy_(src)`` on bf16 tensors of nbytes / 2 bytes each, so the copy
    reads and writes as many bytes as a kernel whose bound counts nbytes."""
    src = torch.ones(max(nbytes // 4, 1), dtype=torch.bfloat16, device=dev)
    dst = torch.empty_like(src)
    return _median_ms(torch, lambda: dst.copy_(src))


def _bound_ms(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_k1(torch, F, attn, dev, gen):
    rows = []
    for where, b, lq, lk, c, h, packed, calls, calls_fused in K1_SHAPES:
        d = c // h
        if packed:  # q, k, v are column slices of one qkv projection, as in the model
            qkv = torch.randn(b, lq, 3 * c, generator=gen, device=dev).bfloat16()
            q, k, v = qkv.split(c, dim=-1)
        else:  # q alone, k and v column slices of one kv projection
            q = torch.randn(b, lq, c, generator=gen, device=dev).bfloat16()
            k, v = torch.randn(b, lk, 2 * c, generator=gen, device=dev).bfloat16().split(c, dim=-1)
        out = attn.fused_attention(q, k, v, h)
        torch.cuda.synchronize()
        want = attn.attention_reference(q.float(), k.float(), v.float(), h, d ** -0.5)
        err = (out.float() - want).abs().max().item()
        if out.shape != (b, lq, c) or not math.isfinite(err) or err > K1_ATOL:
            raise SmokeError(f"K1 {where}: max |kernel - plain f32| = {err} > {K1_ATOL}")
        ms = _median_ms(torch, lambda: attn.fused_attention(q, k, v, h))
        host_us = _host_us(torch, lambda: attn.fused_attention(q, k, v, h))
        plain_ms = _median_ms(torch, lambda: attn.attention_reference(q, k, v, h, d ** -0.5))
        q4, k4, v4 = (t.view(b, t.shape[1], h, d).transpose(1, 2) for t in (q, k, v))
        library_ms = _median_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4))
        library_host_us = _host_us(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4))
        flops = 4 * b * h * lq * lk * d
        nbytes = 2 * (2 * b * lq * c + 2 * b * lk * c)  # q, k, v read once, out written once
        bound, bound_by = _bound_ms(flops, nbytes)
        rows.append(dict(kernel="K1", where=where, shape=[b, lq, lk, c, h],
                         max_abs_err=err, tolerance=f"atol {K1_ATOL}", ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, host_us=host_us,
                         library_host_us=library_host_us, bound_ms=bound, bound_by=bound_by,
                         flops=flops, bytes=nbytes))
        print(f"K1 {where:32s} [B={b} Lq={lq} Lk={lk} C={c} H={h}] err {err:.3e} (atol {K1_ATOL}) "
              f"ms {ms:.4f} plain {plain_ms:.4f} sdpa {library_ms:.4f} bound {bound:.5f} ({bound_by}) "
              f"host us {host_us:.1f} (sdpa {library_host_us:.1f})",
              flush=True)
    return rows


def check_k2(torch, block, dev, gen):
    rows = []
    for where, b, l, c, h, hid, calls in K2_SHAPES:
        x, w = _k2_inputs(torch, gen, dev, b, l, c, hid)
        out = block.fused_attn_block(x, *w, h)
        torch.cuda.synchronize()
        want = block.block_reference(x.float(), *(t.float() for t in w), h)
        excess = ((out.float() - want).abs() - K2_RTOL * want.abs()).max().item()
        err = (out.float() - want).abs().max().item()
        plain_err = (block.block_reference(x, *w, h).float() - want).abs().max().item()
        if out.shape != x.shape or not math.isfinite(err) or excess > K2_ATOL:
            raise SmokeError(
                f"K2 {where}: |kernel - plain f32| exceeds {K2_ATOL} + {K2_RTOL}|y| by {excess}"
            )
        ms = _median_ms(torch, lambda: block.fused_attn_block(x, *w, h))
        host_us = _host_us(torch, lambda: block.fused_attn_block(x, *w, h))
        plain_ms = _median_ms(torch, lambda: block.block_reference(x, *w, h))
        rows_ = b * l
        flops = rows_ * 2 * c * (3 * c + c + 2 * hid) + 4 * rows_ * l * c
        nbytes = 2 * (2 * rows_ * c + 4 * c * c + 2 * c * hid + 4 * c + hid + c)
        bound, bound_by = _bound_ms(flops, nbytes)
        split = block.block_split(rows_, hid, torch.cuda.get_device_properties(dev).multi_processor_count)
        _print_k2_cycles(torch, block, where, split, x, w, h, dev)
        rows.append(dict(kernel="K2", where=where, shape=[b, l, c, h, hid],
                         max_abs_err=err, tolerance=f"atol {K2_ATOL} + {K2_RTOL} |y|",
                         ms=ms, plain_ms=plain_ms, library_ms=None, host_us=host_us,
                         library_host_us=None, bound_ms=bound,
                         bound_by=bound_by, flops=flops, bytes=nbytes))
        print(f"K2 {where:32s} [B={b} L={l} C={c} H={h} hidden={hid}] err {err:.3e} "
              f"(plain bf16 {plain_err:.3e}; atol {K2_ATOL} + {K2_RTOL:.4f}|y|, excess {excess:.3e}) "
              f"ms {ms:.4f} plain {plain_ms:.4f} bound {bound:.5f} ({bound_by}) host us {host_us:.1f}",
              flush=True)
    return rows


def _print_k2_cycles(torch, block, where, split, x, w, h, dev):
    """One more launch of K2, its timed instance, that records where its
    first CTA spends its SM clock cycles (from the CTA's start): per consumer
    warpgroup the ends of its phases and its waits for weight tiles, and the
    producer's waits for a free ring stage."""
    clocks = torch.zeros(block.K2_CLOCKS, dtype=torch.int64, device=dev)
    block.fused_attn_block(x, *w, h, clocks=clocks)
    t = clocks.tolist()
    names = ("ln1", "qkv+attention", "out-proj", "ln2", "MLP", "output")
    for wg in range(2):
        _print_cycles("K2", where, split, names, t[8 * wg:8 * wg + 6], t[8 * wg + 6],
                      t[8 * wg + 7], f"CTA 0 warpgroup {wg}: ")
    print(f"K2 {where:32s} split {split}, CTA 0 producer: waits for a free stage {t[16]} cycles, "
          f"last tile issued at {t[17]}", flush=True)


def check_k3(torch, F, attn, dev, gen, floor_ms):
    rows = []
    for where, b, l, c, h, calls in K3_SHAPES:
        d = c // h
        q, k, v = torch.randn(b, l, 3 * c, generator=gen, device=dev).bfloat16().split(c, dim=-1)
        out = attn.short_attention(q, k, v, h)
        torch.cuda.synchronize()
        want = attn.attention_reference(q.float(), k.float(), v.float(), h, d ** -0.5)
        err = (out.float() - want).abs().max().item()
        if out.shape != (b, l, c) or not math.isfinite(err) or err > K1_ATOL:
            raise SmokeError(f"K3 {where}: max |kernel - plain f32| = {err} > {K1_ATOL}")
        ms = _median_ms(torch, lambda: attn.short_attention(q, k, v, h))
        host_us = _host_us(torch, lambda: attn.short_attention(q, k, v, h))
        _time_k3_stages(torch, attn, where, q, k, v, h, want, dev)
        plain_ms = _median_ms(torch, lambda: attn.attention_reference(q, k, v, h, d ** -0.5))
        q4, k4, v4 = (t.view(b, l, h, d).transpose(1, 2) for t in (q, k, v))
        library_ms = _median_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4))
        library_host_us = _host_us(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4))
        flops = 4 * b * h * l * l * d
        nbytes = 2 * (3 * b * l * c + b * l * c)  # q, k, v read once, out written once
        bound, bound_by = _bound_ms(flops, nbytes)
        copy_ms = _copy_ms(torch, nbytes, dev)
        rows.append(dict(kernel="K3", where=where, shape=[b, l, l, c, h],
                         max_abs_err=err, tolerance=f"atol {K1_ATOL}", ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, host_us=host_us,
                         library_host_us=library_host_us, bound_ms=bound, bound_by=bound_by,
                         floor_ms=floor_ms, copy_ms=copy_ms, flops=flops, bytes=nbytes))
        print(f"K3 {where:32s} [B={b} L={l} C={c} H={h}] err {err:.3e} (atol {K1_ATOL}) "
              f"ms {ms:.4f} plain {plain_ms:.4f} sdpa {library_ms:.4f} bound {bound:.5f} ({bound_by}) "
              f"floor {floor_ms:.4f} copy {copy_ms:.4f} host us {host_us:.1f} "
              f"(sdpa {library_host_us:.1f})",
              flush=True)
    return rows


def _time_k3_stages(torch, attn, where, q, k, v, h, want, dev):
    """K3 at every ring depth (1 to 3 stages, each with as many CTAs as the
    card holds, at most one per unit), beside the plan's choice."""
    b, l, c = q.shape
    plan = attn._card_short_plan(dev.index, b, l, l, c, h)
    units = b * h // plan.heads
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for stages in range(1, attn.SHORT_MAX_STAGES + 1):
        fit = attn._short_resident(dev.index, c // h, l, 32 * plan.warps,
                                   attn.short_smem(l, l, plan.heads * (c // h), stages))
        if fit < 1:
            continue
        alt = plan._replace(stages=stages, grid=min(units, sms * fit))
        out = attn.short_attention(q, k, v, h, plan=alt)
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        if not math.isfinite(err) or err > K1_ATOL:
            raise SmokeError(f"K3 {where} at {alt}: max |kernel - plain f32| = {err} > {K1_ATOL}")
        alt_ms = _median_ms(torch, lambda: attn.short_attention(q, k, v, h, plan=alt))
        print(f"K3 {where:32s} {alt}{' (the plan)' if alt == plan else ''}: ms {alt_ms:.4f}, "
              f"err {err:.3e}", flush=True)


def _k4_inputs(torch, gen, dev, b, lq, lk, c, hid):
    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + torch.randn(*shape, generator=gen, device=dev) * std).bfloat16()

    # norm_context affine near (1, 0), lecun-normal-scale weights ([out, in]), small biases
    w = [rnd(c, mean=1.0, std=0.1), rnd(c, std=0.1), rnd(c, c, std=c ** -0.5), rnd(c, std=0.02),
         rnd(2 * c, c, std=c ** -0.5), rnd(2 * c, std=0.02), rnd(c, c, std=c ** -0.5),
         rnd(c, std=0.02), rnd(hid, c, std=c ** -0.5), rnd(hid, std=0.02),
         rnd(c, hid, std=hid ** -0.5), rnd(c, std=0.02)]
    return rnd(b, lq, c), rnd(b, lk, c), w


def _k4_excess(torch, block, x, ctx, w, h, want, split=None):
    """|kernel - plain f32| beyond K2_RTOL |y| (and the output) at a split."""
    out = block.fused_cross_block(x, ctx, *w, h, split=split)
    torch.cuda.synchronize()
    if out.shape != x.shape or not torch.isfinite(out).all():
        raise SmokeError(f"K4 {tuple(x.shape)} ctx {tuple(ctx.shape)} split {split}: "
                         f"shape {tuple(out.shape)} or values not finite")
    return ((out.float() - want).abs() - K2_RTOL * want.abs()).max().item(), out


def check_k4(torch, block, dev, gen):
    rows = []
    for where, b, lq, lk, c, h, hid, calls in K4_SHAPES:
        x, ctx, w = _k4_inputs(torch, gen, dev, b, lq, lk, c, hid)
        want = block.cross_block_reference(x.float(), ctx.float(), *(t.float() for t in w), h)
        excess, out = _k4_excess(torch, block, x, ctx, w, h, want)
        err = (out.float() - want).abs().max().item()
        plain_err = (block.cross_block_reference(x, ctx, *w, h).float() - want).abs().max().item()
        if not math.isfinite(err) or excess > K2_ATOL:
            raise SmokeError(
                f"K4 {where}: |kernel - plain f32| exceeds {K2_ATOL} + {K2_RTOL}|y| by {excess}"
            )
        # every split of the query tiles, whatever the plan picks
        for split in K4_SPLITS:
            ex, _ = _k4_excess(torch, block, x, ctx, w, h, want, split)
            split_ms = _median_ms(torch, lambda: block.fused_cross_block(x, ctx, *w, h, split=split))
            print(f"K4 {where:32s} split {split}: excess over {K2_ATOL} + {K2_RTOL:.4f}|y| {ex:.3e}, "
                  f"ms {split_ms:.4f}", flush=True)
            if ex > K2_ATOL:
                raise SmokeError(f"K4 {where} split {split}: exceeds {K2_ATOL} + {K2_RTOL}|y| by {ex}")
        ms = _median_ms(torch, lambda: block.fused_cross_block(x, ctx, *w, h))
        host_us = _host_us(torch, lambda: block.fused_cross_block(x, ctx, *w, h))
        plain_ms = _median_ms(torch, lambda: block.cross_block_reference(x, ctx, *w, h))
        rq, rk = b * lq, b * lk
        flops = 2 * c * (rq * (2 * c + 2 * hid) + rk * 2 * c) + 4 * rq * lk * c
        nbytes = 2 * (2 * rq * c + rk * c + 4 * c * c + 2 * c * hid)
        bound, bound_by = _bound_ms(flops, nbytes)
        plan = block.card_cross_split(b * lq, h, c, dev.index)
        _print_k4_cycles(torch, block, where, x, ctx, w, h, out, plan, dev)
        if plan > 1:  # and at split 8, one head per CTA
            out8 = block.fused_cross_block(x, ctx, *w, h, split=8)
            _print_k4_cycles(torch, block, where, x, ctx, w, h, out8, 8, dev)
        rows.append(dict(kernel="K4", where=where, shape=[b, lq, lk, c, h, hid],
                         max_abs_err=err, tolerance=f"atol {K2_ATOL} + {K2_RTOL} |y|",
                         ms=ms, plain_ms=plain_ms, library_ms=None, host_us=host_us,
                         library_host_us=None, bound_ms=bound,
                         bound_by=bound_by, flops=flops, bytes=nbytes))
        print(f"K4 {where:32s} [B={b} Lq={lq} Lk={lk} C={c} H={h} hidden={hid}] err {err:.3e} "
              f"(plain bf16 {plain_err:.3e}; atol {K2_ATOL} + {K2_RTOL:.4f}|y|, excess {excess:.3e}) "
              f"ms {ms:.4f} plain {plain_ms:.4f} bound {bound:.5f} ({bound_by}) host us {host_us:.1f}",
              flush=True)
    return rows


def _print_cycles(kernel, where, split, names, ends, waited, tiles, extra=""):
    """One line of a timed instance's reading for one consumer warpgroup:
    cycles per phase (from the ends of the phases), and its waits for ring
    tiles."""
    spans = [b - a for a, b in zip([0] + ends[:-1], ends)]
    print(f"{kernel} {where:32s} split {split}, {extra}cycles "
          f"{', '.join(f'{n} {v}' for n, v in zip(names, spans))}; total {ends[-1]}, of "
          f"which waiting for ring tiles {waited} ({waited / ends[-1]:.2f}) over {tiles} tiles",
          flush=True)


def _print_k4_cycles(torch, block, where, x, ctx, w, h, out, split, dev):
    """One more launch of K4 at a split, its timed instances, that records
    where the first CTA of each launch spends its SM clock cycles; its output
    must be the forward's at that split (out), bit for bit."""
    clocks = torch.zeros(block.K4_CLOCKS, dtype=torch.int64, device=dev)
    timed = block.fused_cross_block(x, ctx, *w, h, split=split, clocks=clocks)
    torch.cuda.synchronize()
    if not torch.equal(timed, out):
        raise SmokeError(f"K4 {where} split {split}: the timed instance's output differs from "
                         f"the forward's")
    t = clocks.tolist()
    names = ("ln1", "q+attention", "exchange", "out-proj", "ln2", "MLP", "output")
    for wg in range(2):
        _print_cycles("K4", where, split, names, t[12 * wg:12 * wg + 7], t[12 * wg + 8],
                      t[12 * wg + 9], f"query side CTA 0 warpgroup {wg}: ")
        print(f"K4 {where:32s} split {split}, warpgroup {wg}: exchange sent at "
              f"{t[12 * wg + 7]}, waits for tiles in q+attention {t[12 * wg + 10]}", flush=True)
    print(f"K4 {where:32s} producer: waits for a free stage {t[24]} cycles, last tile issued at "
          f"{t[25]}; kv projection CTA 0: LN_ctx {t[26]}, total {t[27]}, of which warpgroup 0 "
          f"waiting for weight tiles {t[28]} over {t[29]} tiles", flush=True)


def check_k5(torch, F, norm, dev, gen, floor_ms):
    rows = []
    for where, r, c, affine, calls in K5_SHAPES:
        x = (torch.randn(r, c, generator=gen, device=dev) * 3 + 1).bfloat16()
        s = torch.randn(c, generator=gen, device=dev) if affine else None
        b = torch.randn(c, generator=gen, device=dev) if affine else None
        out = norm.fused_layer_norm(x, s, b)
        torch.cuda.synchronize()
        want = norm.layer_norm_reference(x.float(), s, b)
        excess = ((out.float() - want).abs() - K5_RTOL * want.abs()).max().item()
        err = (out.float() - want).abs().max().item()
        if out.shape != x.shape or out.dtype != x.dtype or not math.isfinite(err) or excess > K5_ATOL:
            raise SmokeError(
                f"K5 {where}: |kernel - plain f32| exceeds {K5_ATOL} + {K5_RTOL}|y| by {excess}"
            )
        ms = _median_ms(torch, lambda: norm.fused_layer_norm(x, s, b))
        host_us = _host_us(torch, lambda: norm.fused_layer_norm(x, s, b))
        plain_ms = _median_ms(torch, lambda: norm.layer_norm_reference(x, s, b))
        s16, b16 = (t.bfloat16() if t is not None else None for t in (s, b))
        library_ms = _median_ms(torch, lambda: F.layer_norm(x, (c,), s16, b16, 1e-6))
        library_host_us = _host_us(torch, lambda: F.layer_norm(x, (c,), s16, b16, 1e-6))
        flops = 8 * r * c  # sum, center, square, sum, scale by rstd, affine: f32, off the tensor cores
        nbytes = 2 * (2 * r * c) + (8 * c if affine else 0)  # x in, y out (bf16), f32 scale and bias
        bound, bound_by = _bound_ms(flops, nbytes, PEAK_F32_FLOPS)
        copy_ms = _copy_ms(torch, nbytes, dev)
        rows.append(dict(kernel="K5", where=where, shape=[r, c, "bfloat16", affine],
                         max_abs_err=err, tolerance=f"atol {K5_ATOL} + {K5_RTOL} |y|",
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms, host_us=host_us,
                         library_host_us=library_host_us, bound_ms=bound,
                         bound_by=bound_by, floor_ms=floor_ms, copy_ms=copy_ms, flops=flops,
                         bytes=nbytes))
        print(f"K5 {where:42s} [rows={r} C={c} affine={affine}] err {err:.3e} "
              f"(atol {K5_ATOL} + {K5_RTOL:.4f}|y|, excess {excess:.3e}) ms {ms:.4f} "
              f"plain {plain_ms:.4f} F.layer_norm {library_ms:.4f} bound {bound:.5f} ({bound_by}) "
              f"floor {floor_ms:.4f} copy {copy_ms:.4f} "
              f"host us {host_us:.1f} (F.layer_norm {library_host_us:.1f})",
              flush=True)
    return rows


def _k2_inputs(torch, gen, dev, b, l, c, hid):
    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).bfloat16()

    # lecun-normal-scale weights ([out, in]) and small biases
    w = [rnd(3 * c, c, std=c ** -0.5), rnd(3 * c, std=0.02), rnd(c, c, std=c ** -0.5),
         rnd(c, std=0.02), rnd(hid, c, std=c ** -0.5), rnd(hid, std=0.02),
         rnd(c, hid, std=hid ** -0.5), rnd(c, std=0.02)]
    return rnd(b, l, c), w


def _k3_edge_inputs(torch, gen, dev, b, lq, lk, c, layout):
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev).bfloat16()  # noqa: E731
    if layout == "packed" and lq == lk:
        return rnd(b, lq, 3 * c).split(c, -1)
    if layout == "packed":
        return (rnd(b, lq, c), *rnd(b, lk, 2 * c).split(c, -1))
    if layout == "expanded":
        return (rnd(b, lq, c), rnd(1, lk, c).expand(b, lk, c), rnd(1, lk, c).expand(b, lk, c))
    return rnd(b, lq, c), rnd(b, lk, c), rnd(b, lk, c)


def check_edges_k3_k5(torch, attn, norm, dev, gen):
    """K3 and K5 at the edge shapes of their plans, correctness only."""
    for b, lq, lk, c, h, layout in K3_EDGE:
        q, k, v = _k3_edge_inputs(torch, gen, dev, b, lq, lk, c, layout)
        out = attn.short_attention(q, k, v, h)
        torch.cuda.synchronize()
        want = attn.attention_reference(q.float(), k.float(), v.float(), h, (c // h) ** -0.5)
        err = (out.float() - want).abs().max().item()
        plan = attn._card_short_plan(dev.index, b, lq, lk, c, h)
        print(f"K3 edge [B={b} Lq={lq} Lk={lk} C={c} H={h} {layout}] {plan}: err {err:.3e} "
              f"(atol {K1_ATOL})", flush=True)
        if out.shape != (b, lq, c) or not math.isfinite(err) or err > K1_ATOL:
            raise SmokeError(f"K3 edge {(b, lq, lk, c, h, layout)}: max |kernel - plain f32| = "
                             f"{err} > {K1_ATOL}")
    worst = {}
    for r, c, dt, affine in K5_EDGE:
        x = (torch.randn(r, c, generator=gen, device=dev) * 3 + 1).to(getattr(torch, dt))
        s = torch.randn(c, generator=gen, device=dev) if affine else None
        bias = torch.randn(c, generator=gen, device=dev) if affine else None
        out = norm.fused_layer_norm(x, s, bias)
        torch.cuda.synchronize()
        want = norm.layer_norm_reference(x.float(), s, bias)
        if dt == "float32":  # atol and rtol 1e-5
            excess = ((out - want).abs() - K5_F32_TOL * want.abs()).max().item()
            limit = K5_F32_TOL
        else:
            excess = ((out.float() - want).abs() - K5_RTOL * want.abs()).max().item()
            limit = K5_ATOL
        worst[dt] = max(worst.get(dt, -math.inf), excess)
        if (out.shape != x.shape or out.dtype != x.dtype or not math.isfinite(excess)
                or excess > limit):
            raise SmokeError(f"K5 edge {(r, c, dt, affine)}: exceeds its tolerance by {excess}")
    print(f"K5 edges: {len(K5_EDGE)} shapes (rows 1 to 9296, C 8 to 1024, bf16 and f32, affine "
          f"or not) within tolerance; largest excess over atol + rtol |y| by dtype {worst}",
          flush=True)


def check_edges(torch, attn, block, dev, gen):
    """K1, K2 and K4 at the edge shapes of their tilings, correctness only."""
    for b, lq, lk, c, h, layout in K1_EDGE:
        d = c // h
        if layout == "packed" and lq == lk:
            q, k, v = torch.randn(b, lq, 3 * c, generator=gen, device=dev).bfloat16().split(c, -1)
        else:
            q = torch.randn(b, lq, c, generator=gen, device=dev).bfloat16()
            kv = torch.randn(1 if layout == "expanded" else b, lk, 2 * c, generator=gen,
                             device=dev).bfloat16()
            k, v = kv[..., :c].contiguous(), kv[..., c:].contiguous()
            if layout == "packed":
                k, v = kv.split(c, dim=-1)
            elif layout == "expanded":
                k, v = k.expand(b, lk, c), v.expand(b, lk, c)
        out = attn.fused_attention(q, k, v, h)
        torch.cuda.synchronize()
        want = attn.attention_reference(q.float(), k.float(), v.float(), h, d ** -0.5)
        err = (out.float() - want).abs().max().item()
        print(f"K1 edge [B={b} Lq={lq} Lk={lk} C={c} H={h} {layout}]: err {err:.3e} "
              f"(atol {K1_ATOL})", flush=True)
        if out.shape != (b, lq, c) or not math.isfinite(err) or err > K1_ATOL:
            raise SmokeError(f"K1 edge {(b, lq, lk, c, h)}: max |kernel - plain f32| = {err} > {K1_ATOL}")
    for b, l, c in K2_EDGE:
        x, w = _k2_inputs(torch, gen, dev, b, l, c, 4 * c)
        out = block.fused_attn_block(x, *w, 8)
        torch.cuda.synchronize()
        want = block.block_reference(x.float(), *(t.float() for t in w), 8)
        excess = ((out.float() - want).abs() - K2_RTOL * want.abs()).max().item()
        split = block.block_split(b * l, 4 * c, torch.cuda.get_device_properties(dev).multi_processor_count)
        print(f"K2 edge [B={b} L={l} C={c}] split {split}: err {(out.float() - want).abs().max().item():.3e}, "
              f"excess over {K2_ATOL} + {K2_RTOL:.4f}|y| {excess:.3e}", flush=True)
        if out.shape != x.shape or not math.isfinite(excess) or excess > K2_ATOL:
            raise SmokeError(f"K2 edge {(b, l, c)}: exceeds {K2_ATOL} + {K2_RTOL}|y| by {excess}")
    for b, lq, lk, c in K4_EDGE:
        x, ctx, w = _k4_inputs(torch, gen, dev, b, lq, lk, c, 4 * c)
        want = block.cross_block_reference(x.float(), ctx.float(), *(t.float() for t in w), 8)
        worst = {split: _k4_excess(torch, block, x, ctx, w, 8, want, split)[0]
                 for split in (None, 2, 4, 8)}
        plain = block.cross_block_reference(x, ctx, *w, 8).float()
        plain_excess = ((plain - want).abs() - K2_RTOL * want.abs()).max().item()
        missed = not all(math.isfinite(e) and e <= K2_ATOL for e in worst.values())
        known = (b, lq, lk, c) in K4_KNOWN_MISS
        print(f"K4 edge [B={b} Lq={lq} Lk={lk} C={c}]: excess over {K2_ATOL} + {K2_RTOL:.4f}|y| "
              f"by split (None: the plan's) {worst}; plain bf16 {plain_excess:.3e}"
              f"{'; MISSED' if missed else ''}{' (a known miss)' if missed and known else ''}",
              flush=True)
        if missed and not known:
            raise SmokeError(f"K4 edge {(b, lq, lk, c)}: exceeds {K2_ATOL} + {K2_RTOL}|y| "
                             f"(plain bf16: {plain_excess}): {worst}")
        if known and plain_excess <= K2_ATOL:
            raise SmokeError(f"K4 edge {(b, lq, lk, c)} is in K4_KNOWN_MISS, but the plain "
                             f"version in bf16 meets the tolerance there ({plain_excess})")
        if known:
            # held instead to the plain version in bf16, at the same tolerance
            against = {split: _k4_excess(torch, block, x, ctx, w, 8, plain, split)[0]
                       for split in (None, 2, 4, 8)}
            print(f"K4 edge [B={b} Lq={lq} Lk={lk} C={c}] against plain bf16: excess {against}",
                  flush=True)
            if not all(math.isfinite(e) and e <= K2_ATOL for e in against.values()):
                raise SmokeError(f"K4 edge {(b, lq, lk, c)}: exceeds {K2_ATOL} + {K2_RTOL}|y| "
                                 f"against the plain version in bf16: {against}")


def _request(torch, cfg, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    s, hw, n = cfg.seqlen, cfg.img_size, cfg.track_num
    images = torch.randn(1, s, hw, hw, 3, generator=gen, device=dev)
    queries = torch.rand(1, n, 2, generator=gen, device=dev) * (hw - 20) + 10
    return images, queries


def _reset(counters):
    for fn in counters.values():
        fn.launches = 0
        fn.launch_shapes.clear()


def _launches(counters):
    return {name: fn.launches for name, fn in counters.items()}


def reference_check(torch, tcfg, models, model, dev, counters):
    """The main path's modules at full width on small inputs: on the card in
    bf16 (through the kernels) against the same weights in f32 on the CPU
    (plain versions), within REF_RTOL of the reference's largest value, on
    both routes."""
    cpu = models.build_comet(tcfg.get_config("ours").replace(compute_dtype="float32"),
                             device="cpu", seed=0)
    gen = torch.Generator().manual_seed(11)
    coarse_in = model.coarse_tracker.updateformer.input_transform.in_features
    fine_in = model.fine_tracker.updateformer.input_transform.in_features
    cases = [
        # coarse update-former: K2 at L 16 (time) and 64 (virtual), K1 both
        # ways; on FUSED_ROUTE K3 at both, K4 with Lk 32 and Lq 32, K5
        ("coarse update-former [1, 32 tracks, 16 frames]", "coarse_tracker.updateformer",
         (torch.randn(1, 32, 16, coarse_in, generator=gen),)),
        # fine update-former: K2 at C 256; on FUSED_ROUTE K3 and K5
        ("fine update-former [32 tracks, 1, 16 frames]", "fine_tracker.updateformer",
         (torch.randn(32, 1, 16, fine_in, generator=gen),)),
        # camera predictor: K1 in the ViT, the aggregator, T_P and the trunk;
        # on FUSED_ROUTE K5 at every LayerNorm
        ("camera predictor [1, 2 frames, 64 px, 32 tracks]", "camera_predictor",
         (torch.randn(1, 2, 64, 64, 3, generator=gen), torch.rand(1, 2, 32, 2, generator=gen) * 64,
          torch.rand(1, 2, 32, generator=gen))),
    ]
    worst = {}
    for route_name, route in (("default", tcfg.KernelRoute()), ("fused", tcfg.FUSED_ROUTE)):
        model.set_route(route)
        _reset(counters)
        for where, path, args in cases:
            with torch.inference_mode():
                got = model.get_submodule(path)(*(a.to(dev) for a in args))
                want = cpu.get_submodule(path)(*args)
            if path == "camera_predictor":
                got, want = got.pred_pose_enc, want.pred_pose_enc
            got = got.float().cpu()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            worst[(route_name, where)] = err / scale
            print(f"reference check, {route_name} route, {where}: max |card bf16 - CPU f32| = "
                  f"{err:.3e}, max |reference| = {scale:.3f}, ratio {err / scale:.2e} "
                  f"(limit {REF_RTOL})", flush=True)
            if not torch.isfinite(got).all() or not err <= REF_RTOL * scale:
                raise SmokeError(f"reference check {route_name} {where}: max |diff| {err} > "
                                 f"{REF_RTOL} * {scale}")
        used = _launches(counters)
        print(f"reference check, {route_name} route: launches {used}", flush=True)
        want_used = ("K1", "K2") if route_name == "default" else ("K1", "K3", "K4", "K5")
        if any(used[k] == 0 for k in want_used):
            raise SmokeError(f"reference check {route_name}: a kernel of the route never ran: {used}")
    model.set_route(tcfg.KernelRoute())
    return worst


def _want_shapes(route_name, n):
    """The per-shape launch counts of n forwards on a route."""
    want = {k: {} for k in KERNELS}
    if route_name == "default":
        want["K1"] = {tuple(r[1:6]): n * r[-2] for r in K1_SHAPES if r[-2]}
        want["K2"] = {tuple(r[1:6]): n * r[-1] for r in K2_SHAPES}
    else:
        want["K1"] = {tuple(r[1:6]): n * r[-1] for r in K1_SHAPES if r[-1]}
        want["K3"] = {(b, l, l, c, h): n * calls for _, b, l, c, h, calls in K3_SHAPES}
        want["K4"] = {tuple(r[1:7]): n * r[-1] for r in K4_SHAPES}
        want["K5"] = {(r, c, "bfloat16", affine): n * calls for _, r, c, affine, calls in K5_SHAPES}
    return want


def main_path(torch, cfg, model, models, geom, counters, route_name, dev, n_requests, card):
    s, n = cfg.seqlen, cfg.track_num
    requests = [_request(torch, cfg, 100 + i, dev) for i in range(n_requests)]
    gen = torch.Generator(device="cpu").manual_seed(5)
    q = torch.randn(s, 4, generator=gen)
    q = q / q.norm(dim=-1, keepdim=True)
    t_uvz = torch.randn(s, 3, generator=gen) * 40 + torch.tensor([320.0, 240.0, 0.0])
    t_uvz[:, 2] = t_uvz[:, 2].abs() + 3.0
    cams = geom.make_camera_set(q, torch.zeros(s, 3), t_uvz=t_uvz, ratio=0.9, device=dev)
    identity = torch.tensor([0, 0, 0, 1, 0, 0, 0], dtype=torch.float32, device=dev)
    intr = geom.INTRINSICS_TABLE[cfg.dataset]
    t_ref = cams.t_uvz[0]
    t_ref_xyz = torch.stack([(t_ref[0] - intr.cx) * t_ref[2] / intr.fx,
                             (t_ref[1] - intr.cy) * t_ref[2] / intr.fy, t_ref[2]])
    per_forward = PER_FORWARD[route_name]

    torch.cuda.reset_peak_memory_stats()
    times = []
    _reset(counters)
    for i, (images, queries) in enumerate(requests):
        before = _launches(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(images, queries)
            q_abs, t_abs = models.decode_predictions(cfg, out["pred_pose_enc"][0], cams)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches = {k: v - before[k] for k, v in _launches(counters).items()}
        want_shapes = dict(coarse_track=(1, s, n, 2), pred_track=(1, s, n, 2),
                           track_score=(1, s, n), track_vis=(1, s, n), pred_pose_enc=(1, s, 7))
        for key, shape in want_shapes.items():
            if tuple(out[key].shape) != shape:
                raise SmokeError(f"request {i}: {key} has shape {tuple(out[key].shape)}, want {shape}")
            if not torch.isfinite(out[key]).all():
                raise SmokeError(f"request {i}: {key} is not finite")
        if not torch.equal(out["pred_pose_enc"][0, 0], identity):
            raise SmokeError(f"request {i}: frame 0 pose is not the identity")
        if not torch.allclose(out["pred_track"][:, 0], queries, atol=1e-3, rtol=0):
            raise SmokeError(f"request {i}: frame 0 tracks are not the queries")
        if not (torch.isfinite(q_abs).all() and torch.isfinite(t_abs).all()):
            raise SmokeError(f"request {i}: decoded poses are not finite")
        q_ref = torch.where(cams.q[0, :1] < 0, -cams.q[0], cams.q[0])
        if not (torch.allclose(q_abs[0], q_ref, atol=1e-5) and torch.allclose(t_abs[0], t_ref_xyz, rtol=1e-5)):
            raise SmokeError(f"request {i}: frame 0 does not decode to the reference camera")
        if launches != per_forward:
            raise SmokeError(f"{route_name} route, request {i}: kernel launches {launches}, "
                             f"want {per_forward}")
        print(f"{route_name} route, request {i}: forward + decode {times[-1]:.1f} ms, launches "
              f"{' '.join(f'{k} {v}' for k, v in launches.items())}, outputs finite, "
              f"frame 0 pinned", flush=True)
    total = _launches(counters)
    shapes = {k: dict(fn.launch_shapes) for k, fn in counters.items()}
    want = _want_shapes(route_name, n_requests)
    if shapes != want:
        raise SmokeError(f"{route_name} route launched the kernels at {shapes}, want {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(times[1:]) if len(times) > 1 else times[0]
    print(f"main path, {route_name} route: {n_requests} requests, forward ms "
          f"{['%.1f' % t for t in times]}, median of requests 2-{n_requests} {med:.1f} ms = "
          f"{1e3 / med:.2f} sequences/s, peak memory {peak:.2f} GiB, on {card}", flush=True)
    return dict(total=total, shapes=shapes, times=times, median_ms=med, peak_gib=peak,
                requests=requests)


# the port's kernel names in the profiler's table (namespace comet::), by kernel
PROFILE_KEYS = dict(K1=("attn_fwd_kernel",), K2=("attn_block_kernel",),
                    K3=("short_attn_kernel",), K4=("cross_kv_kernel", "cross_block_kernel"),
                    K5=("layer_norm_kernel",))


def profile(torch, model, images, queries, path, route_name, request_ms):
    """torch.profiler over one warm forward: device time by operator, and the
    device's idle share of the route's median request."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    with torch.inference_mode():
        model(images, queries)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(images, queries)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    device_us = sum(e.self_device_time_total for e in kernels)
    by_kernel = {k: sum(e.self_device_time_total for e in kernels
                        if "comet::" in e.key and any(n in e.key for n in names))
                 for k, names in PROFILE_KEYS.items()}
    out = Path(path)
    out = out.with_name(f"{out.stem}_{route_name}{out.suffix}")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    print(f"profile, {route_name} route: one forward, {wall:.1f} ms on the host clock (profiler on), "
          f"{device_us / 1e3:.1f} ms of device time in {sum(e.count for e in kernels)} kernel "
          f"launches, of which {', '.join(f'{k} {v / 1e3:.2f} ms' for k, v in by_kernel.items())}; "
          f"idle share of the median request ({request_ms:.1f} ms): "
          f"{1 - device_us / 1e3 / request_ms:.2f}; table in {out}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="PATH",
                        help="write a torch.profiler table of one forward per route "
                             "(PATH with the route's name added)")
    parser.add_argument("--requests", type=int, default=REQUESTS,
                        help=f"requests the main path answers on each route (default {REQUESTS})")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import torch.nn.functional as F

        from comet_tpu_torch import config as tcfg
        from comet_tpu_torch import geometry as geom
        from comet_tpu_torch import models
        from comet_tpu_torch.ops import attn, block, kernels, norm
    except ImportError as exc:
        print(f"chip_smoke: the comet_tpu_torch package is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "comet_tpu")]:
        print(f"chip_smoke: {name} was imported", file=sys.stderr)
        return 2

    counters = dict(K1=attn.fused_attention, K2=block.fused_attn_block, K3=attn.short_attention,
                    K4=block.fused_cross_block, K5=norm.fused_layer_norm)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
          f"nvidia-smi: {smi}", flush=True)
    runs = {}
    try:
        t0 = time.perf_counter()
        kernels.library()
        print(f"kernel build: {time.perf_counter() - t0:.1f} s "
              f"(nvcc {' '.join(kernels.NVCC_FLAGS[:2])}, {', '.join(kernels.SOURCES)})", flush=True)
        report = kernels.ptxas_report()
        spilled = [name for name, _, stores, loads in report if stores or loads]
        print(f"ptxas: {len(report)} kernel instances, registers "
              f"{sorted({regs for _, regs, _, _ in report})}, spilling {spilled or 'none'}",
              flush=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        floor_ms = _floor_ms(torch)
        print(f"launch floor (an empty launch between two events): {floor_ms:.4f} ms", flush=True)
        checked = dict(K1=check_k1(torch, F, attn, dev, gen), K2=check_k2(torch, block, dev, gen),
                       K3=check_k3(torch, F, attn, dev, gen, floor_ms),
                       K4=check_k4(torch, block, dev, gen),
                       K5=check_k5(torch, F, norm, dev, gen, floor_ms))
        check_edges(torch, attn, block, dev, gen)
        check_edges_k3_k5(torch, attn, norm, dev, gen)
        cfg = tcfg.get_config("ours")
        t0 = time.perf_counter()
        model = models.build_comet(cfg, device=dev, seed=0)
        torch.cuda.synchronize()
        print(f"build_comet('ours') on {dev} in {time.perf_counter() - t0:.1f} s, "
              f"{sum(p.numel() for p in model.parameters())} parameters", flush=True)
        reference_check(torch, tcfg, models, model, dev, counters)
        for route_name, route in (("default", tcfg.KernelRoute()), ("fused", tcfg.FUSED_ROUTE)):
            model.set_route(route)
            runs[route_name] = main_path(torch, cfg, model, models, geom, counters, route_name,
                                         dev, args.requests, smi)
            if args.profile:
                profile(torch, model, *runs[route_name]["requests"][0], args.profile, route_name,
                        runs[route_name]["median_ms"])
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    for route_name, run in runs.items():
        missing = [k for k, n in PER_FORWARD[route_name].items() if n and run["total"][k] == 0]
        if missing:
            print(f"chip_smoke: FAILED: {missing} never launched on the {route_name} route",
                  file=sys.stderr)
            return 1
    record = []
    for kernel, source, replaces in (
        ("K1", "comet_tpu_torch/csrc/attn.cu", "comet_tpu/ops/pallas_attn.py:106"),
        ("K2", "comet_tpu_torch/csrc/block.cu", "comet_tpu/ops/pallas_block.py:150"),
        ("K3", "comet_tpu_torch/csrc/short_attn.cu", "comet_tpu/ops/pallas_attn.py:95"),
        ("K4", "comet_tpu_torch/csrc/cross_block.cu", "comet_tpu/ops/pallas_block.py:298"),
        ("K5", "comet_tpu_torch/csrc/norm.cu", "comet_tpu/ops/pallas_norm.py:43"),
    ):
        for r in checked[kernel]:
            # launches: this kernel at this shape in each route's main-path run
            by_route = {rn: run["shapes"][kernel].get(tuple(r["shape"]), 0) for rn, run in runs.items()}
            record.append(dict(
                name=f"{kernel} {r['where']} {r['shape']}", route="cuda", source=source,
                replaces=replaces, launches=sum(by_route.values()), launches_by_route=by_route,
                max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
                host_us=r["host_us"], library_host_us=r["library_host_us"], tolerance=r["tolerance"],
                floor_ms=r.get("floor_ms"), copy_ms=r.get("copy_ms"),
            ))
    for route_name, run in runs.items():
        print(f"main path, {route_name} route: launches over {args.requests} requests "
              f"{run['total']} ({PER_FORWARD[route_name]} per forward); median request "
              f"{run['median_ms']:.1f} ms = {1e3 / run['median_ms']:.2f} sequences/s, peak memory "
              f"{run['peak_gib']:.2f} GiB", flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
