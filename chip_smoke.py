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
   (through its ``comet::`` operator, with grad mode on and under inference
   mode, beside the direct launch function the operator runs) and of the
   library call (and, at the camera input norm, K5 registered through the
   ``torch.library.custom_op`` decorator against its ``comet::`` operator);
   for K3 and K5 two yardsticks beside the
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
   printed as such, and held to the plain version in bf16 instead); K2 also
   at the shape of the TPU tool ``tools/micro_lane_packing.py`` (K2's
   function in a lane-packed layout); and K1's two A/B softmax forms
   (``fused_attention(..., softmax="nomax" | "bf16e")``, the TPU tool
   ``tools/micro_softmax_variants.py``'s) at the tool's two shapes, timed
   beside K1 and ``F.scaled_dot_product_attention``, and at K1's edge
   shapes with D 64 and 96, each held to its own plain version on the same
   bf16 inputs (``FORM_ATOL`` + ``FORM_RTOL`` |y|);
4. a reference check on small inputs: the full-width ``ours`` model's coarse
   and fine update-formers and its camera predictor, on the card in bf16
   (through the kernels) against the same weights in f32 on the CPU (plain
   versions), on the default route and on ``FUSED_ROUTE``; then the camera
   predictor's gradients on the same inputs: every tensor that
   ``training.camera_only_mask`` selects, on the card in bf16 (the kernels'
   operators and their registered backward) against the CPU in f32, within ``GRAD_RTOL`` of its
   norm, and no frozen parameter with a gradient;
5. the main path, once per route: ``build_comet(get_config("ours"))`` on the
   card at full width (16 frames, 512 px, 512 tracks, bf16, random weights
   from seed 0) answers 3 seeded requests through ``COMET.forward`` and
   ``decode_predictions`` on the default route (K1 and K2), then the same
   model, switched with ``COMET.set_route(FUSED_ROUTE)``, answers 3 more
   (K1, K3, K4 and K5); the kernels' launch counts are set to 0 just before
   each route's requests and read just after, and must rise by that route's
   per-forward counts at the expected shapes;
6. the bench: ``bench_lib.run_benchmark(get_config("ours"))`` on the
   default route, whose model has its parameters cast to bf16 once (its
   JSON on a line of its own, printed beside the main path's requests,
   whose model keeps f32 masters cast at every use), and
   ``bench_lib.run_softmax_variants()``, printed as the TPU tool prints it;
   the counts are set to 0 before each and read after it: the forward's
   K1 and K2, and each softmax form's launches at each of the tool's shapes;
7. eval: ``training.evaluate()`` with the same full-width model over 4
   sequences made in memory from a seed (uint8 frames of 480 x 640, a mask,
   poses; no image file, PIL or cv2), each cropped and resized by
   ``data.preprocess_frames`` on the card (which must match its f32 run on
   the CPU within 1e-5, bilinear and Lanczos), query points seeded with the
   "grid" backend; at eval_batch 1 and 2: every metric finite, the metric
   block's key set, each sequence's metric row at batch 2 (padded with
   itself) within ``EVAL_RTOL`` of its row at batch 1, K1 and K2 launched
   their per-forward counts once per forward, and the eval sequences/s;
8. training: the operators' registered gradients at the train step's shapes
   (K1 at the camera's four, K5 at the camera's LayerNorms) equal the plain
   versions' autograd on the same bf16 inputs bit for bit, timed as forward
   + backward; then per route 3 train steps of the same full-width model
   (``training.build_optimizer`` and ``build_train_step``, f32 master
   parameters, bf16 compute) on fresh seeded images: each loss finite, the
   kernels launched their per-forward counts each step (the frozen tracker
   and ViT still run theirs, under no_grad), the Functions ran their
   backward at the camera's shapes only, every tensor the mask selects
   moved and every other stayed bit for bit; the step's forward, backward
   and optimizer timed between CUDA events, its peak memory, and the
   device's idle share from a profiled step; and
   ``bench_lib.run_train_benchmark`` per route (its JSON on a line of its
   own), with the counts set to 0 before it and read after;
9. the windowed mode (``models/windowed.py``), per route, on the model
   cast to bf16 once: at T 16 = window_len ``windowed_forward`` equals one
   forward (encodings within WINDOWED_ULPS ulps, tracks bit for bit, frame 0
   the queries) and its decode; at T 48 (5 windows) the host loop and the
   scan form ``windowed_forward_scan`` agree (tracks bit for bit, encodings
   within WINDOWED_ULPS ulps; two forwards of one request must be bit for
   bit equal), both finite with frame 0 the identity, and each launches
   exactly windows x the route's per-forward counts; the host
   synchronizations of a forward and of each form in torch's sync debug
   mode, those inside the windows' forwards told from the form's own (the
   scan form must have none of its own); both forms timed
   at T 48 and 64 (5 and 7 windows); then on the f32-master model 3
   ``build_windowed_train_step`` steps at T 32 (3 windows) without and 3
   with teacher forcing: losses finite, launches and Function backwards 3 x
   a step's, every tensor ``camera_only_mask`` selects moved and every
   other bit for bit unchanged, each step split into forward, backward and
   optimizer between CUDA events, its peak memory, and a loss on the last
   frame (in the last window only) with a nonzero gradient on the first
   window's encodings; and
10. the CLI: an AMD fixture (1 train and 2 eval sequences of 32 frames) and
   a DCA fixture (one of 48) written by ``data.fixtures`` to a temporary
   directory, then ``cli.main`` at full width on the card: ``eval
   --device-preprocess --eval-batch 2 --max-sequences 2``, ``demo
   --demo-seq-len 48`` (windowed), ``train --windowed --train-seq-len 32
   --epochs 1 --eval-interval 1 --ckpt-interval 1`` and ``bench --suite
   infer``, each timed:
   CSV rows finite; the demo's JSON, GLB (read back), HTML and COLMAP model
   (read back); ``train_results.csv`` with ``tf_ratio``, ``ckpt/``,
   ``best.pt`` and ``best.json``. Whether the reprojection video (cv2's
   mp4 codec) was written is printed; its absence fails nothing; and
11. serving (``utils/serving.py``) on a copy of the model cast to bf16 once
   with frozen weights: the forward on each route and the windowed chain at
   T 48 (default route) exported with ``torch.export`` (the graph must hold
   each route's kernels as ``comet::`` operator nodes, as many as the
   forward launches) and saved, the weights saved as a ``.pt`` file; a
   fresh process (``chip_smoke.py --serve DIR``, which must not import
   ``comet_tpu_torch.models``) loads each artifact, restores the weights
   with ``params_from_file`` and answers 3 requests per route (the chain:
   2 calls), counting launches; its outputs must equal the eager model's
   on the same inputs bit for bit (the chain: tracks bit for bit,
   encodings within WINDOWED_ULPS ulps) and its launches per call the
   eager counts; export, save and load times, artifact bytes and the
   served against the eager median request are printed; and
12. distributed (``comet_tpu_torch/parallel``) on the one card, where NCCL
   takes one rank only: (a) NCCL at world size 1 through the production
   path (``init_distributed``, ``make_mesh(n_data=1)``,
   ``replicate_train_state``, ``fit_epoch(mesh=)``, 2 steps) against
   ``fit_epoch(mesh=None)`` from the same starting copy on the same
   sequences: camera parameters, losses and launches per step equal bit for
   bit; then two ranks on card 0 over gloo, the backend named explicitly,
   started as ``chip_smoke.py --dist RANK PORT DIR`` (which first probe
   which gloo collectives take CUDA tensors of f32 and bf16, and fail the
   phase, printing the probe, where one is missing):
   (b) data parallelism, each rank a batch of one of the full-width model
   from seed 0 through DDP for 2 steps, against this process running the
   same two halves with gradients (g0 + g1) / 2: the losses equal, every
   tensor ``camera_only_mask`` selects bit for bit (else within
   ``DIST_FALLBACK`` of the summed learning rates, printed as a miss), every
   other tensor unchanged, and the gradient bytes reduced per step and a gloo
   all-reduce of them timed; (c) tensor parallelism, phase 4's modules and
   inputs under ``shard_params_tp`` on a (data 1, model 2) mesh against the
   replicated modules on the card, each route, within ``REF_RTOL``: K1 at
   the local head count (4 of 8; the ViT's gathered 12), K2 and K4 at their
   whole widths with gathered weights, each rank's parameter bytes against
   the replicated model's; (d) ``evaluate(mesh=)`` over the eval phase's 4
   sequences with a callable keypoint backend, the merged averages within
   ``EVAL_RTOL`` of one process's ``evaluate(eval_batch=2)`` and each
   rank's scenes its own. The phase's time and launches are printed, and
   each kernel's record carries its phase-12 launches.

The script prints its total time; the line before the last holds the
kernels' JSON record, and the last line
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
from collections import Counter
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
# the TPU A/B tool tools/micro_lane_packing.py's shape (B, L, C, H = 512,
# 16, 384, 8; hidden 4C): K2's function in a lane-packed layout, timed as K2
K2_TOOL_SHAPES = [("lane-packing tool", 512, 16, 384, 8, 1536, 0)]
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
# K1's A/B softmax forms against their own plain versions on the same bf16
# inputs (the forms' casts): K1's atol plus one bf16 step of the output
# (2^-7 |y|). The kernel rounds at other points than the whole-row form
# (unnormalized bf16 weights, divided at the end; bf16e's exponent in bf16
# pairs from an online maximum), which can move an output to the next bf16
# value: at Lk 1 the plain nomax weight is exactly 1 and the kernel's is
# bf16(e) / e, one step (0.03125) at |y| in [4, 8).
FORM_ATOL, FORM_RTOL = 3e-2, 2.0 ** -7
# the TPU tool's shapes (where, B, Lq, Lk, C, heads), and the edge shapes of
# K1's tilings at the forms' head dimensions (64: 12 heads, 96: 8 heads)
FORM_SHAPES = [("vit self", 16, 581, 581, 768, 12), ("agg self", 16, 578, 578, 768, 8)]
FORM_EDGE = [(2, 577, lk, 768, h) for lk in (1, 63, 65, 577) for h in (12, 8)]
FORMS = ("nomax", "bf16e")
# the eval phase: sequences, and a metric row at batch 2 against batch 1:
# the same sequence through bf16 at another batch shape rounds elsewhere
# (cuBLAS picks other products, K2 another cluster split at coarse virtual),
# and with random weights the trackers amplify a rounding chaotically (as in
# the reference check), so rows agree only loosely: measured on the H100,
# loss and R_avg within 0.5 %, the translation RMSEs within 12 %, the
# fractions within 0.0625. A batching fault (rows of two sequences mixed, a
# sequence's gt on another's poses) moves a row by its whole size.
EVAL_SEQUENCES = 4
EVAL_RTOL, EVAL_ATOL = 0.25, 0.1
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
# the train step (phase 8) differentiates K1 at the camera's shapes on both
# routes and, on FUSED_ROUTE, K5 at the camera's LayerNorms; the tracker and
# the ViT run their kernels under no_grad
K1_TRAIN = ("aggregator self", "aggregator cross to frame 0", "trajectory cross", "trunk self")
K5_TRAIN = ("camera input norm", "aggregator self blocks", "aggregator cross norm1, norm2",
            "aggregator cross norm_context", "trajectory encoder ln1",
            "trajectory encoder ln2, T_P norm_context", "T_P cross norm1, norm2, trunk")
TRAIN_STEPS = 3
# the camera predictor's gradients, bf16 on the card against f32 on the CPU:
# each tensor's |difference| / |f32 gradient|. PyTorch's own bf16 of the same
# backward on the CPU differs by 1.6 % (median) to 2.2 % (largest) at these
# inputs, a wrong or missing backward path by the gradient's whole size. A
# tensor's norm is floored at 1e-4 of the largest tensor's: the
# confidence-attention MLP's f32 gradient is ~1e-8 (the context LayerNorm
# undoes its per-track scale), so its bf16 rounding, 1e-6 of the largest
# norm, has no norm of its own to be measured against.
GRAD_RTOL = 0.1
GRAD_FLOOR = 1e-4


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


def _host_columns(torch, wrapper, launch):
    """Host us to issue one call: of the kernel's wrapper, which calls its
    ``comet::`` operator (grad mode on, as the train step; under
    ``torch.inference_mode``, as a request and the served program, which skip
    the autograd dispatch), and of the direct launch function the operator's
    CUDA implementation runs (the wrapper before the operators, less its
    device test)."""
    host_us = _host_us(torch, wrapper)
    with torch.inference_mode():
        inference_host_us = _host_us(torch, wrapper)
    return dict(host_us=host_us, inference_host_us=inference_host_us,
                launch_host_us=_host_us(torch, launch))


def _host_text(r):
    return (f"host us {r['host_us']:.1f} (inference mode {r['inference_host_us']:.1f}, direct "
            f"launch {r['launch_host_us']:.1f})")


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
        host = _host_columns(torch, lambda: attn.fused_attention(q, k, v, h),
                             lambda: attn.k1_launch(q, k, v, h, d ** -0.5, "base"))
        plain_ms = _median_ms(torch, lambda: attn.attention_reference(q, k, v, h, d ** -0.5))
        q4, k4, v4 = (t.view(b, t.shape[1], h, d).transpose(1, 2) for t in (q, k, v))
        library_ms = _median_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4))
        library_host_us = _host_us(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4))
        flops = 4 * b * h * lq * lk * d
        nbytes = 2 * (2 * b * lq * c + 2 * b * lk * c)  # q, k, v read once, out written once
        bound, bound_by = _bound_ms(flops, nbytes)
        rows.append(dict(kernel="K1", where=where, shape=[b, lq, lk, c, h],
                         max_abs_err=err, tolerance=f"atol {K1_ATOL}", ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, **host,
                         library_host_us=library_host_us, bound_ms=bound, bound_by=bound_by,
                         flops=flops, bytes=nbytes))
        print(f"K1 {where:32s} [B={b} Lq={lq} Lk={lk} C={c} H={h}] err {err:.3e} (atol {K1_ATOL}) "
              f"ms {ms:.4f} plain {plain_ms:.4f} sdpa {library_ms:.4f} bound {bound:.5f} ({bound_by}) "
              f"{_host_text(host)} (sdpa {library_host_us:.1f})",
              flush=True)
    return rows


def check_k1_forms(torch, F, attn, dev):
    """K1's nomax and bf16e forms at the TPU tool's shapes (timed beside K1,
    the plain version and SDPA) and at K1's edge shapes (correctness only),
    each against its own plain version on the same bf16 inputs. The inputs
    come from a generator of their own, so the other checks draw the inputs
    they drew before the forms were added."""
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = []
    shapes = [(where, b, lq, lk, c, h, True) for where, b, lq, lk, c, h in FORM_SHAPES]
    shapes += [("edge", b, lq, lk, c, h, False) for b, lq, lk, c, h in FORM_EDGE]
    for where, b, lq, lk, c, h, timed in shapes:
        d = c // h
        q, k, v = (torch.randn(b, n, c, generator=gen, device=dev).bfloat16() for n in (lq, lk, lk))
        k1_ms = _median_ms(torch, lambda: attn.fused_attention(q, k, v, h)) if timed else None
        for form in FORMS:
            out = attn.fused_attention(q, k, v, h, softmax=form)
            torch.cuda.synchronize()
            want = attn.attention_form_reference(q, k, v, h, d ** -0.5, form).float()
            err = (out.float() - want).abs().max().item()
            excess = ((out.float() - want).abs() - FORM_RTOL * want.abs()).max().item()
            if out.shape != (b, lq, c) or not math.isfinite(err) or excess > FORM_ATOL:
                raise SmokeError(f"K1 {form} {where} {(b, lq, lk, c, h)}: |kernel - plain| "
                                 f"exceeds {FORM_ATOL} + {FORM_RTOL}|y| by {excess}")
            if not timed:
                print(f"K1 {form} edge [B={b} Lq={lq} Lk={lk} C={c} H={h}]: err {err:.3e} "
                      f"(atol {FORM_ATOL} + {FORM_RTOL:.4f}|y|, excess {excess:.3e})", flush=True)
                continue
            ms = _median_ms(torch, lambda: attn.fused_attention(q, k, v, h, softmax=form))
            host_us = _host_us(torch, lambda: attn.fused_attention(q, k, v, h, softmax=form))
            plain_ms = _median_ms(
                torch, lambda: attn.attention_form_reference(q, k, v, h, d ** -0.5, form))
            q4, k4, v4 = (t.view(b, t.shape[1], h, d).transpose(1, 2) for t in (q, k, v))
            library_ms = _median_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4))
            flops = 4 * b * h * lq * lk * d
            nbytes = 2 * (2 * b * lq * c + 2 * b * lk * c)
            bound, bound_by = _bound_ms(flops, nbytes)
            rows.append(dict(kernel="K1", form=form, where=where, shape=[b, lq, lk, c, h],
                             max_abs_err=err,
                             tolerance=f"atol {FORM_ATOL} + {FORM_RTOL} |y| against its plain form",
                             ms=ms, k1_ms=k1_ms, plain_ms=plain_ms, library_ms=library_ms,
                             host_us=host_us, library_host_us=None, bound_ms=bound,
                             bound_by=bound_by, flops=flops, bytes=nbytes))
            print(f"K1 {form} {where:27s} [B={b} Lq={lq} Lk={lk} C={c} H={h}] err {err:.3e} "
                  f"(atol {FORM_ATOL} + {FORM_RTOL:.4f}|y|, excess {excess:.3e}) ms {ms:.4f} "
                  f"K1 {k1_ms:.4f} plain {plain_ms:.4f} "
                  f"sdpa {library_ms:.4f} bound {bound:.5f} ({bound_by}) host us {host_us:.1f}",
                  flush=True)
    return rows


def check_k2(torch, block, dev, gen, shapes=K2_SHAPES):
    rows = []
    for where, b, l, c, h, hid, calls in shapes:
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
        host = _host_columns(torch, lambda: block.fused_attn_block(x, *w, h),
                             lambda: block.block_launch(x, *w, h))
        plain_ms = _median_ms(torch, lambda: block.block_reference(x, *w, h))
        rows_ = b * l
        flops = rows_ * 2 * c * (3 * c + c + 2 * hid) + 4 * rows_ * l * c
        nbytes = 2 * (2 * rows_ * c + 4 * c * c + 2 * c * hid + 4 * c + hid + c)
        bound, bound_by = _bound_ms(flops, nbytes)
        split = block.block_split(rows_, hid, torch.cuda.get_device_properties(dev).multi_processor_count)
        _print_k2_cycles(torch, block, where, split, x, w, h, dev)
        rows.append(dict(kernel="K2", where=where, shape=[b, l, c, h, hid],
                         max_abs_err=err, tolerance=f"atol {K2_ATOL} + {K2_RTOL} |y|",
                         ms=ms, plain_ms=plain_ms, library_ms=None, **host,
                         library_host_us=None, bound_ms=bound,
                         bound_by=bound_by, flops=flops, bytes=nbytes))
        print(f"K2 {where:32s} [B={b} L={l} C={c} H={h} hidden={hid}] err {err:.3e} "
              f"(plain bf16 {plain_err:.3e}; atol {K2_ATOL} + {K2_RTOL:.4f}|y|, excess {excess:.3e}) "
              f"ms {ms:.4f} plain {plain_ms:.4f} bound {bound:.5f} ({bound_by}) {_host_text(host)}",
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
        host = _host_columns(torch, lambda: attn.short_attention(q, k, v, h),
                             lambda: attn.short_launch(q, k, v, h, d ** -0.5))
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
                         library_ms=library_ms, **host,
                         library_host_us=library_host_us, bound_ms=bound, bound_by=bound_by,
                         floor_ms=floor_ms, copy_ms=copy_ms, flops=flops, bytes=nbytes))
        print(f"K3 {where:32s} [B={b} L={l} C={c} H={h}] err {err:.3e} (atol {K1_ATOL}) "
              f"ms {ms:.4f} plain {plain_ms:.4f} sdpa {library_ms:.4f} bound {bound:.5f} ({bound_by}) "
              f"floor {floor_ms:.4f} copy {copy_ms:.4f} {_host_text(host)} "
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
        host = _host_columns(torch, lambda: block.fused_cross_block(x, ctx, *w, h),
                             lambda: block.cross_launch(x, ctx, *w, h))
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
                         ms=ms, plain_ms=plain_ms, library_ms=None, **host,
                         library_host_us=None, bound_ms=bound,
                         bound_by=bound_by, flops=flops, bytes=nbytes))
        print(f"K4 {where:32s} [B={b} Lq={lq} Lk={lk} C={c} H={h} hidden={hid}] err {err:.3e} "
              f"(plain bf16 {plain_err:.3e}; atol {K2_ATOL} + {K2_RTOL:.4f}|y|, excess {excess:.3e}) "
              f"ms {ms:.4f} plain {plain_ms:.4f} bound {bound:.5f} ({bound_by}) {_host_text(host)}",
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
        host = _host_columns(torch, lambda: norm.fused_layer_norm(x, s, b),
                             lambda: norm.launch(x, s, b, 1e-6))
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
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms, **host,
                         library_host_us=library_host_us, bound_ms=bound,
                         bound_by=bound_by, floor_ms=floor_ms, copy_ms=copy_ms, flops=flops,
                         bytes=nbytes))
        print(f"K5 {where:42s} [rows={r} C={c} affine={affine}] err {err:.3e} "
              f"(atol {K5_ATOL} + {K5_RTOL:.4f}|y|, excess {excess:.3e}) ms {ms:.4f} "
              f"plain {plain_ms:.4f} F.layer_norm {library_ms:.4f} bound {bound:.5f} ({bound_by}) "
              f"floor {floor_ms:.4f} copy {copy_ms:.4f} "
              f"{_host_text(host)} (F.layer_norm {library_host_us:.1f})",
              flush=True)
    return rows


def decorator_probe(torch, norm, dev):
    """The host cost of the other registration form: K5's launch registered
    through the ``torch.library.custom_op`` decorator (namespace
    ``comet_probe``, this check only) against the ``comet::layer_norm``
    operator's wrapper, at the camera input norm's shape, with grad mode on
    and under inference mode."""
    @torch.library.custom_op("comet_probe::layer_norm", mutates_args=(),
                             schema="(Tensor x, Tensor? scale, Tensor? bias, float eps) -> Tensor")
    def probe(x, scale, bias, eps):
        return norm.launch(x, scale, bias, eps)

    probe.register_fake(lambda x, scale, bias, eps: x.new_empty(x.shape))
    x = torch.randn(16 * 576, 768, device=dev).bfloat16()
    if not torch.equal(probe(x, None, None, 1e-6), norm.fused_layer_norm(x)):
        raise SmokeError("the decorator-registered K5 differs from comet::layer_norm")
    got = {}
    for form, fn in (("decorator", lambda: probe(x, None, None, 1e-6)),
                     ("comet::", lambda: norm.fused_layer_norm(x))):
        got[form] = _host_us(torch, fn)
        with torch.inference_mode():
            got[form + " inference"] = _host_us(torch, fn)
    print(f"K5 registration forms, host us per call [rows=9216 C=768]: "
          f"{ {k: round(v, 1) for k, v in got.items()} }", flush=True)
    return got


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
        if hasattr(fn, "form_launches"):
            fn.form_launches.clear()


def _launches(counters):
    return {name: fn.launches for name, fn in counters.items()}


def _reference_cases(torch, model):
    """The reference check's small inputs: (where, module path, args), drawn
    from one CPU generator of seed 11."""
    gen = torch.Generator().manual_seed(11)
    coarse_in = model.coarse_tracker.updateformer.input_transform.in_features
    fine_in = model.fine_tracker.updateformer.input_transform.in_features
    return [
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


def reference_check(torch, tcfg, models, model, dev, counters):
    """The main path's modules at full width on small inputs: on the card in
    bf16 (through the kernels) against the same weights in f32 on the CPU
    (plain versions), within REF_RTOL of the reference's largest value, on
    both routes. Returns the CPU model."""
    cpu = models.build_comet(tcfg.get_config("ours").replace(compute_dtype="float32"),
                             device="cpu", seed=0)
    cases = _reference_cases(torch, model)
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
    return cpu


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


def bench_phase(torch, tcfg, bench_lib, attn, counters, smi, runs):
    """run_benchmark on the default route, then run_softmax_variants; the
    counts are set to 0 before each and read after it."""
    _reset(counters)
    result = bench_lib.run_benchmark(tcfg.get_config("ours"))
    used = _launches(counters)
    print(f"bench: run_benchmark launches {used}, on {smi}", flush=True)
    print(json.dumps(result), flush=True)
    print(f"bench: run_benchmark times a model cast to bf16 once: {result['ms_per_sequence']} ms "
          f"per sequence on the host clock, {result['device_ms_per_sequence']} between CUDA "
          f"events; the main path's model keeps f32 masters, cast at every use: median request "
          f"{runs['default']['median_ms']:.1f} ms (default route), "
          f"{runs['fused']['median_ms']:.1f} ms (FUSED_ROUTE)", flush=True)
    if used["K1"] == 0 or used["K2"] == 0:
        raise SmokeError(f"run_benchmark never launched K1 or K2: {used}")
    if not (result["value"] > 0 and result["device_ms_per_sequence"] > 0):
        raise SmokeError(f"run_benchmark: {result}")
    _reset(counters)
    variants = bench_lib.run_softmax_variants()
    forms = dict(attn.fused_attention.form_launches)
    print(f"bench: run_softmax_variants launches K1 {attn.fused_attention.launches}, forms "
          f"{forms}", flush=True)
    for _, b, lq, lk, c, h in bench_lib.SOFTMAX_SHAPES:
        for form in FORMS:
            if not forms.get((form, b, lq, lk, c, h)):
                raise SmokeError(f"run_softmax_variants never launched {form} at {(b, lq, lk, c, h)}")
    if attn.fused_attention.launches == 0:
        raise SmokeError("run_softmax_variants never launched K1")
    for r in variants:
        for form, v in r["forms"].items():
            if not (math.isfinite(v["max_abs_err"]) and v["ms"] > 0):
                raise SmokeError(f"run_softmax_variants {r['name']} {form}: {v}")
    return result, variants, forms


def make_sequences(np, data, geom, cfg, n, seed=0):
    """n sequences made in memory from a seed: uint8 frames of 480 x 640 (a
    textured square that moves against black, as the repository's fixtures
    draw it), the frame-0 mask, the poses of a smooth orbit and the
    sequence's crop square."""
    rng = np.random.default_rng(seed)
    intr = geom.INTRINSICS_TABLE[cfg.dataset]
    h, w, s = 480, 640, cfg.seqlen
    seqs = []
    for i in range(n):
        t0 = np.array([0.1, -0.05, 6.0]) + rng.normal(0, 0.2, 3) * [1, 1, 0]
        q = rng.normal(size=(s, 4)) * 0.05 + [1.0, 0.0, 0.0, 0.0]
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        t = t0 + np.outer(np.arange(s), [0.01, 0.005, 0.02])
        u = intr.fx * t[:, 0] / t[:, 2] + intr.cx
        v = intr.fy * t[:, 1] / t[:, 2] + intr.cy
        frames = np.zeros((s, h, w, 3), np.uint8)
        masks = np.zeros((s, h, w), np.uint8)
        for f in range(s):
            y0, y1 = int(max(0, v[f] - 60)), int(min(h, v[f] + 60))
            x0, x1 = int(max(0, u[f] - 60)), int(min(w, u[f] + 60))
            frames[f, y0:y1, x0:x1] = rng.integers(60, 255, size=(y1 - y0, x1 - x0, 3))
            masks[f, y0:y1, x0:x1] = 255
        square, ratio = data.datasets.compute_sequence_square(
            [data.datasets.mask_bbox(m) for m in masks], cfg.img_size)
        seqs.append(dict(frames=frames, mask0=masks[0], square=square.astype(np.float32),
                         ratio=ratio, q=q.astype(np.float32), t=t.astype(np.float32),
                         uvz=np.stack([u, v, t[:, 2]], -1).astype(np.float32),
                         name=f"memory/seq_{i}"))
    return seqs


class InMemorySequences:
    """A dataset of ``evaluate`` over sequences of :func:`make_sequences`:
    ``dataset[i]`` crops and resizes the frames on the card with
    ``data.preprocess_frames`` (Lanczos) and seeds nothing itself."""

    def __init__(self, torch, np, data, cfg, dev, seqs):
        self.torch, self.np, self.data = torch, np, data
        self.cfg, self.dev, self.seqs = cfg, dev, seqs

    def __len__(self):
        return len(self.seqs)

    def __getitem__(self, index):
        r = self.seqs[index]
        images = self.data.preprocess_frames(self.torch.from_numpy(r["frames"]).to(self.dev),
                                             r["square"], self.cfg.img_size, "lanczos")
        mask = self.data.device_pipeline._host_nearest_mask(r["mask0"], r["square"],
                                                           self.cfg.img_size)
        return self.data.SequenceSample(
            images=images, t_xyz=r["t"], q_wxyz=r["q"], t_uvz=r["uvz"],
            r_matrix=self.np.zeros((len(r["q"]), 3, 3), self.np.float32), ratio=float(r["ratio"]),
            seq_name=r["name"], image_names=[], first_mask=mask)


def eval_phase(torch, np, cfg, model, data, loop_mod, geom, counters, dev, smi):
    """evaluate() at full width over the in-memory sequences, at eval_batch 1
    and 2, with the checks of the module's docstring."""
    t0 = time.perf_counter()
    raw = make_sequences(np, data, geom, cfg, EVAL_SEQUENCES)
    print(f"eval: {EVAL_SEQUENCES} sequences of {cfg.seqlen} frames of 480 x 640 made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    seqs = InMemorySequences(torch, np, data, cfg, dev, raw)
    one = [InMemorySequences(torch, np, data, cfg, dev, [r]) for r in raw]
    r = raw[0]
    for resample in ("bilinear", "lanczos"):
        card = data.preprocess_frames(torch.from_numpy(r["frames"]).to(dev), r["square"],
                                      cfg.img_size, resample).cpu()
        cpu = data.preprocess_frames(torch.from_numpy(r["frames"]), r["square"], cfg.img_size,
                                     resample)
        err = (card - cpu).abs().max().item()
        print(f"eval: preprocess_frames {resample} on the card against the CPU in f32: max |diff| "
              f"{err:.3e} (atol 1e-5)", flush=True)
        if card.shape != (cfg.seqlen, cfg.img_size, cfg.img_size, 3) or not err <= 1e-5:
            raise SmokeError(f"preprocess_frames {resample}: card and CPU differ by {err}")
    quiet = dict(keypoint_backend="grid", print_fn=lambda *a: None)
    # the metric block's keys, from a step output of identity poses
    s = cfg.seqlen
    ident = np.tile(np.float32([0, 0, 0, 1, 0, 0, 0]), (1, s, 1))
    block_keys = set(loop_mod.metric_block(
        dict(pred_q=ident[..., 3:], pred_t=ident[..., :3], pred_pose_enc=ident,
             gt_pose_enc=ident[0], loss=0.0, loss_trans=0.0, loss_rot=0.0),
        geom.make_camera_set(ident[0, :, 3:], ident[0, :, :3])))
    results = {}
    for eval_batch in (1, 2):
        evaluate_kw = dict(quiet, eval_batch=eval_batch)
        loop_mod.evaluate(model, one[0], cfg, **evaluate_kw)  # warm
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        avg = loop_mod.evaluate(model, seqs, cfg, **evaluate_kw)
        seconds = time.perf_counter() - t0
        used = _launches(counters)
        forwards = -(-EVAL_SEQUENCES // eval_batch)
        want = {k: v * forwards for k, v in PER_FORWARD["default"].items()}
        rows = [loop_mod.evaluate(model, ds, cfg, **evaluate_kw) for ds in one]
        results[eval_batch] = dict(avg=avg, rows=rows, seconds=seconds, launches=used)
        print(f"eval, eval_batch {eval_batch}: {EVAL_SEQUENCES} sequences in {seconds:.2f} s = "
              f"{EVAL_SEQUENCES / seconds:.2f} sequences/s on {smi}; launches {used} "
              f"({forwards} forwards); R_avg {avg['R_avg']:.4f} T_avg {avg['T_avg']:.4f} "
              f"Auc_30 {avg['Auc_30']:.4f} loss {avg['loss']:.4f}", flush=True)
        if used != want:
            raise SmokeError(f"eval_batch {eval_batch}: launches {used}, want {want}")
        scenes = {k for k in avg if k.startswith("Auc_scene_")}
        if set(avg) - scenes - {"sec/it"} != block_keys or len(scenes) != EVAL_SEQUENCES:
            raise SmokeError(f"eval_batch {eval_batch}: keys {sorted(avg)}, want the metric "
                             f"block's {sorted(block_keys)} and {EVAL_SEQUENCES} scenes")
        bad = [k for k, v in avg.items() if not math.isfinite(v)]
        bad += [k for row in rows for k, v in row.items() if not math.isfinite(v)]
        if bad:
            raise SmokeError(f"eval_batch {eval_batch}: metrics not finite: {bad}")
    gaps = {}
    for one, two in zip(results[1]["rows"], results[2]["rows"]):
        for k in sorted(set(one) - {"sec/it"}):
            label = "Auc_scene" if k.startswith("Auc_scene_") else k
            gaps[label] = max(gaps.get(label, 0.0), abs(one[k] - two[k]))
    print(f"eval: largest |row at eval_batch 2 - row at eval_batch 1| over the sequences, by "
          f"key: {json.dumps({k: float(f'{v:.3e}') for k, v in gaps.items()})}", flush=True)
    worst = 0.0
    for i, (one, two) in enumerate(zip(results[1]["rows"], results[2]["rows"])):
        for k in sorted(set(one) - {"sec/it"}):
            gap = abs(one[k] - two[k]) - EVAL_RTOL * abs(one[k])
            worst = max(worst, gap)
            if gap > EVAL_ATOL:
                raise SmokeError(f"eval sequence {i} {k}: {one[k]} at batch 1, {two[k]} at batch 2")
    print(f"eval: each sequence's row at eval_batch 2 within {EVAL_ATOL} + {EVAL_RTOL}|x| of "
          f"eval_batch 1 (largest excess {worst:.3e})", flush=True)
    return results


def check_backward(torch, F, attn, norm, dev):
    """The Functions' gradients at the train step's shapes (K1 at the
    camera's four shapes, K5 at the camera's norms) against the plain
    version's autograd on the same bf16 inputs and cotangent, bit for bit:
    the Function's backward is that computation. Each timed as forward +
    backward beside the plain version's and the library call's."""
    gen = torch.Generator(device=dev).manual_seed(7)  # its own: the other checks draw as before
    rows = []

    def rnd(*shape, grad=True):
        t = torch.randn(*shape, generator=gen, device=dev).bfloat16()
        return t.requires_grad_() if grad else t

    def record(kernel, where, shape, kernel_fn, plain_fn, library_fn, leaves, g, flops, nbytes,
               peak):
        got = torch.autograd.grad(kernel_fn(), leaves, g)
        want = torch.autograd.grad(plain_fn(), leaves, g)
        if not all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(got, want)):
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            raise SmokeError(f"{kernel} backward {where}: the Function's gradients differ from "
                             f"the plain version's autograd by {err}")
        ms = _median_ms(torch, lambda: torch.autograd.grad(kernel_fn(), leaves, g))
        plain_ms = _median_ms(torch, lambda: torch.autograd.grad(plain_fn(), leaves, g))
        library_ms = _median_ms(torch, library_fn)
        bound, bound_by = _bound_ms(flops, nbytes, peak)
        rows.append(dict(kernel=kernel, where=where, shape=shape, max_abs_err=0.0,
                         tolerance="torch.equal", ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound, bound_by=bound_by, flops=flops, bytes=nbytes))
        print(f"{kernel} backward {where:34s} {shape} gradients equal the plain version's "
              f"autograd; forward + backward ms {ms:.4f} plain {plain_ms:.4f} library "
              f"{library_ms:.4f} bound {bound:.5f} ({bound_by})", flush=True)

    for where, b, lq, lk, c, h, packed, _, _ in K1_SHAPES:
        if where not in K1_TRAIN:
            continue
        d = c // h
        if packed:  # q, k, v column slices of one qkv projection, as in the model
            leaves = [rnd(b, lq, 3 * c)]
            split = lambda leaves=leaves: leaves[0].split(c, dim=-1)  # noqa: E731
        else:
            leaves = [rnd(b, lq, c), rnd(b, lk, 2 * c)]
            split = lambda leaves=leaves: (leaves[0], *leaves[1].split(c, dim=-1))  # noqa: E731
        g = rnd(b, lq, c, grad=False)
        g4 = g.view(b, lq, h, d).transpose(1, 2)

        def library(split=split, leaves=leaves, g4=g4, b=b, h=h, d=d):
            q4, k4, v4 = (t.view(b, t.shape[1], h, d).transpose(1, 2) for t in split())
            return torch.autograd.grad(F.scaled_dot_product_attention(q4, k4, v4), leaves, g4)

        # forward and backward as FlashAttention-2 counts them: 2 + 5 products;
        # q, k, v and g read once, o, dq, dk and dv written once
        record("K1", where, [b, lq, lk, c, h],
               lambda split=split, h=h: attn.fused_attention(*split(), h),
               lambda split=split, h=h, d=d: attn.attention_reference(*split(), h, d ** -0.5),
               library, leaves, g, 14 * b * h * lq * lk * d, 2 * 4 * (b * lq * c + b * lk * c),
               PEAK_BF16_FLOPS)
    for where, r, c, affine, _ in K5_SHAPES:
        if where not in K5_TRAIN:
            continue
        x = ((torch.randn(r, c, generator=gen, device=dev) * 3 + 1).bfloat16().requires_grad_())
        s, bias = ((torch.randn(c, generator=gen, device=dev).requires_grad_() for _ in range(2))
                   if affine else (None, None))
        leaves = [x, s, bias] if affine else [x]
        g = rnd(r, c, grad=False)
        lib = [x] + ([t.detach().bfloat16().requires_grad_() for t in (s, bias)] if affine else [])

        def library(lib=lib, c=c, g=g):
            return torch.autograd.grad(
                F.layer_norm(lib[0], (c,), *(lib[1:] or (None, None)), 1e-6), lib, g)

        # ~20 f32 operations an element forward and backward; x, g in and y,
        # dx out in bf16, the f32 scale and bias in and their gradients out
        record("K5", where, [r, c, "bfloat16", affine],
               lambda x=x, s=s, bias=bias: norm.fused_layer_norm(x, s, bias),
               lambda x=x, s=s, bias=bias: norm.layer_norm_reference(x, s, bias),
               library, leaves, g, 20 * r * c, 8 * r * c + (16 * c if affine else 0),
               PEAK_F32_FLOPS)
    return rows


def gradient_check(torch, tcfg, training, model, cpu, dev):
    """The camera predictor's trainable gradients on the card in bf16 (the
    kernels and their Functions) against the same weights in f32 on the CPU
    (plain versions), on the reference check's small camera inputs and one
    fixed cotangent of the poses, on both routes. Each tensor's relative
    norm difference must be within GRAD_RTOL, its norm floored at
    GRAD_FLOOR of the largest tensor's; no frozen parameter may get a
    gradient."""
    _, path, args = _reference_cases(torch, model)[2]
    cot = torch.randn(1, 2, 7, generator=torch.Generator().manual_seed(12))
    mask = training.camera_only_mask(model)
    names = [n for n, m in mask.items() if m]
    cpu.zero_grad(set_to_none=True)
    (cpu.get_submodule(path)(*args).pred_pose_enc * cot).sum().backward()
    want = {n: p.grad for n, p in cpu.named_parameters() if mask[n]}
    floor = GRAD_FLOOR * max(g.norm().item() for g in want.values())
    floored = sorted(n for n in names if want[n].norm().item() < floor)
    for route_name, route in (("default", tcfg.KernelRoute()), ("fused", tcfg.FUSED_ROUTE)):
        model.set_route(route)
        model.zero_grad(set_to_none=True)
        out = model.get_submodule(path)(*(a.to(dev) for a in args)).pred_pose_enc
        (out * cot.to(dev)).sum().backward()
        params = dict(model.named_parameters())
        stray = [n for n, p in params.items() if not mask[n] and p.grad is not None]
        if stray:
            raise SmokeError(f"gradient check {route_name}: frozen parameters got gradients: "
                             f"{stray[:4]}")
        rel = {}
        for n in names:
            g = params[n].grad
            if g is None or not torch.isfinite(g).all():
                raise SmokeError(f"gradient check {route_name}: {n} has no finite gradient")
            rel[n] = ((g.cpu() - want[n]).norm().item() / max(want[n].norm().item(), floor))
        worst = sorted(rel.items(), key=lambda kv: -kv[1])
        print(f"gradient check, {route_name} route: {len(names)} trainable tensors, "
              f"|card bf16 - CPU f32| / |CPU f32| largest {worst[0][1]:.3e} ({worst[0][0]}), "
              f"then {worst[1][1]:.3e}, {worst[2][1]:.3e}; median "
              f"{statistics.median(rel.values()):.3e} (limit {GRAD_RTOL}; {len(floored)} tensors "
              f"held at the floor {floor:.3e}: {floored})", flush=True)
        if not worst[0][1] <= GRAD_RTOL:
            raise SmokeError(f"gradient check {route_name}: {worst[0][0]} differs by "
                             f"{worst[0][1]} > {GRAD_RTOL}")
    model.zero_grad(set_to_none=True)
    model.set_route(tcfg.KernelRoute())


def _count_backwards(library, counts):
    """Count each operator backward by kernel and shape (K1: B, Lq, Lk, C;
    K5: rows, C, affine) into ``counts``; returns the undo."""
    plain_vjp = library.plain_vjp

    def counted(name, inputs, needs, grad):
        x = inputs[0]
        if name == "attention":
            counts[("K1", *x.shape[:2], inputs[1].shape[1], x.shape[2])] += 1
        elif name == "layer_norm":
            counts[("K5", x.numel() // x.shape[-1], x.shape[-1], inputs[1] is not None)] += 1
        else:
            counts[(name,)] += 1
        return plain_vjp(name, inputs, needs, grad)

    library.plain_vjp = counted
    return lambda: setattr(library, "plain_vjp", plain_vjp)


def _want_backwards(route_name):
    """The Function backwards of one train step on a route: K1 at the
    camera's shapes, and on FUSED_ROUTE K5 at the camera's norms."""
    calls = -2 if route_name == "default" else -1
    want = {("K1", *r[1:5]): r[calls] for r in K1_SHAPES if r[0] in K1_TRAIN}
    if route_name == "fused":
        want.update({("K5", r, c, affine): n for where, r, c, affine, n in K5_SHAPES
                     if where in K5_TRAIN})
    return want


def train_phase(torch, np, tcfg, geom, training, library, bench_lib, cfg, model, counters,
                dev, smi):
    """TRAIN_STEPS train steps of the full-width model per route, with the
    checks of the module's docstring, the parts of a step timed between CUDA
    events, one profiled step for the device's idle share, then
    run_train_benchmark per route."""
    gt = _train_gt(torch, np, geom, cfg, dev)
    mask = training.camera_only_mask(model)
    results = {}
    for route_name, route in (("default", tcfg.KernelRoute()), ("fused", tcfg.FUSED_ROUTE)):
        model.set_route(route)
        optimizer, scheduler = training.build_optimizer(model, cfg.train.lr, steps_per_epoch=100)
        step = training.build_train_step(model, cfg, optimizer, scheduler)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        requests = [_request(torch, cfg, 200 + i, dev) for i in range(TRAIN_STEPS)]
        backwards = Counter()
        undo = _count_backwards(library, backwards)
        times, parts, losses = [], [], []
        torch.cuda.reset_peak_memory_stats()
        try:
            _reset(counters)
            for i, (images, queries) in enumerate(requests):
                launched, counted = _launches(counters), Counter(backwards)
                events = {"start": torch.cuda.Event(enable_timing=True)}

                def mark(name, events=events):
                    events[name] = torch.cuda.Event(enable_timing=True)
                    events[name].record()

                torch.cuda.synchronize()
                t0 = time.perf_counter()
                events["start"].record()
                aux = step(images, queries, gt, mark=mark)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                parts.append({k: events[a].elapsed_time(events[k]) for a, k in
                              (("start", "forward"), ("forward", "backward"),
                               ("backward", "optimizer"))})
                losses.append(aux["loss"].item())
                launches = {k: v - launched[k] for k, v in _launches(counters).items()}
                bwd = dict(backwards - counted)
                print(f"train, {route_name} route, step {i}: loss {losses[-1]:.4f}, "
                      f"{times[-1]:.1f} ms (forward {parts[-1]['forward']:.1f}, backward "
                      f"{parts[-1]['backward']:.1f}, optimizer {parts[-1]['optimizer']:.1f} ms "
                      f"between events), launches {launches}, Function backwards "
                      f"{sum(bwd.values())}", flush=True)
                if not math.isfinite(losses[-1]):
                    raise SmokeError(f"train {route_name} step {i}: loss {losses[-1]}")
                if launches != PER_FORWARD[route_name]:
                    raise SmokeError(f"train {route_name} step {i}: launches {launches}, want "
                                     f"{PER_FORWARD[route_name]}")
                if bwd != _want_backwards(route_name):
                    raise SmokeError(f"train {route_name} step {i}: Function backwards {bwd}, "
                                     f"want {_want_backwards(route_name)}")
        finally:
            undo()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        unchanged = [n for n, p in model.named_parameters() if mask[n] and torch.equal(p, before[n])]
        moved = [n for n, p in model.named_parameters()
                 if not mask[n] and not torch.equal(p, before[n])]
        if unchanged or moved:
            raise SmokeError(f"train {route_name}: trainable tensors unchanged {unchanged[:4]}, "
                             f"frozen tensors changed {moved[:4]}")
        med = statistics.median(times[1:])
        split = {k: statistics.median(p[k] for p in parts[1:]) for k in parts[0]}
        idle = _profile_step(torch, step, requests[0], gt, med)
        print(f"train, {route_name} route: {TRAIN_STEPS} steps, losses finite, every trainable "
              f"tensor moved and every frozen one bitwise unchanged; median of steps 2-"
              f"{TRAIN_STEPS} {med:.1f} ms (forward {split['forward']:.1f}, backward "
              f"{split['backward']:.1f}, optimizer {split['optimizer']:.1f}), K1 launches per "
              f"step {PER_FORWARD[route_name]['K1']}, peak memory {peak:.2f} GiB, idle share "
              f"{idle['idle']:.2f} (device {idle['device_ms']:.1f} ms in {idle['launches']} "
              f"launches), on {smi}", flush=True)
        results[route_name] = dict(times=times, median_ms=med, parts=split, peak_gib=peak,
                                   backwards=dict(backwards), **idle)
    model.set_route(tcfg.KernelRoute())
    for route_name, route in (("default", tcfg.KernelRoute()), ("fused", tcfg.FUSED_ROUTE)):
        _reset(counters)
        bench = bench_lib.run_train_benchmark(cfg, route=route)
        used = _launches(counters)
        print(f"train bench, {route_name} route: run_train_benchmark launches {used}, on {smi}",
              flush=True)
        print(json.dumps(bench), flush=True)
        if any(used[k] == 0 for k, n in PER_FORWARD[route_name].items() if n):
            raise SmokeError(f"run_train_benchmark {route_name}: a kernel never ran: {used}")
        if not (bench["value"] > 0 and bench["device_ms_per_step"] > 0):
            raise SmokeError(f"run_train_benchmark {route_name}: {bench}")
        results[route_name]["bench"] = bench
    return results


# phase 9: the windowed long-sequence mode. (T, windows) of the forward
# checks and timings, and of the train steps; window_len is seqlen (16).
WINDOWED_T = (48, 64)
WINDOWED_TRAIN_T = 32
# the host loop and the scan form at T 48: encodings within this many f32
# ulps of their largest value (the scan form rewrites each window's frame 0
# with the anchor composed with the identity,
# ratio * ((0 / ratio + 1) * (a / ratio + 1) - 1), which need not round back
# to the anchor a)
WINDOWED_ULPS = 8
FORM_NAMES = {"windowed_forward": "host loop", "windowed_forward_scan": "scan form"}
# phase 10: the CLI's fixtures (frames per sequence)
CLI_AMD_FRAMES, CLI_DCA_FRAMES = 32, 48


# the text of torch's sync debug mode warning for one synchronizing call
SYNC_WARNING = "called a synchronizing CUDA operation"


def _window_count(windowed, total, window_len):
    return len(windowed.window_schedule(total, window_len))


def _sync_count(torch, form, model, *args):
    """Host synchronizations of one call of ``form(apply, *args)``, as torch
    counts them in its sync debug mode (one warning each), where ``apply`` is
    the model: {"in_forwards": n, "own": n, "where": the source lines of
    each kind}."""
    import warnings

    inside = set()

    def synced(caught):  # not torch's warning that the mode is a prototype
        return [i for i, w in enumerate(caught) if SYNC_WARNING in str(w.message)]

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def apply(images, queries):
            before = len(caught)
            out = model(images, queries)
            inside.update(before + i for i in synced(caught[before:]))
            return out

        torch.cuda.set_sync_debug_mode("warn")
        try:
            form(apply, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = {"in_forwards": Counter(), "own": Counter()}
    for i in synced(caught):
        where["in_forwards" if i in inside else "own"][
            f"{Path(caught[i].filename).name}:{caught[i].lineno}"] += 1
    return {k: sum(v.values()) for k, v in where.items()} | {
        "where": {k: dict(v) for k, v in where.items()}}


def _time_call(torch, fn, reps=2):
    """(host ms, device ms between CUDA events) of one call of fn, medians
    over reps after a warm call."""
    fn()
    host, device = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        device.append(start.elapsed_time(end))
    return statistics.median(host), statistics.median(device)


def windowed_phase(torch, np, tcfg, geom, models, windowed, training, library, serialization,
                   cfg, model, counters, dev, smi):
    """Phase 9: the windowed mode at full width on both routes, with the
    checks of the module's docstring."""
    import copy

    L = cfg.seqlen
    ratio = torch.tensor(0.9, device=dev)
    served = serialization.cast_params_for_inference(copy.deepcopy(model), cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(300)
    hw, n = cfg.img_size, cfg.track_num
    longest = max(WINDOWED_T)
    images = torch.randn(1, longest, hw, hw, 3, generator=gen, device=dev)
    queries = torch.rand(1, n, 2, generator=gen, device=dev) * (hw - 20) + 10
    identity = torch.tensor([0, 0, 0, 1, 0, 0, 0], dtype=torch.float32, device=dev)
    rng = np.random.default_rng(8)
    q = rng.normal(size=(L, 4)).astype(np.float32)
    t_uvz = (rng.normal(size=(L, 3)) * 40 + [320.0, 240.0, 0.0]).astype(np.float32)
    t_uvz[:, 2] = np.abs(t_uvz[:, 2]) + 3.0
    cams = geom.make_camera_set(torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True)),
                                torch.zeros(L, 3), t_uvz=torch.from_numpy(t_uvz), ratio=0.9,
                                device=dev)
    results = {}
    for route_name, route in (("default", tcfg.KernelRoute()), ("fused", tcfg.FUSED_ROUTE)):
        served.set_route(route)
        per_forward = PER_FORWARD[route_name]
        r = results[route_name] = {}
        with torch.inference_mode():
            # (a) one window of seqlen frames is the plain forward
            one = images[:, :L]
            direct = served(one, queries)
            again = served(one, queries)
            deterministic = all(torch.equal(direct[k], again[k]) for k in direct)
            print(f"windowed, {route_name} route: two forwards of the same request are "
                  f"{'bit for bit equal' if deterministic else 'not equal'}", flush=True)
            if not deterministic:
                raise SmokeError(f"windowed {route_name}: the forward is not deterministic; "
                                 "hold the two forms to a stated tolerance with its cause")
            enc1, trk1 = windowed.windowed_forward(served, one, queries, L, ratio)
            d_enc = (enc1 - direct["pred_pose_enc"].float()).abs().max().item()
            d_trk = (trk1[:, 1:] - direct["pred_track"][:, 1:].float()).abs().max().item()
            dec_w = models.decode_predictions(cfg, enc1[0], cams)
            dec_f = models.decode_predictions(cfg, direct["pred_pose_enc"][0].float(), cams)
            d_dec = max((a - b).abs().max().item() for a, b in zip(dec_w, dec_f))
            ulp = torch.finfo(torch.float32).eps * max(enc1.abs().max().item(), 1.0)
            print(f"windowed, {route_name} route, T {L} = window_len: |windowed - forward| "
                  f"encodings {d_enc:.3e} ({d_enc / ulp:.1f} ulps), decoded poses {d_dec:.3e}, "
                  f"tracks of frames 1.. {d_trk:.3e}, frame 0 tracks the queries", flush=True)
            if (not torch.equal(trk1[:, 0], queries) or d_trk != 0
                    or d_enc > WINDOWED_ULPS * ulp):
                raise SmokeError(f"windowed {route_name}: one window is not the forward "
                                 f"({d_enc}, {d_trk})")

            # (b) host loop and scan form, (c) launches, at T 48
            t = WINDOWED_T[0]
            seq = images[:, :t]
            wins = _window_count(windowed, t, L)
            outs = {}
            for form in ("windowed_forward", "windowed_forward_scan"):
                _reset(counters)
                outs[form] = getattr(windowed, form)(served, seq, queries, L, ratio)
                used = _launches(counters)
                want = {k: v * wins for k, v in per_forward.items()}
                print(f"windowed, {route_name} route, {form}, T {t} ({wins} windows): "
                      f"launches {used}", flush=True)
                if used != want:
                    raise SmokeError(f"windowed {route_name} {form}: launches {used}, want {want}")
            (enc_h, trk_h), (enc_s, trk_s) = outs.values()
            gap = (enc_s - enc_h).abs().max().item()
            ulp = torch.finfo(torch.float32).eps * max(enc_h.abs().max().item(), 1.0)
            tracks_equal = torch.equal(trk_s, trk_h)
            print(f"windowed, {route_name} route, T {t}: scan against host loop: tracks "
                  f"{'bit for bit equal' if tracks_equal else 'differ'} (max |diff| "
                  f"{(trk_s - trk_h).abs().max().item():.3e}), encodings max |diff| {gap:.3e} "
                  f"= {gap / ulp:.1f} ulps of their largest (limit {WINDOWED_ULPS})", flush=True)
            for enc, trk in outs.values():
                if not (torch.isfinite(enc).all() and torch.isfinite(trk).all()):
                    raise SmokeError(f"windowed {route_name}: outputs not finite")
                if not torch.equal(enc[0, 0], identity):
                    raise SmokeError(f"windowed {route_name}: frame 0 is not the identity")
            if not (tracks_equal and gap <= WINDOWED_ULPS * ulp):
                raise SmokeError(f"windowed {route_name}: scan and host loop differ: tracks "
                                 f"equal {tracks_equal}, encodings {gap}")

            # (d) host synchronizations: the scan form's own must be none; the
            # count must see a known one first (a read of a value on the card)
            seen = _sync_count(torch, lambda apply, x: x.sum().item(), None, one)["own"]
            if not seen:
                raise SmokeError(f"windowed {route_name}: the sync count saw no sync in .item()")
            syncs = {"forward": _sync_count(torch, lambda apply, *a: apply(*a), served, one,
                                            queries)}
            for form in outs:
                syncs[form] = _sync_count(torch, getattr(windowed, form), served, seq, queries,
                                          L, ratio)
            print(f"windowed, {route_name} route: host synchronizations per call (sync debug "
                  f"mode): one forward {syncs['forward']}; at {wins} windows the host loop "
                  f"{syncs['windowed_forward']}, the scan form {syncs['windowed_forward_scan']}",
                  flush=True)
            if syncs["windowed_forward_scan"]["own"]:
                raise SmokeError(f"windowed {route_name}: the scan form synchronizes the host "
                                 f"itself: {syncs['windowed_forward_scan']}")
            r["syncs"], r["times"] = syncs, {}
            for t in WINDOWED_T:
                wins = _window_count(windowed, t, L)
                for form in outs:
                    host_ms, device_ms = _time_call(torch, lambda form=form, t=t: getattr(
                        windowed, form)(served, images[:, :t], queries, L, ratio))
                    r["times"][(form, t)] = (host_ms, device_ms)
                    print(f"windowed, {route_name} route, {form}, T {t} ({wins} windows): "
                          f"{host_ms:.1f} ms per sequence on the host clock ({host_ms / t:.2f} "
                          f"per frame, {host_ms / wins:.1f} per window), {device_ms:.1f} between "
                          f"CUDA events, on {smi}", flush=True)
        r["train"] = windowed_train_steps(torch, np, tcfg, geom, windowed, training, library,
                                          cfg, model, route, route_name, counters, dev, smi)
    model.set_route(tcfg.KernelRoute())
    del served
    return results


def windowed_train_steps(torch, np, tcfg, geom, windowed, training, library, cfg, model,
                         route, route_name, counters, dev, smi):
    """Phase 9 (e, f): 3 windowed train steps at T 32 without and 3 with
    teacher forcing, with the checks of the module's docstring; then the
    chain's gradient from a last-window frame to the first window."""
    L, t = cfg.seqlen, WINDOWED_TRAIN_T
    wins = _window_count(windowed, t, L)
    model.set_route(route)
    rng = np.random.default_rng(7)
    q = rng.normal(size=(t, 4)).astype(np.float32)
    t_uvz = (rng.normal(size=(t, 3)) * 40 + [320.0, 240.0, 0.0]).astype(np.float32)
    t_uvz[:, 2] = np.abs(t_uvz[:, 2]) + 3.0
    gt = geom.make_camera_set(torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True)),
                              torch.from_numpy(rng.normal(size=(t, 3)).astype(np.float32)),
                              t_uvz=torch.from_numpy(t_uvz), ratio=0.9, device=dev)
    mask = training.camera_only_mask(model)
    optimizer, scheduler = training.build_optimizer(model, cfg.train.lr, steps_per_epoch=100)
    step = training.build_windowed_train_step(model, cfg, optimizer, scheduler, L)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(400)
    backwards = Counter()
    undo = _count_backwards(library, backwards)
    want_bwd = {k: v * wins for k, v in _want_backwards(route_name).items()}
    times, parts = [], []
    torch.cuda.reset_peak_memory_stats()
    try:
        for i, tf in enumerate([False] * TRAIN_STEPS + [True] * TRAIN_STEPS):
            images = torch.randn(1, t, cfg.img_size, cfg.img_size, 3, generator=gen, device=dev)
            queries = (torch.rand(1, cfg.track_num, 2, generator=gen, device=dev)
                       * (cfg.img_size - 20) + 10)
            events = {"start": torch.cuda.Event(enable_timing=True)}

            def mark(name, events=events):
                events[name] = torch.cuda.Event(enable_timing=True)
                events[name].record()

            _reset(counters)
            counted = Counter(backwards)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events["start"].record()
            aux = step(images, queries, gt, teacher_force=tf, mark=mark)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            parts.append({k: events[a].elapsed_time(events[k]) for a, k in
                          (("start", "forward"), ("forward", "backward"),
                           ("backward", "optimizer"))})
            loss = aux["loss"].item()
            used, bwd = _launches(counters), dict(backwards - counted)
            print(f"windowed train, {route_name} route, step {i} (T {t}, {wins} windows, teacher "
                  f"forcing {tf}): loss {loss:.4f}, {times[-1]:.1f} ms (forward "
                  f"{parts[-1]['forward']:.1f}, backward {parts[-1]['backward']:.1f}, optimizer "
                  f"{parts[-1]['optimizer']:.1f} between events), launches {used}, Function "
                  f"backwards {sum(bwd.values())}", flush=True)
            if not math.isfinite(loss):
                raise SmokeError(f"windowed train {route_name} step {i}: loss {loss}")
            want = {k: v * wins for k, v in PER_FORWARD[route_name].items()}
            if used != want:
                raise SmokeError(f"windowed train {route_name} step {i}: launches {used}, want "
                                 f"{want}")
            if bwd != want_bwd:
                raise SmokeError(f"windowed train {route_name} step {i}: Function backwards "
                                 f"{bwd}, want {want_bwd}")
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    unchanged = [n for n, p in model.named_parameters() if mask[n] and torch.equal(p, before[n])]
    moved = [n for n, p in model.named_parameters()
             if not mask[n] and not torch.equal(p, before[n])]
    if unchanged or moved:
        raise SmokeError(f"windowed train {route_name}: trainable tensors unchanged "
                         f"{unchanged[:4]}, frozen tensors changed {moved[:4]}")
    # the chain is differentiable: a loss on the last frame, which only the
    # last window computes, reaches the first window's outputs through the
    # chained anchors
    outputs = []

    def apply(win_images, win_queries):
        out = model(win_images, win_queries)
        out["pred_pose_enc"].retain_grad()
        outputs.append(out["pred_pose_enc"])
        return out

    enc, _ = windowed.windowed_forward_scan(apply, images, queries, L, gt.ratio)
    enc[0, -1].sum().backward()
    first = outputs[0].grad
    reach = 0.0 if first is None else first.abs().max().item()
    model.zero_grad(set_to_none=True)
    print(f"windowed train, {route_name} route: |d loss(frame {t - 1}) / d window 1's "
          f"encodings| max {reach:.3e} (the loss's frame is in window {len(outputs)} only)",
          flush=True)
    if not reach > 0:
        raise SmokeError(f"windowed train {route_name}: no gradient reaches the first window")
    med = statistics.median(times[1:])
    split = {k: statistics.median(p[k] for p in parts[1:]) for k in parts[0]}
    print(f"windowed train, {route_name} route: {2 * TRAIN_STEPS} steps at T {t} ({wins} "
          f"windows), losses finite, every trainable tensor moved and every frozen one bitwise "
          f"unchanged, Function backwards {wins} x a step's; median of steps 2-"
          f"{2 * TRAIN_STEPS} {med:.1f} ms (forward {split['forward']:.1f}, backward "
          f"{split['backward']:.1f}, optimizer {split['optimizer']:.1f}), peak memory "
          f"{peak:.2f} GiB, on {smi}", flush=True)
    return dict(times=times, median_ms=med, parts=split, peak_gib=peak, reach=reach)


def cli_phase(torch, cfg, counters, smi):
    """Phase 10: the CLI at full width on the card, on fixtures written to a
    temporary directory, with the checks of the module's docstring."""
    import csv
    import os
    import tempfile

    from comet_tpu_torch import cli
    from comet_tpu_torch.data import fixtures
    from comet_tpu_torch.utils.colmap_io import read_model_text
    from comet_tpu_torch.utils.scene_export import parse_glb

    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        amd = os.path.join(tmp, "AMD")
        fixtures.generate_amd_fixture(os.path.join(amd, "AMD_train"), n_seqs=1,
                                      n_frames=CLI_AMD_FRAMES, seed=1)
        fixtures.generate_amd_fixture(os.path.join(amd, "AMD_eval"), n_seqs=2,
                                      n_frames=CLI_AMD_FRAMES, seed=2)
        dca = fixtures.generate_dca_fixture(os.path.join(tmp, "DCA"), n_seqs=1,
                                            n_frames=CLI_DCA_FRAMES, seed=3)
        print(f"cli: fixtures written in {time.perf_counter() - t0:.1f} s (AMD: 1 train and 2 "
              f"eval sequences of {CLI_AMD_FRAMES} frames; DCA: 1 sequence of "
              f"{CLI_DCA_FRAMES})", flush=True)
        out = {name: os.path.join(tmp, "out_" + name) for name in ("eval", "demo", "train")}
        commands = {
            "eval": ["eval", "--data-root", os.path.join(amd, "AMD_eval"), "--device-preprocess",
                     "--eval-batch", "2", "--max-sequences", "2", "--output-dir", out["eval"]],
            "demo": ["demo", "--data-root", dca, "--demo-seq-len", str(CLI_DCA_FRAMES),
                     "--max-sequences", "1", "--output-dir", out["demo"]],
            "train": ["train", "--data-root", amd, "--windowed", "--train-seq-len",
                      str(CLI_AMD_FRAMES), "--epochs", "1", "--eval-interval", "1",
                      "--ckpt-interval", "1", "--max-sequences", "1", "--output-dir", out["train"]],
            "bench": ["bench", "--suite", "infer"],
        }
        for name, argv in commands.items():
            _reset(counters)
            t0 = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            shown = " ".join(a.replace(tmp, "<tmp>") for a in argv)
            print(f"cli: python -m comet_tpu_torch.cli {shown}: {walls[name]:.1f} s wall, "
                  f"launches {_launches(counters)}, on {smi}", flush=True)
            if sum(_launches(counters).values()) == 0:
                raise SmokeError(f"cli {name}: no kernel ran")

        with open(os.path.join(out["eval"], "test_results.csv")) as f:
            rows = list(csv.DictReader(f))
        bad = [k for row in rows for k, v in row.items() if not math.isfinite(float(v))]
        if len(rows) != 1 or bad:
            raise SmokeError(f"cli eval: {len(rows)} rows, not finite: {bad}")
        with open(os.path.join(out["train"], "train_results.csv")) as f:
            rows = list(csv.DictReader(f))
        if len(rows) != 1 or "tf_ratio" not in rows[0] or not math.isfinite(float(rows[0]["loss"])):
            raise SmokeError(f"cli train: rows {rows}")
        ckpt = os.path.join(out["train"], "ckpt")
        missing = [p for p in ("ckpt_000000", "best.pt", "best.json")
                   if not os.path.exists(os.path.join(ckpt, p))]
        (seq,) = [d for d in os.listdir(out["demo"])
                  if os.path.isdir(os.path.join(out["demo"], d)) and not d.endswith("_colmap")]
        base = os.path.join(out["demo"], f"{seq}_scene")
        with open(os.path.join(out["demo"], seq, "metrics", "results.json")) as f:
            trajectory = json.load(f)["trajectory"]
        missing += [p for p in (".glb", ".html") if not os.path.exists(base + p)]
        if missing:
            raise SmokeError(f"cli: missing {missing}")
        gltf, blob = parse_glb(base + ".glb")
        colmap = read_model_text(base + "_colmap")
        if (len(trajectory) != CLI_DCA_FRAMES or len(colmap.images) != CLI_DCA_FRAMES
                or not blob or len(gltf["meshes"]) != 1 + CLI_DCA_FRAMES):
            raise SmokeError(f"cli demo: {len(trajectory)} frames, {len(colmap.images)} COLMAP "
                             f"images, {len(gltf['meshes'])} GLB meshes")
        # optional: cv2's mp4 codec, and matplotlib from the second epoch on
        video = "written" if os.path.exists(base + "_reproj.mp4") else "not written"
        png = os.path.join(out["train"], "train_results.png")
        png = "written" if os.path.exists(png) else "not written (one epoch: the plot starts at two)"
        print(f"cli: CSV rows finite; demo JSON ({len(trajectory)} frames), GLB "
              f"({len(gltf['meshes'])} meshes, read back), HTML and COLMAP model "
              f"({len(colmap.images)} images, {len(colmap.points3d)} points, read back) written; "
              f"train_results.csv with tf_ratio, ckpt/, best.pt and best.json; reprojection "
              f"video {video}; metric PNG {png}", flush=True)
    return walls


# phase 11: serving. The windowed artifact's length (5 windows of seqlen 16),
# and the serving process's time limit (it loads three artifacts)
SERVE_WINDOWED_T = 48
SERVE_TIMEOUT = 1200
# the artifacts: the forward on each route, the windowed chain on the default
SERVED = ("default", "fused", "windowed")
# the comet:: operators by kernel
OPERATORS = dict(attention="K1", attn_block="K2", short_attention="K3", cross_block="K4",
                 layer_norm="K5")


def _kernel_nodes(torch, exported):
    """The exported program's comet:: operator nodes, counted by kernel."""
    found = Counter()
    for gm in exported.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                name = str(node.target)
                if name.startswith("comet."):
                    found[OPERATORS[name.split(".")[1]]] += 1
    return dict(found)


def _counters():
    """Each kernel's wrapper, which holds its launch counts."""
    from comet_tpu_torch.ops import attn, block, norm

    return dict(K1=attn.fused_attention, K2=block.fused_attn_block, K3=attn.short_attention,
                K4=block.fused_cross_block, K5=norm.fused_layer_norm)


def _timed_call(torch, counters, fn, *args):
    """(result, host ms, launches) of one synchronized call."""
    _reset(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, _launches(counters)


def serve_child(directory):
    """``chip_smoke.py --serve DIR``: the serving side of phase 11, run by the
    phase in a fresh process. It imports ``comet_tpu_torch.utils.serving``
    and ``comet_tpu_torch.ops`` (the operators), never the models; loads
    each artifact the phase wrote to DIR, restores the weights with
    ``params_from_file``, answers the requests (the windowed artifact: one
    warm call, one timed), counting the launches of each, saves the
    outputs to DIR and prints its timings as one JSON line."""
    import os

    import torch

    from comet_tpu_torch.utils import serving

    if not torch.cuda.is_available():
        print("chip_smoke --serve: no CUDA device", file=sys.stderr)
        return 2
    counters = _counters()
    inputs = torch.load(os.path.join(directory, "inputs.pt"))
    weights = os.path.join(directory, "weights.pt")
    result = {}
    for route_name in SERVED:
        r = result[route_name] = {}
        t0 = time.perf_counter()
        exported = serving.load_exported(os.path.join(directory, f"{route_name}.pt2"))
        r["load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fn = serving.serving_call(exported)
        params = serving.params_from_file(weights, exported)
        r["call_and_params_s"] = time.perf_counter() - t0
        calls = (inputs["requests"] if route_name != "windowed"
                 else [inputs["windowed"], inputs["windowed"]])
        outs, r["ms"], r["launches"] = [], [], []
        for args in calls:
            out, ms, used = _timed_call(torch, counters, fn, params, *args)
            outs.append(out)
            r["ms"].append(ms)
            r["launches"].append(used)
        torch.save(outs, os.path.join(directory, f"served_{route_name}.pt"))
        del exported, fn, params
    result["imported"] = sorted(m for m in sys.modules if m.startswith("comet_tpu"))
    print(json.dumps(result), flush=True)
    return 0


def _largest_diffs(torch, got, want):
    return {k: (got[k].float() - want[k].float()).abs().max().item() for k in want}


def serving_phase(torch, tcfg, windowed, serialization, serving, cfg, model, counters, dev, smi):
    """Phase 11: serving at full width, with the checks of the module's
    docstring. Returns the timings."""
    import copy
    import os
    import tempfile

    served = serialization.cast_params_for_inference(copy.deepcopy(model), cfg.dtype)
    # frozen, as a server holds its weights: with requires_grad parameters
    # aten.matmul reduces a one-column Linear (the visibility head) in
    # another order than the served graph, whose weights are plain inputs
    served.requires_grad_(False)
    L, t = cfg.seqlen, SERVE_WINDOWED_T
    hw, n = cfg.img_size, cfg.track_num
    requests = [_request(torch, cfg, 400 + i, dev) for i in range(REQUESTS)]
    gen = torch.Generator(device=dev).manual_seed(410)
    long = (torch.randn(1, t, hw, hw, 3, generator=gen, device=dev),
            torch.rand(1, n, 2, generator=gen, device=dev) * (hw - 20) + 10,
            torch.tensor(0.9, device=dev))
    wins = len(windowed.window_schedule(t, L))
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        serialization.save_params(os.path.join(tmp, "weights.pt"), served)
        torch.save({"requests": requests, "windowed": long}, os.path.join(tmp, "inputs.pt"))
        eager = {}
        for route_name in SERVED:
            served.set_route(tcfg.FUSED_ROUTE if route_name == "fused" else tcfg.KernelRoute())
            r = results[route_name] = {}
            per_forward = PER_FORWARD["default" if route_name == "windowed" else route_name]
            r["per_call"] = {k: v * (wins if route_name == "windowed" else 1)
                             for k, v in per_forward.items()}
            t0 = time.perf_counter()
            if route_name == "windowed":
                exported = serving.export_windowed(served, cfg, t, device=dev)
            else:
                exported = serving.export_forward(served, cfg, device=dev)
            r["export_s"] = time.perf_counter() - t0
            nodes = _kernel_nodes(torch, exported)
            r["graph_nodes"] = sum(len(gm.graph.nodes) for gm in exported.graph_module.modules()
                                   if isinstance(gm, torch.fx.GraphModule))
            want = {k: v for k, v in r["per_call"].items() if v}
            if nodes != want:
                raise SmokeError(f"serving {route_name}: the exported graph holds the operators "
                                 f"{nodes}, want {want}")
            t0 = time.perf_counter()
            r["manifest"] = serving.save_exported(
                exported, os.path.join(tmp, f"{route_name}.pt2"), cfg=cfg,
                extra_manifest={"preset": "ours", "route": route_name})
            r["save_s"] = time.perf_counter() - t0
            del exported
            # the eager forward of the same cast model on the same inputs
            with torch.inference_mode():
                calls = requests if route_name != "windowed" else [long, long]
                fn = served if route_name != "windowed" else (
                    lambda im, q, ratio: windowed.windowed_forward_scan(served, im, q, L, ratio))
                runs = [_timed_call(torch, counters, fn, *args) for args in calls]
            eager[route_name] = [out for out, _, _ in runs]
            r["eager_ms"] = [ms for _, ms, _ in runs]
            print(f"serving, {route_name}: exported in {r['export_s']:.1f} s ({r['graph_nodes']} "
                  f"graph nodes, operator nodes {nodes}), saved in {r['save_s']:.1f} s, "
                  f"{r['manifest']['artifact_bytes']} bytes; eager "
                  f"{['%.1f' % ms for ms in r['eager_ms']]} ms, on {smi}", flush=True)

        root = Path(__file__).resolve().parent
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(root / "chip_smoke.py"), "--serve", tmp],
                              cwd=root, capture_output=True, text=True, timeout=SERVE_TIMEOUT,
                              env={**os.environ, "PYTHONPATH": str(root)})
        wall = time.perf_counter() - t0
        if proc.returncode:
            raise SmokeError(f"serving: the serving process failed:\n{proc.stderr[-4000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        if any(m.startswith("comet_tpu_torch.models") for m in child["imported"]):
            raise SmokeError(f"serving: the serving process imported {child['imported']}")
        print(f"serving: a fresh process ({wall:.1f} s) loaded the three artifacts and "
              f"imported {child['imported']}", flush=True)
        for route_name in results:
            r, c = results[route_name], child[route_name]
            got = torch.load(os.path.join(tmp, f"served_{route_name}.pt"))
            if any(used != r["per_call"] for used in c["launches"]):
                raise SmokeError(f"serving {route_name}: launches per served call "
                                 f"{c['launches']}, want {r['per_call']}")
            if route_name == "windowed":
                diffs = [_largest_diffs(torch, dict(enumerate(g)), dict(enumerate(e)))
                         for g, e in zip(got, eager[route_name])]
                enc, trk = eager[route_name][0]
                ulp = torch.finfo(torch.float32).eps * max(enc.abs().max().item(), 1.0)
                ok = all(torch.equal(g[1], e[1]) and (g[0] - e[0]).abs().max().item()
                         <= WINDOWED_ULPS * ulp for g, e in zip(got, eager[route_name]))
                shown = f"encodings, tracks: {diffs} (limit {WINDOWED_ULPS} ulps = " \
                        f"{WINDOWED_ULPS * ulp:.3e}, tracks 0)"
            else:
                diffs = [_largest_diffs(torch, g, e) for g, e in zip(got, eager[route_name])]
                ok = all(torch.equal(g[k], e[k]) for g, e in zip(got, eager[route_name])
                         for k in e)
                shown = f"largest |served - eager| per output {diffs}"
            r.update(served_ms=c["ms"], load_s=c["load_s"], diffs=diffs,
                     launches=c["launches"][-1])
            med = statistics.median(c["ms"][1:])
            eager_med = statistics.median(r["eager_ms"][1:])
            print(f"serving, {route_name}: served {['%.1f' % ms for ms in c['ms']]} ms (median "
                  f"of calls 2.. {med:.1f}) against eager {eager_med:.1f}; artifact loaded in "
                  f"{c['load_s']:.1f} s (+ {c['call_and_params_s']:.1f} s callable and weights); "
                  f"launches per call {c['launches'][-1]}; {shown}; on {smi}", flush=True)
            if not ok:
                raise SmokeError(f"serving {route_name}: the served outputs are not the eager "
                                 f"ones: {shown}")
    del served, eager
    return results


# phase 12: distributed on the one card. Two ranks cannot share a card under
# NCCL ("Duplicate GPU detected"), so NCCL runs at world size 1 through the
# production path, and the 2-rank checks run gloo on CUDA tensors (the
# backend named explicitly). The 2-rank train steps, the eval sequences, the
# child group's time limit (s); the data-parallel steps use build_optimizer's
# schedule at steps_per_epoch 100, whose first two learning rates are summed
# for DIST_FALLBACK.
DIST_STEPS = 2
DIST_TIMEOUT = 900
# the 2-rank step against one process running the same two halves with
# gradients (g0 + g1) / 2: bit for bit (the same kernels at the same shapes
# on the same card, and a 2-rank average is exact in f32). Were it not, each
# trained element within this fraction of the steps' summed learning rates
# (Adam moves an element by about lr per step), printed as a miss of bitwise
DIST_FALLBACK = 0.1
# gloo's collectives on CUDA tensors, probed by dtype before the phase uses
# them (the data-parallel step reduces f32, the tensor-parallel forward bf16);
# one missing fails the phase, printed with the probe
DIST_PROBE = ("all_reduce", "broadcast", "all_gather")


def _train_gt(torch, np, geom, cfg, dev):
    """The train steps' ground-truth cameras, a batch of one."""
    s = cfg.seqlen
    rng = np.random.default_rng(5)
    q = rng.normal(size=(s, 4)).astype(np.float32)
    t_uvz = (rng.normal(size=(s, 3)) * 40 + [320.0, 240.0, 0.0]).astype(np.float32)
    t_uvz[..., 2] = np.abs(t_uvz[..., 2]) + 3.0
    return geom.CameraSet(*(torch.as_tensor(f, device=dev)[None] for f in geom.make_camera_set(
        torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True)),
        torch.from_numpy(rng.normal(size=(s, 3)).astype(np.float32)),
        t_uvz=torch.from_numpy(t_uvz), ratio=0.9)))


def _dist_request(torch, cfg, step, rank, dev):
    """Rank ``rank``'s batch of one at train step ``step``."""
    return _request(torch, cfg, 300 + 2 * step + rank, dev)


def _grid_seed(np, data, cfg):
    """Query points from the "grid" backend and a fixed generator: the same
    for a sequence whichever rank or batch it is in."""
    def seed(sample):
        frame0 = sample.images[0]
        frame0 = frame0.float().cpu().numpy() if hasattr(frame0, "cpu") else np.asarray(frame0)
        return data.seed_query_points(frame0, sample.first_mask, cfg.track_num,
                                      cfg.min_track_num, backend="grid",
                                      rng=np.random.default_rng(1234))
    return seed


def _shape_counts(counters):
    return [[k, list(shape), n] for k, fn in counters.items() for shape, n in
            fn.launch_shapes.items()]


def _probe_gloo(torch, dist, dev):
    """Which gloo collectives take CUDA tensors of each dtype: name -> "ok"
    or the error's first line."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for op in DIST_PROBE:
            x = torch.ones(4, dtype=dtype, device=dev)
            try:
                if op == "all_reduce":
                    dist.all_reduce(x)
                    ok = bool((x == dist.get_world_size()).all())
                elif op == "broadcast":
                    dist.broadcast(x, src=0)
                    ok = bool((x == 1).all())
                else:
                    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
                    dist.all_gather(parts, x)
                    ok = all(bool((p == 1).all()) for p in parts)
                out[f"{op} {str(dtype)[6:]}"] = "ok" if ok else "wrong result"
            except RuntimeError as exc:
                out[f"{op} {str(dtype)[6:]}"] = str(exc).splitlines()[0][:160]
    return out


def dist_child(rank, port, directory):
    """``chip_smoke.py --dist RANK PORT DIR``: one of phase 12's two gloo
    ranks on card 0: (b) DIST_STEPS data-parallel train steps on its batch
    of one, (d) ``evaluate(mesh=)`` over the eval phase's sequences (rank 0
    also ``evaluate(eval_batch=2)`` alone), (c) the reference check's
    modules under ``shard_params_tp`` on a (data 1, model 2) mesh against
    the replicated modules; writes its results to DIR/rank{RANK}.pt."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from comet_tpu_torch import config as tcfg
    from comet_tpu_torch import data, geometry as geom, models, parallel, training
    from comet_tpu_torch.training import data_parallel

    if not torch.cuda.is_available():
        print("chip_smoke --dist: no CUDA device", file=sys.stderr)
        return 2
    counters = _counters()
    dev = parallel.init_distributed(f"localhost:{port}", 2, rank, device="cuda:0",
                                    backend="gloo", timeout_s=DIST_TIMEOUT)
    res = {"probe": _probe_gloo(torch, dist, dev)}
    if any(v != "ok" for v in res["probe"].values()):
        # the data-parallel step reduces f32, the tensor-parallel forward bf16
        torch.save(res, os.path.join(directory, f"rank{rank}.pt"))
        return 3
    cfg = tcfg.get_config("ours")
    model = models.build_comet(cfg, device=dev, seed=0)
    mask = training.camera_only_mask(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters() if not mask[n]}
    mesh = parallel.make_mesh(n_data=2, device="cuda")

    # (b) data parallelism
    optimizer, scheduler = training.build_optimizer(model, cfg.train.lr, steps_per_epoch=100)
    ddp = data_parallel.replicate_train_state(mesh, model, optimizer)
    step = training.build_train_step(ddp, cfg, optimizer, scheduler)
    gt = _train_gt(torch, np, geom, cfg, dev)
    losses, launches, ms = [], [], []
    for i in range(DIST_STEPS):
        images, queries = _dist_request(torch, cfg, i, rank, dev)
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = step(images, queries, gt)
        losses.append(aux["loss"].item())
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(_launches(counters))
    res["dp"] = dict(losses=losses, launches=launches, ms=ms,
                     lrs=[scheduler.lr_lambdas[0](i) for i in range(DIST_STEPS)],
                     unchanged=[n for n, p in model.named_parameters()
                                if not mask[n] and not torch.equal(p, before[n])])
    del before
    grads = [p for n, p in model.named_parameters() if mask[n]]
    res["dp"]["grad_bytes"] = sum(p.numel() * p.element_size() for p in grads)
    flat = torch.zeros(sum(p.numel() for p in grads), device=dev)
    reduce_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat, group=mesh.get_group("data"))
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    res["dp"]["reduce_ms"] = reduce_ms
    del flat
    torch.save({n: p.detach().cpu() for n, p in model.named_parameters() if mask[n]},
               os.path.join(directory, f"dp_params{rank}.pt"))
    del ddp, step, optimizer, scheduler, aux

    # (d) the mesh eval
    raw = make_sequences(np, data, geom, cfg, EVAL_SEQUENCES)
    seqs = InMemorySequences(torch, np, data, cfg, dev, raw)
    quiet = dict(keypoint_backend=_grid_seed(np, data, cfg), print_fn=lambda *a: None)
    _reset(counters)
    t0 = time.perf_counter()
    res["eval"] = training.evaluate(model, seqs, cfg, mesh=mesh, **quiet)
    res["eval_s"] = time.perf_counter() - t0
    res["eval_launches"] = _launches(counters)
    if rank == 0:
        res["eval_one"] = training.evaluate(model, seqs, cfg, eval_batch=2, device=dev, **quiet)
    dist.barrier()

    # (c) tensor parallelism, each route: the replicated outputs first, then
    # the same modules sharded over a (data 1, model 2) mesh
    tp_mesh = parallel.make_mesh(n_data=1, n_model=2, device="cuda")
    cases = _reference_cases(torch, model)
    routes = (("default", tcfg.KernelRoute()), ("fused", tcfg.FUSED_ROUTE))
    ref = {}
    with torch.inference_mode():
        for route_name, route in routes:
            model.set_route(route)
            for where, path, args in cases:
                out = model.get_submodule(path)(*(a.to(dev) for a in args))
                ref[route_name, where] = (out.pred_pose_enc if path == "camera_predictor"
                                          else out).float().cpu()
    replicated_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    with torch.no_grad():
        parallel.shard_params_tp(tp_mesh, model)
    res["tp_bytes"] = (replicated_bytes,
                       sum(p.numel() * p.element_size() for p in model.parameters()))
    res["tp"] = {}
    with torch.inference_mode():
        for route_name, route in routes:
            model.set_route(route)
            _reset(counters)
            errs = {}
            for where, path, args in cases:
                out = model.get_submodule(path)(*(a.to(dev) for a in args))
                got = (out.pred_pose_enc if path == "camera_predictor" else out).float().cpu()
                want = ref[route_name, where]
                errs[where] = ((got - want).abs().max().item(), want.abs().max().item(),
                               bool(torch.isfinite(got).all()))
            res["tp"][route_name] = dict(errs=errs, launches=_launches(counters),
                                         shapes=_shape_counts(counters))
    torch.save(res, os.path.join(directory, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def _halves_reference(torch, np, geom, tcfg, models, training, cfg, dev):
    """The 2-rank step in one process: each rank's batch of one through the
    forward and backward on its own, the gradients averaged as DDP averages
    them, then the optimizer (build_train_step's operations)."""
    from comet_tpu_torch.training.loop import cameras_to

    model = models.build_comet(cfg, device=dev, seed=0)
    mask = training.camera_only_mask(model)
    optimizer, scheduler = training.build_optimizer(model, cfg.train.lr, steps_per_epoch=100)
    trained = [(n, p) for n, p in model.named_parameters() if mask[n]]
    gt = cameras_to(_train_gt(torch, np, geom, cfg, dev), dev)
    losses = []
    for i in range(DIST_STEPS):
        grads, row = [], []
        for rank in range(2):
            optimizer.zero_grad(set_to_none=True)
            images, queries = _dist_request(torch, cfg, i, rank, dev)
            out = model(images, queries)
            loss = models.pose_loss(cfg, out["pred_pose_enc"], models.encode_gt(cfg, gt))["loss"]
            loss.backward()
            row.append(loss.item())
            grads.append([p.grad.clone() for _, p in trained])
        for (_, p), g0, g1 in zip(trained, *grads):
            p.grad = (g0 + g1) / 2
        del grads
        optimizer.step()
        scheduler.step()
        losses.append(row)
    params = {n: p.detach().cpu() for n, p in trained}
    del model, optimizer
    return losses, params


def _nccl_world_one(torch, np, data, geom, tcfg, training, parallel, cfg, model, counters, dev,
                    smi):
    """Phase 12 (a): NCCL at world size 1 through the production path
    (init_distributed, make_mesh, replicate_train_state, fit_epoch(mesh=))
    against fit_epoch(mesh=None), each from its own copy of ``model`` on the
    same sequences: camera parameters, losses and launches per step equal."""
    import copy

    from comet_tpu_torch.parallel.launch import free_port
    from comet_tpu_torch.training import data_parallel

    raw = make_sequences(np, data, geom, cfg, 2, seed=1)
    seqs = InMemorySequences(torch, np, data, cfg, dev, raw)
    seed = _grid_seed(np, data, cfg)
    runs = {}
    for name in ("mesh=None", "mesh"):
        m = copy.deepcopy(model)
        optimizer, scheduler = training.build_optimizer(m, cfg.train.lr, steps_per_epoch=100)
        mesh = None
        trained = m
        if name == "mesh":
            dev_rank = parallel.init_distributed(f"localhost:{free_port()}", 1, 0, device=dev)
            mesh = parallel.make_mesh(n_data=1, device="cuda")
            trained = data_parallel.replicate_train_state(mesh, m, optimizer)
            backend = torch.distributed.get_backend()
        step = training.build_train_step(trained, cfg, optimizer, scheduler)
        losses, launches = [], []

        def counted(*args, step=step, losses=losses, launches=launches):
            before = _launches(counters)
            aux = step(*args)
            launches.append({k: v - before[k] for k, v in _launches(counters).items()})
            losses.append(aux["loss"].item())
            return aux

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = training.fit_epoch(counted, seqs, seed, 1, np.arange(2),
                               device=dev if mesh is None else None, mesh=mesh)
        torch.cuda.synchronize()
        mask = training.camera_only_mask(m)
        runs[name] = dict(steps=n, losses=losses, launches=launches,
                          seconds=time.perf_counter() - t0,
                          params={k: p.detach().clone() for k, p in m.named_parameters()
                                  if mask[k]})
        if mesh is not None:
            torch.distributed.destroy_process_group()
        del m, trained, optimizer, step
    a, b = runs["mesh=None"], runs["mesh"]
    diff = [k for k in a["params"] if not torch.equal(a["params"][k], b["params"][k])]
    print(f"distributed (a): NCCL at world size 1 ({backend}, rank device {dev_rank}): "
          f"fit_epoch(mesh=) {b['steps']} steps in {b['seconds']:.1f} s, losses {b['losses']}, "
          f"launches per step {b['launches']}; fit_epoch(mesh=None) {a['seconds']:.1f} s, losses "
          f"{a['losses']}; camera tensors differing {len(diff)} of {len(a['params'])}, on {smi}",
          flush=True)
    if backend != "nccl" or a["steps"] != 2 or b["steps"] != 2:
        raise SmokeError(f"distributed (a): backend {backend}, steps {a['steps']}, {b['steps']}")
    if a["losses"] != b["losses"] or a["launches"] != b["launches"] or diff:
        raise SmokeError(f"distributed (a): mesh and mesh-less epochs differ: losses "
                         f"{a['losses']} / {b['losses']}, launches {a['launches']} / "
                         f"{b['launches']}, tensors {diff[:4]}")
    if any(ln != PER_FORWARD["default"] for ln in b["launches"]):
        raise SmokeError(f"distributed (a): launches per step {b['launches']}")
    return b


def distributed_phase(torch, np, data, geom, tcfg, models, training, parallel, cfg, model,
                      counters, dev, smi):
    """Phase 12: (a) NCCL at world size 1 in this process; then 2 gloo ranks
    on the card (``--dist``) for (b) data parallelism, (c) tensor
    parallelism and (d) the mesh eval, checked against this process's
    two-halves step and the ranks' own replicated runs. Returns the
    phase's record."""
    import os
    import tempfile

    from comet_tpu_torch.parallel.launch import free_port

    t_phase = time.perf_counter()
    model.set_route(tcfg.KernelRoute())
    nccl = _nccl_world_one(torch, np, data, geom, tcfg, training, parallel, cfg, model, counters,
                           dev, smi)
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(root / "chip_smoke.py"), "--dist", str(r),
                                   str(port), tmp], cwd=root, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env={**os.environ, "PYTHONPATH": str(root)})
                 for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=DIST_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        probes = [torch.load(os.path.join(tmp, f"rank{r}.pt"))["probe"] for r in range(2)
                  if os.path.exists(os.path.join(tmp, f"rank{r}.pt"))]
        if any(v != "ok" for probe in probes for v in probe.values()):
            raise SmokeError(f"distributed: gloo does not take these collectives on CUDA "
                             f"tensors: {probes}")
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode:
                raise SmokeError(f"distributed: rank {r} failed ({p.returncode}):\n{log[-4000:]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
        dp_params = [torch.load(os.path.join(tmp, f"dp_params{r}.pt")) for r in range(2)]
    probe = ranks[0]["probe"]
    print(f"distributed: 2 gloo ranks on card 0 ran in {wall:.1f} s (wall); gloo on CUDA tensors: "
          f"{json.dumps(probe)}", flush=True)

    # (b) against one process running the same two halves
    t0 = time.perf_counter()
    losses, params = _halves_reference(torch, np, geom, tcfg, models, training, cfg, dev)
    ref_s = time.perf_counter() - t0
    lr_sum = sum(ranks[0]["dp"]["lrs"])
    worst, bitwise = 0.0, True
    for r in range(2):
        d = ranks[r]["dp"]
        if d["losses"] != [row[r] for row in losses]:
            raise SmokeError(f"distributed (b): rank {r} losses {d['losses']}, one process "
                             f"{[row[r] for row in losses]}")
        if d["unchanged"]:
            raise SmokeError(f"distributed (b): rank {r} moved frozen tensors {d['unchanged'][:4]}")
        if any(ln != PER_FORWARD["default"] for ln in d["launches"]):
            raise SmokeError(f"distributed (b): rank {r} launches per step {d['launches']}")
        for k, p in params.items():
            if not torch.equal(dp_params[r][k], p):
                bitwise = False
                worst = max(worst, (dp_params[r][k] - p).abs().max().item())
    d = ranks[0]["dp"]
    print(f"distributed (b): 2 ranks x batch 1, {DIST_STEPS} steps: losses {d['losses']} / "
          f"{ranks[1]['dp']['losses']} equal the one-process halves'; {len(params)} camera "
          f"tensors {'bit for bit equal' if bitwise else f'max |diff| {worst:.3e}'} (halves in "
          f"{ref_s:.1f} s); gradient bytes reduced per step {d['grad_bytes']}, gloo all-reduce "
          f"of them on the card {['%.1f' % x for x in d['reduce_ms']]} ms; step ms "
          f"{['%.1f' % x for x in d['ms']]}; on {smi}", flush=True)
    if not bitwise and not worst <= DIST_FALLBACK * lr_sum:
        raise SmokeError(f"distributed (b): camera tensors differ by {worst} > {DIST_FALLBACK} x "
                         f"{lr_sum}")
    if not bitwise:
        print(f"distributed (b): MISS of bitwise, within {DIST_FALLBACK} x the summed learning "
              f"rates {lr_sum:.3e}", flush=True)

    # (c) tensor parallelism
    full, mine = ranks[0]["tp_bytes"]
    for route_name in ("default", "fused"):
        for r in range(2):
            t = ranks[r]["tp"][route_name]
            for where, (err, scale, finite) in t["errs"].items():
                if not finite or not err <= REF_RTOL * scale:
                    raise SmokeError(f"distributed (c) {route_name} rank {r} {where}: max |TP - "
                                     f"replicated| {err} > {REF_RTOL} * {scale}")
        t = ranks[0]["tp"][route_name]
        k1_heads = sorted({s[-1] for k, s, _ in t["shapes"] if k == "K1"})
        whole = {k: sorted({tuple(s) for kk, s, _ in t["shapes"] if kk == k}) for k in
                 ("K2", "K4")}
        widths = {s[-3:] for k in whole for s in whole[k]}
        print(f"distributed (c), {route_name} route: model axis 2, launches {t['launches']}, K1 "
              f"at head counts {k1_heads}, K2/K4 shapes {whole}; max |TP - replicated| / max "
              f"|replicated| " + ", ".join(f"{w}: {e / s:.2e}" for w, (e, s, _) in
                                             t["errs"].items())
              + f" (limit {REF_RTOL}); on {smi}", flush=True)
        want_used = ("K1", "K2") if route_name == "default" else ("K1", "K3", "K4", "K5")
        if any(t["launches"][k] == 0 for k in want_used):
            raise SmokeError(f"distributed (c) {route_name}: a kernel never ran: {t['launches']}")
        # every multi-head attention's 8 heads split 4 + 4; the ViT's qkv is
        # gathered (12 heads); K2 and K4 take whole-block weights
        if k1_heads != [4, 12]:
            raise SmokeError(f"distributed (c) {route_name}: K1 at head counts {k1_heads}, want "
                             "the local 4 of 8 and the ViT's 12")
        if not widths or not widths <= {(384, 8, 1536), (256, 8, 1024)}:
            raise SmokeError(f"distributed (c) {route_name}: K2/K4 at {whole}, not at their "
                             "whole widths")
    print(f"distributed (c): parameter bytes per rank {mine} against {full} replicated "
          f"({mine / full:.3f}), on {smi}", flush=True)

    # (d) the mesh eval
    one = ranks[0]["eval_one"]
    worst = 0.0
    for r in range(2):
        got = ranks[r]["eval"]
        for k in sorted(k for k in one if k != "sec/it" and not k.startswith("Auc_scene")):
            gap = abs(got[k] - one[k]) - EVAL_RTOL * abs(one[k])
            worst = max(worst, gap)
            if gap > EVAL_ATOL or not math.isfinite(got[k]):
                raise SmokeError(f"distributed (d) rank {r} {k}: {got[k]} merged, {one[k]} in "
                                 "one process at eval_batch 2")
    scenes = [sorted(k for k in ranks[r]["eval"] if k.startswith("Auc_scene")) for r in range(2)]
    print(f"distributed (d): evaluate(mesh=) over {EVAL_SEQUENCES} sequences in "
          f"{ranks[0]['eval_s']:.1f} s per rank, launches per rank {ranks[0]['eval_launches']}; "
          f"merged averages within {EVAL_ATOL} + {EVAL_RTOL}|x| of evaluate(eval_batch=2) "
          f"(largest excess {worst:.3e}); R_avg {ranks[0]['eval']['R_avg']:.4f} against "
          f"{one['R_avg']:.4f}; scenes per rank {[len(s) for s in scenes]}, on {smi}", flush=True)
    if set(scenes[0]) & set(scenes[1]) or len(scenes[0]) + len(scenes[1]) != EVAL_SEQUENCES:
        raise SmokeError(f"distributed (d): scenes per rank {scenes}")
    seconds = time.perf_counter() - t_phase
    print(f"distributed: phase 12 in {seconds:.1f} s, on {smi}", flush=True)
    # the TP forwards' launches by shape (the train steps' and the evals' are
    # the main path's shapes)
    shapes = Counter()
    for r in range(2):
        for route_name in ("default", "fused"):
            for k, s, n in ranks[r]["tp"][route_name]["shapes"]:
                shapes[k, tuple(s)] += n
    launches = {k: sum(ln[k] for ln in nccl["launches"]) for k in KERNELS}
    for r in range(2):
        for k in KERNELS:
            launches[k] += ranks[r]["eval_launches"][k] + sum(
                ln[k] for ln in ranks[r]["dp"]["launches"]) + sum(
                ranks[r]["tp"][rn]["launches"][k] for rn in ("default", "fused"))
    return dict(seconds=seconds, launches=launches, shapes=shapes, probe=probe,
                grad_bytes=d["grad_bytes"], reduce_ms=d["reduce_ms"], tp_bytes=(mine, full))


def _profile_step(torch, step, request, gt, step_ms):
    """torch.profiler over one warm train step: its device time and the
    device's idle share of the median step."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(*request, gt)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return dict(device_ms=device_ms, launches=sum(e.count for e in kernels),
                idle=1 - device_ms / step_ms)


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
    parser.add_argument("--serve", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--dist", nargs=3, metavar=("RANK", "PORT", "DIR"), help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.serve:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        return serve_child(args.serve)
    if args.dist:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        return dist_child(int(args.dist[0]), int(args.dist[1]), args.dist[2])

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import numpy as np
        import torch.nn.functional as F

        from comet_tpu_torch import bench_lib, data
        from comet_tpu_torch import config as tcfg
        from comet_tpu_torch import geometry as geom
        from comet_tpu_torch import models, parallel, training
        from comet_tpu_torch.models import windowed
        from comet_tpu_torch.ops import attn, library, block, kernels, norm
        from comet_tpu_torch.training import loop as loop_mod
        from comet_tpu_torch.utils import serialization, serving
    except ImportError as exc:
        print(f"chip_smoke: the comet_tpu_torch package is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "comet_tpu")]:
        print(f"chip_smoke: {name} was imported", file=sys.stderr)
        return 2

    counters = _counters()
    dev = torch.device("cuda", 0)
    card_name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"device: {card_name} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
          f"nvidia-smi: {smi}", flush=True)
    runs = {}
    started = time.perf_counter()
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
        checked = dict(K1=check_k1(torch, F, attn, dev, gen),
                       K1_forms=check_k1_forms(torch, F, attn, dev),
                       K2=check_k2(torch, block, dev, gen),
                       K2_tool=check_k2(torch, block, dev,
                                        torch.Generator(device=dev).manual_seed(9), K2_TOOL_SHAPES),
                       K3=check_k3(torch, F, attn, dev, gen, floor_ms),
                       K4=check_k4(torch, block, dev, gen),
                       K5=check_k5(torch, F, norm, dev, gen, floor_ms))
        decorator_probe(torch, norm, dev)
        check_edges(torch, attn, block, dev, gen)
        check_edges_k3_k5(torch, attn, norm, dev, gen)
        cfg = tcfg.get_config("ours")
        t0 = time.perf_counter()
        model = models.build_comet(cfg, device=dev, seed=0)
        torch.cuda.synchronize()
        print(f"build_comet('ours') on {dev} in {time.perf_counter() - t0:.1f} s, "
              f"{sum(p.numel() for p in model.parameters())} parameters", flush=True)
        cpu = reference_check(torch, tcfg, models, model, dev, counters)
        gradient_check(torch, tcfg, training, model, cpu, dev)
        del cpu
        for route_name, route in (("default", tcfg.KernelRoute()), ("fused", tcfg.FUSED_ROUTE)):
            model.set_route(route)
            runs[route_name] = main_path(torch, cfg, model, models, geom, counters, route_name,
                                         dev, args.requests, smi)
            if args.profile:
                profile(torch, model, *runs[route_name]["requests"][0], args.profile, route_name,
                        runs[route_name]["median_ms"])
        model.set_route(tcfg.KernelRoute())
        bench, variants, form_counts = bench_phase(torch, tcfg, bench_lib, attn, counters, smi,
                                                   runs)
        evals = eval_phase(torch, np, cfg, model, data, loop_mod, geom, counters, dev, smi)
        backward = check_backward(torch, F, attn, norm, dev)
        train = train_phase(torch, np, tcfg, geom, training, library, bench_lib, cfg, model,
                            counters, dev, smi)
        windowed_runs = windowed_phase(torch, np, tcfg, geom, models, windowed, training, library,
                                       serialization, cfg, model, counters, dev, smi)
        cli_walls = cli_phase(torch, cfg, counters, smi)
        serve = serving_phase(torch, tcfg, windowed, serialization, serving, cfg, model, counters,
                              dev, smi)
        distributed = distributed_phase(torch, np, data, geom, tcfg, models, training, parallel,
                                        cfg, model, counters, dev, smi)
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
                inference_host_us=r["inference_host_us"], launch_host_us=r["launch_host_us"],
                floor_ms=r.get("floor_ms"), copy_ms=r.get("copy_ms"),
                phase12_launches_of_kernel=distributed["launches"][kernel],
            ))
    for r in checked["K1_forms"]:
        # launches: this form at this shape in run_softmax_variants
        record.append(dict(
            name=f"K1 {r['form']} {r['where']} {r['shape']}", route="cuda",
            source="comet_tpu_torch/csrc/attn.cu", replaces="tools/micro_softmax_variants.py:67",
            launches=form_counts.get((r["form"], *r["shape"]), 0), max_abs_err=r["max_abs_err"],
            ms=r["ms"], k1_ms=r["k1_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], host_us=r["host_us"],
            library_host_us=None, tolerance=r["tolerance"],
        ))
    for r in checked["K2_tool"]:
        record.append(dict(
            name=f"K2 {r['where']} {r['shape']}", route="cuda", source="comet_tpu_torch/csrc/block.cu",
            replaces="tools/micro_lane_packing.py:50", launches=0, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, host_us=r["host_us"], library_host_us=None, tolerance=r["tolerance"],
        ))
    for r in backward:
        # launches: the Function's backwards at this shape in each route's train steps
        key = (r["kernel"], *r["shape"][:4]) if r["kernel"] == "K1" else (
            "K5", r["shape"][0], r["shape"][1], r["shape"][3])
        by_route = {rn: t["backwards"].get(key, 0) for rn, t in train.items()}
        record.append(dict(
            name=f"{r['kernel']} backward {r['where']} {r['shape']}", route="cuda",
            source="comet_tpu_torch/ops/library.py",
            replaces=("comet_tpu/ops/pallas_attn.py:196" if r["kernel"] == "K1"
                      else "comet_tpu/ops/pallas_norm.py:82"),
            launches=sum(by_route.values()), launches_by_route=by_route,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            tolerance=r["tolerance"],
        ))
    for route_name, run in runs.items():
        print(f"main path, {route_name} route: launches over {args.requests} requests "
              f"{run['total']} ({PER_FORWARD[route_name]} per forward); median request "
              f"{run['median_ms']:.1f} ms = {1e3 / run['median_ms']:.2f} sequences/s, peak memory "
              f"{run['peak_gib']:.2f} GiB", flush=True)
    print(f"bench (parameters cast to bf16 once): {bench['value']} sequences/s "
          f"({bench['ms_per_sequence']} ms per sequence on "
          f"the host clock, {bench['device_ms_per_sequence']} between CUDA events)", flush=True)
    for eval_batch, e in evals.items():
        print(f"eval, eval_batch {eval_batch}: {EVAL_SEQUENCES / e['seconds']:.2f} sequences/s",
              flush=True)
    for route_name, t in train.items():
        print(f"train, {route_name} route: median step {t['median_ms']:.1f} ms (forward "
              f"{t['parts']['forward']:.1f}, backward {t['parts']['backward']:.1f}, optimizer "
              f"{t['parts']['optimizer']:.1f}), peak memory {t['peak_gib']:.2f} GiB, idle share "
              f"{t['idle']:.2f}; run_train_benchmark {t['bench']['value']} steps/s "
              f"({t['bench']['ms_per_step']} ms per step on the host clock, "
              f"{t['bench']['device_ms_per_step']} between CUDA events)", flush=True)
    for route_name, w in windowed_runs.items():
        times = ", ".join(f"{FORM_NAMES[form]} T {t} {host:.1f} ms ({host / t:.2f} per frame)"
                          for (form, t), (host, _) in w["times"].items())
        wt = w["train"]
        print(f"windowed, {route_name} route: {times}; train step at T {WINDOWED_TRAIN_T} "
              f"{wt['median_ms']:.1f} ms (forward {wt['parts']['forward']:.1f}, backward "
              f"{wt['parts']['backward']:.1f}, optimizer {wt['parts']['optimizer']:.1f}), peak "
              f"{wt['peak_gib']:.2f} GiB; host synchronizations (in the forwards, own) "
              f"{ {k: (v['in_forwards'], v['own']) for k, v in w['syncs'].items()} }", flush=True)
    print(f"cli: wall seconds {json.dumps({k: round(v, 1) for k, v in cli_walls.items()})}",
          flush=True)
    for served_name, r in serve.items():
        print(f"serving, {served_name}: served median {statistics.median(r['served_ms'][1:]):.1f} ms "
              f"against eager {statistics.median(r['eager_ms'][1:]):.1f}; largest |served - "
              f"eager| {max(max(d.values()) for d in r['diffs']):.3e}; export "
              f"{r['export_s']:.1f} s, save {r['save_s']:.1f} s, load {r['load_s']:.1f} s, "
              f"{r['manifest']['artifact_bytes']} bytes; launches per call {r['launches']}",
              flush=True)
    print(f"distributed: phase 12 {distributed['seconds']:.1f} s; launches per kernel "
          f"{distributed['launches']}; gradient bytes per step {distributed['grad_bytes']}, "
          f"all-reduce {['%.1f' % x for x in distributed['reduce_ms']]} ms (gloo, one card); "
          f"TP parameter bytes per rank {distributed['tp_bytes'][0]} of "
          f"{distributed['tp_bytes'][1]}; TP launches by shape "
          f"{ {f'{k} {s}': n for (k, s), n in sorted(distributed['shapes'].items())} }",
          flush=True)
    print(f"chip_smoke: total {time.perf_counter() - started:.1f} s after the imports", flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
