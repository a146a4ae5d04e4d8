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
   T 32 (default route) exported with ``torch.export`` (the graph must hold
   each route's kernels as ``comet::`` operator nodes, as many as the
   forward launches) and saved, the weights saved as a ``.pt`` file; a
   fresh process (``chip_smoke.py --serve DIR``, which must not import
   ``comet_tpu_torch.models``) loads each artifact, restores the weights
   with ``params_from_file`` and answers 3 requests per route (the chain:
   2 calls), counting launches; its outputs must equal the eager model's
   on the same inputs bit for bit (the chain: tracks bit for bit,
   encodings within WINDOWED_ULPS ulps) and its launches per call the
   eager counts; ``load_exported`` checks each manifest's kernel digest
   against the library's (the phase asserts that the served process's
   digests are this checkout's); export, save and load times, artifact
   bytes and the served against the eager median request are printed;
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
   rank's scenes its own; (e) tensor-parallel training, per route: in each
   rank TP_TRAIN_STEPS camera-only train steps of the full-width model from
   seed 0 (the trackers' coordinate updates held at 0), replicated, then
   sharded by ``shard_params_tp`` over a (data 1, model 2) mesh
   (``replicate_train_state`` over its data group of one), on the same
   batches: losses and global norms within ``REF_RTOL``, every camera
   tensor's first-step gradient (this rank's part) within ``REF_RTOL`` of
   its range (floored at ``GRAD_FLOOR`` of the largest), both first-step
   gradients read against the same step in f32 on the CPU (the
   tensor-parallel one no further from it than the replicated one: the
   median ratio of the two within ``TP_F32_RATIO``), the replicated camera
   tensors equal bit for bit across the two ranks
   after each step, frozen tensors unchanged; each rank's parameter and
   optimizer-state bytes, ms and launches per step printed. The phase's
   time and launches are printed, and each kernel's record carries its
   phase-12 launches; and
13. the load paths: (a) the native C++ loader (``native/cometio.cpp``)
   built with ``g++`` on this machine, timed, with its version, or the
   compiler's error on a line of its own; (b) an AMD fixture of
   ``data.fixtures`` (LOAD_SEQUENCES sequences of seqlen 480 x 640 frames)
   through ``NativeLoaderDataset``, equal to the PIL path bit for bit, and
   ``DevicePreprocessDataset(decode="native")`` on the card, equal to
   ``decode="pil"`` bit for bit, with host ms per sequence of each decode;
   (c) ``cli.main eval --loader native --device-preprocess`` at full width,
   a finite CSV. Where the library does not build, (b) and (c) are printed
   as not run, and the phase checks instead that each of them raises with
   the build error (no fall back to PIL). The flax ``.msgpack`` reader is
   host code and is held on the CPU only (the card's machine has no flax
   to write a file with); and
14. scene geometry (``twoview/``, ``utils/dense_depth.py``; no kernel, so
   no launch may happen), with TF32 matmuls off: (a) each solver on the
   card against the port on the CPU on the same minimal samples (8-point,
   7-point, homography DLT and 5-point on GEOM_HYPOTHESES samples, the
   5-point's and 7-point's real solutions as sets (against the CPU's f64,
   the card as exact as the CPU's f32), the 5-point's 120
   shifted-QR steps timed on both; EPnP on 512 points; LM PnP over 16
   cameras; one bundle adjustment at S 16, N 512), within the GEOM_*
   tolerances; (b) the JAX package's 16-camera done-criterion scene at the
   main path's 512 tracks (``make_scene``: ``default_kmat(512, 512)``, 0.3 px
   of noise, 15 % of the tracks corrupted, poses perturbed by 0.02 and 0.05)
   through ``estimate_preliminary_cameras`` and ``reconstruct_scene`` on the
   card, held to that test's gates (SCENE_GATES), its COLMAP model written
   and read back, and a disparity map made from the true depths aligned by
   ``dense_depth`` to the reconstruction's sparse depths; (c) the same scene
   through the port on the CPU (the preliminary RANSAC replaying the card's
   samples), the card held to it; (d) per stage (preliminary, init BA,
   refine poses, each RANSAC triangulation, each global BA, each filter,
   the whole) the card's and the CPU's ms, the card's host synchronizations
   (torch's sync debug mode, with their source lines) and peak memory; and
15. the point-matching stack (``matching/``, ``models/superpoint.py``; no
   kernel), in f32 with TF32 off (matmuls and cuDNN) for its comparisons:
   (a) on the card against the port on the CPU, the same weights (drawn on
   the CPU from seed 0) and inputs: SuperPoint and SIFT on a 480 x 480
   synthetic image with 512 keypoints (positions equal, JAX's tie order
   included, but for near-ties; descriptors within MATCH_TOL), LightGlue at
   depth 9, width 256, 4 heads on 512 + 512 keypoints with adaptivity off and
   at MATCH_ADAPTIVE (``stop_layer`` and ``prune0/1`` equal), SuperGlue at
   depth 9 with 50 Sinkhorn iterations; a match may differ only at a
   near-tie (MATCH_NEAR_TIE), and such disagreements are counted and
   printed; (b) ``cli.main match --experiment E --n-pairs 8 --image-size
   480`` on the card for each of MATCH_EXPERIMENTS (the trainable matchers
   with ``--load-experiment`` of a checkpoint written here in the JAX
   package's format, whose weights score pairs by a scaled cosine: random
   ones match nothing), every row finite; the same command at
   MATCH_CPU_PAIRS pairs on the card and on the CPU (its RANSAC replaying
   the card's samples), the rows within MATCH_ROW; ``match --list`` prints
   11 names; (c) ``detect_superpoint`` (its disagreements near-ties) and
   ``seed_query_points(backend="superpoint")`` on an AMD fixture frame on
   the card and the CPU, then ``cli.main eval --keypoints superpoint`` at
   full width (a finite CSV row); (d) per experiment the extractor's and the
   matcher's ms per pair (from (b)'s runs) on the card and the CPU, and on
   the card the host synchronizations of one benchmark pair (with their
   source lines) and the peak memory. K1-K5
   may not launch in (a), (b), (d) or (c)'s seeding; (c)'s eval runs the
   COMET forward, whose launches are printed; and
16. matcher training, the ALIKED, DISK and KeyNet extractors and the DINOv2
   backbone on K1 (``train_extract_phase``), LightGlue's loss on one fixed
   batch falling by OVERFIT16_FALL over OVERFIT16_STEPS steps; and
17. line matching, depth ground truth and the cached-prediction pipelines
   (``matching/lines.py``, ``deeplsd.py``, ``gluestick.py``, ``depth_gt.py``,
   ``eval_pipeline.py``, ``cache_loader.py``; no kernel), TF32 off: (a) the
   two line experiments as named (GlueStick depth 6, width 128) and
   GlueStick at depth 9, width 256, DeepLSD at base 32, on phase 15's 8
   synthetic 480 px pairs (512 keypoints, 64 lines): on 3 pairs the card
   against the CPU (keypoints and segments equal but for near-ties, a
   differing segment coming back when the card marches the CPU's fields,
   the fields within LINES17_FIELD_TOL, a check that must see the card's
   orientation moved by LINES17_PERTURB where a march reads it; GlueStick
   on the CPU's features, its log assignments within MATCH_TOL and
   matches equal but for near-ties),
   then the benchmark row on the card and ms per pair of the extractor, the
   detector and the matcher, host syncs per pair and peak memory; (b)
   ``gt_matches_from_pose_depth`` and ``gt_line_matches_from_pose_depth``
   on 512 keypoints and 480 px depth maps, labels equal card against CPU,
   ms per call; (c) each pipeline's model over its loader (``--pipeline
   hpatches`` on synthetic pairs and on an image directory with a pairs
   file written here, ``--pipeline relpose`` on synthetic pairs and on an
   AMD fixture) on the card against the CPU: keypoints and matches0 index
   for index equal but for near-ties; without h5py, ``run`` and
   ``--export-features`` raising, naming it (with h5py the .h5 round trip
   is held to the JAX package by the CPU tests, not here); and
18. resuming the JAX package's training run, checkpoints of a
   tensor-parallel model and the last matching helpers (``resume_phase``):
   (a) phase 8's train steps on the default route (K1 and K2): after
   RESUME18_STEPS steps the state is written in the JAX package's checkpoint
   layout (``jax_train_state``, the port's msgpack writer; what
   ``tools/orbax_to_msgpack.py`` makes of an orbax directory) and restored by
   ``training.auto_resume`` into a fresh model, optimizer and scheduler on
   the card: every parameter, Adam moment, step and the scheduler's count
   bit for bit, the bytes and the write and read seconds printed; the next
   step from the restored state against the uninterrupted one, within
   RESUME18_SPREAD x the spread of RESUME18_RERUNS uninterrupted reruns; (b)
   in phase 12's two ranks on the (data 1, model 2) gloo mesh, after the
   first tensor-parallel step (default route), ``save_checkpoint`` gathers
   the shards and rank 0 writes; the checkpoint restored into the replicated
   model (each rank's part of each whole tensor) and into a fresh sharded
   model equals the shards as saved bit for bit, and the step from it is the
   uninterrupted second step within REF_RTOL; (c) ``matching.patches``'
   ``extract_patches`` and ``batch_extract_patches`` on the card equal to the
   CPU, ``matching.misc.batch_to_device`` of a nested batch, and
   ``matching.tools.benchmark_model`` of K1 at the ViT's shape beside phase
   3's time between CUDA events; and
19. the reference's released checkpoints into the port without JAX
   (``convert_phase``, ``comet_tpu_torch/utils/convert_torch_weights.py``):
   (a) a full-width ``ours`` checkpoint in the reference's layout (phase 5's
   weights from seed 0 with the trackers' coordinate updates held at 0,
   DINOv2's ``pos_embed`` at its stored 37 x 37 grid, a ``module.`` prefix,
   ``{"model": ...}``) written as a ``best.bin``,
   converted by ``python -m comet_tpu_torch.utils.convert_torch_weights``
   in a child process (its seconds and peak RSS), its stages timed again in
   this process (``torch.load``, convert, write, read: the same bytes, the
   read state dict the in-memory conversion bit for bit), loaded onto the
   card by ``--checkpoint``'s path (bit for bit) and run on phase 5's first
   request on both routes: phase 5's launches per forward, every output
   within REF_RTOL of the same weights' f32 forward on the CPU (the scores,
   which PyTorch's own bf16 on the CPU moves further, held to the CPU's bf16
   trackers instead: ``CONVERT19_KNOWN_MISS``); (b) ``--self-test`` in a child
   process beside (a)'s forwards on the CPU: the five presets at full width,
   0 missing and 0 unmapped; (c) a ``superpoint_v1`` SuperPoint and an
   official-layout LightGlue (depth 9, width 256, the release's names, no
   ``input_proj``) converted, the SuperPoint's keypoints and the adaptive
   LightGlue's matches on the card against the CPU as in phase 15 (a), the
   LightGlue with biases that make it prune after layer 0 and stop after
   layer 3: ``stop_layer``, ``prune0`` and ``prune1`` equal, points pruned.

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
    return [_k1_row(torch, F, attn, dev, gen, where, b, lq, lk, c, h, packed)
            for where, b, lq, lk, c, h, packed, calls, calls_fused in K1_SHAPES]


def _k1_row(torch, F, attn, dev, gen, where, b, lq, lk, c, h, packed):
    """K1 at one shape on bf16 inputs from ``gen``: its error against the
    plain f32 version, its device time beside the plain version's and
    SDPA's, its host columns and its bound."""
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
    print(f"K1 {where:32s} [B={b} Lq={lq} Lk={lk} C={c} H={h}] err {err:.3e} (atol {K1_ATOL}) "
          f"ms {ms:.4f} plain {plain_ms:.4f} sdpa {library_ms:.4f} bound {bound:.5f} ({bound_by}) "
          f"{_host_text(host)} (sdpa {library_host_us:.1f})",
          flush=True)
    return dict(kernel="K1", where=where, shape=[b, lq, lk, c, h], max_abs_err=err,
                tolerance=f"atol {K1_ATOL}", ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **host, library_host_us=library_host_us, bound_ms=bound, bound_by=bound_by,
                flops=flops, bytes=nbytes)


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


# phase 11: serving. The windowed artifact's length (3 windows of seqlen 16;
# at T 48, 5 windows, its export, save and load took 363 s of a run that
# ended 42 s inside the script's 1,200 s limit on a slow host, the card's
# kernel rows as in faster runs), and the serving process's time limit (it
# loads three artifacts)
SERVE_WINDOWED_T = 32
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

    from comet_tpu_torch.ops import kernels
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
    # load_exported refused any artifact whose manifest names other kernel
    # sources than this checkout's: each of the three passed that check
    manifests = []
    for route_name in SERVED:
        with open(os.path.join(directory, f"{route_name}.pt2.json")) as f:
            manifests.append(json.load(f)["kernels_digest"])
    result["digest"] = dict(library=kernels._digest(), manifests=manifests)
    result["imported"] = sorted(m for m in sys.modules if m.startswith("comet_tpu"))
    print(json.dumps(result), flush=True)
    return 0


def _largest_diffs(torch, got, want):
    return {k: (got[k].float() - want[k].float()).abs().max().item() for k in want}


def serving_phase(torch, tcfg, windowed, serialization, serving, kernels, cfg, model, counters,
                  dev, smi):
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
        digest = child["digest"]
        if digest["library"] != kernels._digest() or set(digest["manifests"]) != {
                digest["library"]}:
            raise SmokeError(f"serving: the kernel digests differ: {digest}, this process "
                             f"{kernels._digest()}")
        print(f"serving: a fresh process ({wall:.1f} s) loaded the three artifacts (each "
              f"manifest's kernel digest checked by load_exported: {digest['library']}) and "
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


# phase 12 (e): tensor-parallel train steps per route, on a (data 1, model 2)
# mesh of the two ranks, each against the replicated steps on the same batch:
# each camera gradient within REF_RTOL of its range. The trackers'
# coordinate updates are held at 0 (``_still_tracks``), as the CPU tests
# hold them: the random trackers turn a rounding difference into pixels
# (with them on, 15,358 of the 16,384 track coordinates the camera
# predictor got differed between the TP and the replicated forward on the
# H100, by up to 75 px), and the gradients would be compared on different
# inputs. Both bf16 gradients are also read against the same step in f32 on
# the CPU (plain versions), each tensor's largest |difference| over its
# range: a tensor-parallel step that adds rounding of its own (collectives
# rounding their partial sums to bf16 did) sits further from f32 than the
# replicated step; the median over the tensors of the ratio of the two
# distances must be within TP_F32_RATIO.
TP_F32_RATIO = 1.25
TP_TRAIN_STEPS = 2


def _camera_grads(model, mask):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if mask[n] and p.grad is not None}


def _still_tracks(torch, model):
    """Hold the trackers' coordinate updates at 0 (the first two outputs of
    each update-former's flow head): the tracks stay the query points."""
    with torch.no_grad():
        for tracker in (model.coarse_tracker, model.fine_tracker):
            head = tracker.updateformer.flow_head
            head.weight[:2] = 0.0
            head.bias[:2] = 0.0
    return model


def _tp_requests(torch, cfg, dev):
    return [_dist_request(torch, cfg, 10 + i, 0, dev) for i in range(TP_TRAIN_STEPS)]


def tp_f32_grads(torch, np, geom, models, training, cfg, dev):
    """The first camera gradients of phase 12 (e)'s steps in f32 on the CPU
    (plain versions): the full-width model from seed 0 with still tracks on
    the first batch (drawn on ``dev``, as the ranks draw it). Returns
    {name: gradient}."""
    cfg = cfg.replace(compute_dtype="float32")
    cpu = torch.device("cpu")
    images, queries = (t.cpu() for t in _tp_requests(torch, cfg, dev)[0])
    model = _still_tracks(torch, models.build_comet(cfg, device=cpu, seed=0))
    mask = training.camera_only_mask(model)
    optimizer, scheduler = training.build_optimizer(model, cfg.train.lr, steps_per_epoch=100)
    grads = {}

    def mark(part):
        if part == "backward":
            grads.update(_camera_grads(model, mask))

    training.build_train_step(model, cfg, optimizer, scheduler)(
        images, queries, _train_gt(torch, np, geom, cfg, cpu), mark=mark)
    return grads


def _range_gaps(got, want):
    """Each tensor's largest |got - want| over its range (largest |want|),
    the range floored at GRAD_FLOOR of the largest tensor's."""
    floor = GRAD_FLOOR * max(w.abs().max().item() for w in want.values())
    return {n: (got[n] - w).abs().max().item() / max(w.abs().max().item(), floor)
            for n, w in want.items()}


def tp_train_steps(torch, dist, models, training, parallel, data_parallel, cfg, route, mesh,
                   counters, dev, gt, want32, ckpt_dir=None):
    """Phase 12 (e) on one rank, one route: TP_TRAIN_STEPS train steps of the
    full-width model from seed 0 with still tracks, replicated in this rank,
    then sharded with
    ``shard_params_tp`` over ``mesh``'s model axis (``replicate_train_state``
    over its data group of one), on the same batches: the losses, each
    camera tensor's first-step gradient against this rank's part of the
    replicated one and both against this rank's part of ``want32``
    (``tp_f32_grads``), over its range, each step's global norm,
    the replicated camera tensors compared bit for bit with model-rank 0's
    after each step, the frozen tensors, the bytes of this rank's parameters
    and optimizer state, ms and launches per step. With ``ckpt_dir``, phase
    18 (b) as well: the TP state saved after the first step and restored
    (``_tp_restore18``), its record under "ckpt"."""
    requests = _tp_requests(torch, cfg, dev)
    out = {}
    for name in ("replicated", "tp"):
        model = _still_tracks(torch, models.build_comet(cfg, device=dev, seed=0, route=route))
        mask = training.camera_only_mask(model)
        if name == "tp":
            parallel.shard_params_tp(mesh, model)
            frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not mask[n]}
        optimizer, scheduler = training.build_optimizer(model, cfg.train.lr, steps_per_epoch=100)
        trained = (data_parallel.replicate_train_state(mesh, model, optimizer) if name == "tp"
                   else model)
        step = training.build_train_step(trained, cfg, optimizer, scheduler)
        r = out[name] = dict(losses=[], norms=[], ms=[], launches=[], unequal=[])
        for i, (images, queries) in enumerate(requests):
            grads = {}

            def mark(part, grads=grads, i=i, model=model, mask=mask):
                if part == "backward" and i == 0:
                    grads.update(_camera_grads(model, mask))

            _reset(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aux = step(images, queries, gt, mark=mark)
            r["losses"].append(aux["loss"].item())
            r["ms"].append((time.perf_counter() - t0) * 1e3)
            r["launches"].append(_launches(counters))
            r["norms"].append(optimizer.last_norm.item())
            if i == 0:
                r["grads"] = grads
            if name == "tp" and ckpt_dir and i == 0:
                saved = _tp_save18(torch, training, model, optimizer, scheduler, ckpt_dir)
            if name == "tp":
                # the replicated camera tensors against model-rank 0's
                group = mesh.get_group("model")
                unequal = 0
                for n, p in model.named_parameters():
                    if mask[n] and parallel.tp_axis(p) is None:
                        other = p.detach().clone()
                        dist.broadcast(other, src=dist.get_process_group_ranks(group)[0],
                                       group=group)
                        unequal += not torch.equal(other, p)
                r["unequal"].append(unequal)
        if name == "tp":
            ref = {n: parallel.shard_of(model, n, g) for n, g in
                   out["replicated"].pop("grads").items()}
            got = r.pop("grads")
            r["grad_range"] = _range_gaps(got, ref)
            # both bf16 steps against f32, on this rank's part of each tensor
            f32 = {n: parallel.shard_of(model, n, want32[n].to(dev)) for n in ref}
            r["f32"] = {"replicated": _range_gaps(ref, f32), "tp": _range_gaps(got, f32)}
            del ref, got, f32
            r["frozen_moved"] = [n for n, p in model.named_parameters()
                                 if not mask[n] and not torch.equal(p, frozen[n])]
            r["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
            r["state_bytes"] = sum(v.numel() * v.element_size() for st in optimizer.state.values()
                                   for v in st.values() if isinstance(v, torch.Tensor))
            r["sharded"] = sum(parallel.tp_axis(p) is not None for p in model.parameters())
            del frozen
            if ckpt_dir:
                out["ckpt"] = _tp_restore18(torch, models, training, parallel, data_parallel, cfg,
                                            route, mesh, dev, gt, requests[1], model, optimizer,
                                            saved, r)
                del saved
        del model, trained, optimizer, scheduler, step, aux
        torch.cuda.empty_cache()
    return out


def dist_child(rank, port, directory):
    """``chip_smoke.py --dist RANK PORT DIR``: one of phase 12's two gloo
    ranks on card 0: (b) DIST_STEPS data-parallel train steps on its batch
    of one, (d) ``evaluate(mesh=)`` over the eval phase's sequences (rank 0
    also ``evaluate(eval_batch=2)`` alone), (c) the reference check's
    modules under ``shard_params_tp`` on a (data 1, model 2) mesh against
    the replicated modules, (e) ``tp_train_steps`` per route against
    DIR/f32_grads.pt; writes its results to DIR/rank{RANK}.pt."""
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

    # (e) tensor-parallel training, each route
    del model, cases, ref
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want32 = torch.load(os.path.join(directory, "f32_grads.pt"))
    res["tp_train"] = {route_name: tp_train_steps(
        torch, dist, models, training, parallel, data_parallel, cfg, route, tp_mesh, counters, dev,
        gt, want32, os.path.join(directory, "tp_ckpt") if route_name == "default" else None)
        for route_name, route in routes}
    res["tp_train_s"] = time.perf_counter() - t0
    res["tp_ckpt"] = res["tp_train"]["default"].pop("ckpt")
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
    two-halves step and the ranks' own replicated runs, and (e)
    tensor-parallel training (where the ranks also run phase 18 (b), which
    ``resume_phase`` checks). Returns the phase's record."""
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
        t0 = time.perf_counter()
        torch.save(tp_f32_grads(torch, np, geom, models, training, cfg, dev),
                   os.path.join(tmp, "f32_grads.pt"))
        f32_s = time.perf_counter() - t0
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
    # (e) tensor-parallel training against the replicated steps
    tp_train = {}
    for route_name in ("default", "fused"):
        want_used = ("K1", "K2") if route_name == "default" else ("K1", "K3", "K4", "K5")
        for r in range(2):
            rep, t = (ranks[r]["tp_train"][route_name][k] for k in ("replicated", "tp"))
            loss_gap = max(abs(a - b) / abs(b) for a, b in zip(t["losses"], rep["losses"]))
            norm_gap = max(abs(a - b) / abs(b) for a, b in zip(t["norms"], rep["norms"]))
            gaps, rep32, tp32 = t["grad_range"], t["f32"]["replicated"], t["f32"]["tp"]
            worst = max(gaps, key=gaps.get)
            ratio = statistics.median(tp32[n] / rep32[n] for n in rep32 if rep32[n] > 0)
            print(f"distributed (e), {route_name} route, rank {r}: {TP_TRAIN_STEPS} "
                  f"tensor-parallel steps (model axis 2, {t['sharded']} shards): losses "
                  f"{t['losses']} against replicated {rep['losses']} (largest relative gap "
                  f"{loss_gap:.2e}), global norms {['%.4g' % x for x in t['norms']]} against "
                  f"{['%.4g' % x for x in rep['norms']]} ({norm_gap:.2e}); first-step camera "
                  f"gradients, |TP - replicated| largest / range {gaps[worst]:.2e} ({worst}; "
                  f"limit {REF_RTOL}, ranges floored at {GRAD_FLOOR} of the largest); against f32 "
                  f"on the CPU (one step in {f32_s:.1f} s) replicated bf16 "
                  f"{max(rep32.values()):.2e} ({max(rep32, key=rep32.get)}), TP bf16 "
                  f"{max(tp32.values()):.2e} ({max(tp32, key=tp32.get)}), median over "
                  f"{len(rep32)} tensors of TP / replicated {ratio:.3f} (limit {TP_F32_RATIO}); "
                  f"replicated camera tensors differing from model-rank 0's after each step "
                  f"{t['unequal']}; frozen tensors moved {len(t['frozen_moved'])}; parameter "
                  f"bytes {t['param_bytes']}, optimizer-state bytes {t['state_bytes']} "
                  f"(replicated step: {['%.1f' % x for x in rep['ms']]} ms); step ms "
                  f"{['%.1f' % x for x in t['ms']]}; launches per step {t['launches']}; on {smi}",
                  flush=True)
            over = {n: v for n, v in gaps.items() if v > REF_RTOL}
            if not (loss_gap <= REF_RTOL and norm_gap <= REF_RTOL and not over
                    and ratio <= TP_F32_RATIO and all(math.isfinite(x) for x in t["losses"])):
                raise SmokeError(f"distributed (e) {route_name} rank {r}: losses {t['losses']} / "
                                 f"{rep['losses']}, norms {t['norms']} / {rep['norms']}, "
                                 f"gradients over {REF_RTOL} of their range (each from f32: "
                                 f"replicated, TP): " + ", ".join(
                                     f"{n} {v:.2e} ({rep32[n]:.2e}, {tp32[n]:.2e})"
                                     for n, v in sorted(over.items()))
                                 + f"; median distance from f32 TP / replicated {ratio} (limit "
                                 f"{TP_F32_RATIO})")
            if any(t["unequal"]) or t["frozen_moved"]:
                raise SmokeError(f"distributed (e) {route_name} rank {r}: replicated tensors "
                                 f"unequal across the model ranks {t['unequal']}, frozen moved "
                                 f"{t['frozen_moved'][:4]}")
            if any(ln[k] == 0 for ln in t["launches"] for k in want_used):
                raise SmokeError(f"distributed (e) {route_name} rank {r}: a kernel never ran: "
                                 f"{t['launches']}")
        tp_train[route_name] = ranks[0]["tp_train"][route_name]["tp"]
    print(f"distributed (e): in {ranks[0]['tp_train_s']:.1f} s per rank (both routes, with the "
          f"replicated reference steps), on {smi}", flush=True)
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
                ranks[r]["tp"][rn]["launches"][k] for rn in ("default", "fused")) + sum(
                ln[k] for rn in ("default", "fused")
                for ln in ranks[r]["tp_train"][rn]["tp"]["launches"])
    return dict(seconds=seconds, launches=launches, shapes=shapes, probe=probe,
                grad_bytes=d["grad_bytes"], reduce_ms=d["reduce_ms"], tp_bytes=(mine, full),
                tp_train=tp_train, tp_ckpt=[ranks[r]["tp_ckpt"] for r in range(2)])


# phase 13: the load paths, on an AMD fixture of data.fixtures (frames of the
# fixture's 480 x 640) with LOAD_SEQUENCES sequences of seqlen frames
LOAD_SEQUENCES = 2
SAMPLE_FIELDS = ("images", "first_mask", "t_xyz", "q_wxyz", "t_uvz", "r_matrix")


def _per_sequence_ms(fn, n):
    """(the results of fn(0..n-1), host ms per call)."""
    t0 = time.perf_counter()
    out = [fn(i) for i in range(n)]
    return out, (time.perf_counter() - t0) * 1e3 / n


def _same_sample(np, a, b):
    return (all(np.array_equal(getattr(a, f), getattr(b, f)) for f in SAMPLE_FIELDS)
            and (a.ratio, a.seq_name, a.image_names) == (b.ratio, b.seq_name, b.image_names))


def load_phase(torch, np, data, cfg, counters, dev, smi):
    """Phase 13: (a) the native library's build on this machine, timed, with
    its version or the compiler's error on a line of its own; (b) the AMD
    fixture through ``NativeLoaderDataset`` (equal to the PIL path bit for
    bit) and ``DevicePreprocessDataset(decode="native")`` on the card (its
    images equal ``decode="pil"``'s bit for bit), host ms per sequence of
    each decode; (c) ``cli.main eval --loader native --device-preprocess``
    at full width, a finite CSV. Where the library does not build, (b) and
    (c) are reported as not run, and the phase checks instead that the
    native loader, the native decode and the CLI's ``--loader native``
    raise with the build error: nothing falls back to PIL. Returns the
    phase's record."""
    import csv
    import os
    import tempfile

    from comet_tpu_torch import cli, native
    from comet_tpu_torch.data.device_pipeline import wait_ready
    from comet_tpu_torch.data.native_loader import NativeLoaderDataset

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    built = native.available()
    rec = dict(native=built, build_s=time.perf_counter() - t0)
    if built:
        print(f"load (a): the native library built and loaded in {rec['build_s']:.1f} s: "
              f"{native.version()}", flush=True)
    else:
        print(f"load (a): the native library did not build on this machine "
              f"({rec['build_s']:.1f} s); the compiler's error follows on one line", flush=True)
        print(native.build_error().replace("\n", " | "), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "AMD_eval")
        data.generate_amd_fixture(root, n_seqs=LOAD_SEQUENCES, n_frames=cfg.seqlen, seed=5)
        base = data.AMDDataset(root, crop_size=cfg.img_size, seq_len=cfg.seqlen)
        want, rec["pil_ms"] = _per_sequence_ms(lambda i: base[i], len(base))
        _, rec["pil_raw_ms"] = _per_sequence_ms(
            lambda i: base.load_sequence_raw(base.seq_names[i]), len(base))
        argv = ["eval", "--data-root", root, "--loader", "native", "--device-preprocess",
                "--max-sequences", str(LOAD_SEQUENCES), "--output-dir", os.path.join(tmp, "out")]
        if not built:
            refused = []
            for name, make in (
                    ("NativeLoaderDataset", lambda: NativeLoaderDataset(base)),
                    ("DevicePreprocessDataset(decode='native')",
                     lambda: data.DevicePreprocessDataset(base, decode="native", device=dev)),
                    ("cli eval --loader native --device-preprocess", lambda: cli.main(argv))):
                try:
                    make()
                except RuntimeError as exc:
                    if native.build_error() not in str(exc):
                        raise SmokeError(f"load: {name} raised without the build error: {exc}")
                    refused.append(name)
                    continue
                raise SmokeError(f"load: {name} ran without the native library")
            print(f"load (b), (c): NOT RUN: the native library does not build on this machine "
                  f"(the compiler's error above); checked instead that {', '.join(refused)} "
                  f"raise with that error and never fall back to PIL; the PIL path takes "
                  f"{rec['pil_ms']:.1f} ms per sequence on the host ({rec['pil_raw_ms']:.1f} ms "
                  f"to decode alone), on {smi}", flush=True)
        else:
            nds = NativeLoaderDataset(base)
            got, rec["native_ms"] = _per_sequence_ms(lambda i: nds[i], len(base))
            if not all(_same_sample(np, g, w) for g, w in zip(got, want)):
                raise SmokeError("load (b): NativeLoaderDataset's samples are not the PIL path's")
            nat = data.DevicePreprocessDataset(base, decode="native", keep_on_device=True,
                                               device=dev)
            _, rec["native_raw_ms"] = _per_sequence_ms(lambda i: nat._load_raw(base.seq_names[i]),
                                                       len(base))
            pil = data.DevicePreprocessDataset(base, decode="pil", keep_on_device=True, device=dev)
            for i in range(len(base)):
                a, b = nat[i], pil[i]
                wait_ready(a)
                wait_ready(b)
                if not torch.equal(a.images, b.images):
                    raise SmokeError(f"load (b): sequence {i}: decode='native' on the card is "
                                     "not decode='pil'")
            _reset(counters)
            t0 = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            rec["cli_s"] = time.perf_counter() - t0
            with open(os.path.join(tmp, "out", "test_results.csv")) as f:
                rows = list(csv.DictReader(f))
            bad = [k for row in rows for k, v in row.items() if not math.isfinite(float(v))]
            if len(rows) != 1 or bad or sum(_launches(counters).values()) == 0:
                raise SmokeError(f"load (c): {len(rows)} rows, not finite {bad}, launches "
                                 f"{_launches(counters)}")
            print(f"load (b): {LOAD_SEQUENCES} sequences of {cfg.seqlen} frames: "
                  f"NativeLoaderDataset equals the PIL path bit for bit, {rec['native_ms']:.1f} "
                  f"ms per sequence against PIL's {rec['pil_ms']:.1f}; decode alone "
                  f"{rec['native_raw_ms']:.1f} against {rec['pil_raw_ms']:.1f}; "
                  f"decode='native' on the card equals decode='pil' bit for bit; (c) cli eval "
                  f"--loader native --device-preprocess {rec['cli_s']:.1f} s, CSV finite, "
                  f"launches {_launches(counters)}, on {smi}", flush=True)
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"load: phase 13 in {rec['seconds']:.1f} s, on {smi}", flush=True)
    return rec


# phase 14: scene geometry (twoview/ and utils/dense_depth.py) on the card.
# The scene of the JAX package's 16-camera done-criterion test
# (tests/test_scene_ba_staged.py:150-196) at the main path's track count:
# cameras on an arc around a cloud, default_kmat(512, 512), 0.3 px of
# noise, 15 % of the tracks replaced by uniform pixels, the poses perturbed
SCENE_S, SCENE_N, SCENE_IMG = 16, 512, 512
SCENE_NOISE, SCENE_CORRUPT, SCENE_ROT, SCENE_TRANS = 0.3, 0.15, 0.02, 0.05
SCENE_BA_ITERS, SCENE_BA_ROUNDS, SCENE_MAX_REPROJ = 12, 2, 3.0
# that test's gates (tests/test_scene_ba_staged.py:170-195): median rotation
# error (degrees), median |t error|, share of corrupted tracks kept valid
# (below), of clean tracks kept valid (above), median Umeyama-aligned point
# error
SCENE_GATES = dict(rot_deg=0.5, t=0.05, corrupted_valid=0.2, clean_valid=0.9, aligned=0.02)
# the card against the port on the CPU, both f32 (cuSOLVER, cuBLAS, LAPACK
# and MKL round differently, so an SVD's null vector or a decision at a
# threshold may differ in the last bits): F, E and H after unit norm and
# sign, each EPnP and PnP pose's R and t, or GEOM_COND times that result's
# own f32 error (the CPU's f32 against its f64 on the same sample: a
# minimal sample's null vector is only as exact as the sample is well
# conditioned), whichever is larger;
# rotations of a BA or the scene (radians), their translations and points
# (of the scene's extent), masks (share of equal entries); a 5-point or
# 7-point candidate counts as a real solution where its constraints vanish
# within GEOM_REAL
GEOM_MODEL = 1e-4
GEOM_POSE = 1e-4
GEOM_COND = 4.0
# the 7- and 5-point solvers' real solutions, as sets: each takes a basis of
# a 2-D or 4-D null space of a matrix of (for the 7-point, unnormalized)
# pixel products, which cuSOLVER's Jacobi SVD and LAPACK resolve with
# different errors, and solves a polynomial in f32 in that basis. Each of
# the CPU's f64 real solutions is matched to the nearest candidate of the
# card and of the CPU's f32; at the median and at GEOM_SET_QUANTILE the
# card's distance is held within GEOM_COND times the CPU's (floor
# GEOM_MODEL): the card as exact as the CPU, the tail printed
GEOM_SET_QUANTILE = 0.9
GEOM_ROT = 1e-3
GEOM_EXTENT = 1e-3
GEOM_MASKS = 0.99
GEOM_REAL = 1e-4
# the aligned dense depth against the reconstruction's sparse depths
# (median relative error): the disparity is an exact affine map of the true
# inverse depths, so only the reconstruction's own error remains
DEPTH_REL = 0.01
GEOM_HYPOTHESES = 64  # minimal samples per solver in (a)
GEOM_BA_N = 128  # tracks of (a)'s bundle adjustment


def _quat_np(np, axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def _rotmat_np(np, q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def make_scene(np, s=SCENE_S, n=SCENE_N, img=SCENE_IMG, seed=7):
    """The done-criterion scene (tests/test_scene_ba_staged.py:45-76,
    150-167) in numpy f32, with default_kmat(img, img)'s intrinsics (focal
    img, the principal point at the center): cameras on an arc (row
    convention x_cam = x @ R + T) looking at a cloud near the origin, tracks
    with SCENE_NOISE px of noise, the first SCENE_CORRUPT of them replaced
    by uniform pixels, the poses perturbed (camera 0 kept)."""
    rng = np.random.default_rng(seed)
    k = np.array([[img, 0, img / 2], [0, img, img / 2], [0, 0, 1]], np.float64)
    pts = rng.uniform(-1.0, 1.0, size=(n, 3))
    pts[:, 2] *= 0.5
    q = np.stack([_quat_np(np, [0, 1, 0], (i - s / 2) * 0.04) for i in range(s)])
    r = np.stack([_rotmat_np(np, x) for x in q])
    c = np.stack([[np.sin((i - s / 2) * 0.04) * 4.0, 0.1 * i / s, -np.cos((i - s / 2) * 0.04) * 4.0]
                  for i in range(s)])
    t = -np.einsum("sj,sji->si", c, r)
    cam = np.einsum("nj,sji->sni", pts, r) + t[:, None]
    pix = cam @ k.T
    tracks = pix[..., :2] / pix[..., 2:] + rng.normal(size=(s, n, 2)) * SCENE_NOISE
    n_out = int(round(n * SCENE_CORRUPT))
    tracks[:, :n_out] = rng.uniform(0, img, size=(s, n_out, 2))
    q0 = q + rng.normal(size=q.shape) * SCENE_ROT
    q0 /= np.linalg.norm(q0, axis=-1, keepdims=True)
    t0 = t + rng.normal(size=t.shape) * SCENE_TRANS
    q0[0], t0[0] = q[0], t[0]
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return dict(q=f32(q), t=f32(t), q0=f32(q0), t0=f32(t0), k=f32(k), pts=f32(pts),
                depth=f32(cam[..., 2]), tracks=f32(tracks), vis=np.ones((s, n), np.float32),
                n_out=n_out)


def _rot_err(np, qa, qb):
    """Angles (radians) between quaternions [..., 4], sign-blind."""
    qa = np.asarray(qa, np.float64)
    qb = np.asarray(qb, np.float64)
    qa = qa / np.linalg.norm(qa, axis=-1, keepdims=True)
    qb = qb / np.linalg.norm(qb, axis=-1, keepdims=True)
    return 2 * np.arccos(np.clip(np.abs((qa * qb).sum(-1)), 0.0, 1.0))


def _unit_np(np, m):
    """Matrices [..., 3, 3] scaled to unit norm, signed so that the largest
    entry of each is positive."""
    m = np.asarray(m, np.float64).reshape(*np.shape(m)[:-2], 9)
    m = m / np.linalg.norm(m, axis=-1, keepdims=True)
    big = np.take_along_axis(m, np.abs(m).argmax(-1)[..., None], -1)
    return m * np.sign(big)


def _set_distances(np, got, want, exact, residual):
    """For every real candidate of ``want`` (its ``residual`` within
    GEOM_REAL), the distance to the nearest candidate of ``got`` and to the
    nearest of ``exact``, after unit norm and sign: [(d_got, d_exact)]."""
    out = []
    for g, w, x, res in zip(got, want, exact, residual):
        ug, uw, ux = _unit_np(np, g), _unit_np(np, w), _unit_np(np, x)
        for e, r in zip(uw, res):
            if r < GEOM_REAL:
                out.append((float(np.abs(ug - e).max(-1).min()), float(np.abs(ux - e).max(-1).min())))
    return out


def _epipolar_residual(np, e, x1, x2):
    """max |x2^T E x1| over a sample and |det E| of unit-norm candidates:
    e [H, C, 3, 3], x [H, k, 2] -> [H, C]."""
    e = np.asarray(e, np.float64)
    e = e / np.linalg.norm(e, axis=(-2, -1), keepdims=True)
    x1h = np.concatenate([x1, np.ones(x1.shape[:-1] + (1,))], -1)
    x2h = np.concatenate([x2, np.ones(x2.shape[:-1] + (1,))], -1)
    epi = np.abs(np.einsum("hni,hcij,hnj->hcn", x2h, e, x1h)).max(-1)
    return np.maximum(epi, np.abs(np.linalg.det(e)))


def _essential_residual(np, e, x1, x2):
    """_epipolar_residual and the essential constraint 2 E E^T E - tr(E E^T) E
    of unit-norm candidates, whichever is larger: [H, C]."""
    u = np.asarray(e, np.float64)
    u = u / np.linalg.norm(u, axis=(-2, -1), keepdims=True)
    eet = u @ np.swapaxes(u, -1, -2)
    g = 2 * eet @ u - np.trace(eet, axis1=-2, axis2=-1)[..., None, None] * u
    return np.maximum(_epipolar_residual(np, e, x1, x2), np.abs(g).max((-2, -1)))


def _samples(np, rng, h, n, k):
    return np.argsort(rng.random((h, n)), axis=-1)[:, :k]


def _allowance(np, floor, gap):
    """Per result: the larger of ``floor`` and GEOM_COND times its f32
    error against f64 on the CPU."""
    return np.maximum(floor, GEOM_COND * np.asarray(gap))


def solver_checks(torch, np, tv, dev, smi):
    """Phase 14 (a): each solver on the card against the port on the CPU on
    the same minimal samples: 8-point, 7-point, homography DLT, 5-point
    (real solutions as sets, and its 120 shifted-QR steps timed), EPnP, LM
    PnP over the 16 cameras and one bundle adjustment. A minimal sample's
    f32 solution is only as exact as the sample is well conditioned, so each
    result is held to the CPU's f32 within the larger of a floor (GEOM_MODEL,
    GEOM_POSE) and GEOM_COND times that result's own f32 error, the CPU's
    f32 against its f64 on the same sample (printed). Returns the records."""
    from comet_tpu_torch.twoview import solvers

    sc = make_scene(np, s=4, n=SCENE_N, seed=21)
    r = np.stack([_rotmat_np(np, x) for x in sc["q"]])
    cam = np.einsum("nj,sji->sni", sc["pts"], r) + sc["t"][:, None]
    kinv = np.linalg.inv(sc["k"])
    n_out = sc["n_out"]
    x1, x2 = sc["tracks"][0, n_out:], sc["tracks"][2, n_out:]
    n1 = (np.concatenate([x1, np.ones((len(x1), 1), np.float32)], 1) @ kinv.T)[:, :2]
    n2 = (np.concatenate([x2, np.ones((len(x2), 1), np.float32)], 1) @ kinv.T)[:, :2]
    rng = np.random.default_rng(3)
    h = GEOM_HYPOTHESES
    s8, s7, s5, s4 = (_samples(np, rng, h, len(x1), k) for k in (8, 7, 5, 4))
    # a plane for the homography: the cloud flattened to z = 0 seen by
    # cameras 0 and 2
    plane = sc["pts"].copy()
    plane[:, 2] = 0.0
    pc = np.einsum("nj,sji->sni", plane, r) + sc["t"][:, None]
    pp = pc @ sc["k"].T
    p1, p2 = (np.ascontiguousarray(pp[i, :, :2] / pp[i, :, 2:], np.float32) for i in (0, 2))
    pts_cam = np.ascontiguousarray(sc["pts"], np.float32)
    norm3 = (cam[..., :2] / cam[..., 2:]).astype(np.float32)  # normalized coordinates

    def to_np(x):
        if isinstance(x, tuple):
            parts = [to_np(v) for v in x]
            return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
        return x.detach().cpu().numpy().astype(np.float64)

    def both(fn, *arrays):
        """fn on the card, on the CPU, and on the CPU in f64: (card, CPU,
        CPU f64, the card's device ms)."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        on = [torch.from_numpy(a).to(dev) for a in arrays]
        _, device_ms = _time_call(torch, lambda: fn(*on), reps=3)
        return (to_np(fn(*on)), to_np(fn(*(torch.from_numpy(a) for a in arrays))),
                to_np(fn(*(torch.from_numpy(a.astype(np.float64)) for a in arrays))), device_ms)

    records = []

    def record(name, shape, err, allowed, gap, ms, extra="", share=1.0):
        """err and allowed per result; the check passes where at least
        ``share`` of the results are within their allowance."""
        err, allowed = np.asarray(err, np.float64), np.asarray(allowed, np.float64)
        within = float((err <= allowed).mean()) if err.size else 1.0
        ok = within >= share
        worst = float((err / allowed).max()) if err.size else 0.0
        records.append(dict(name=name, shape=shape, err=float(err.max(initial=0.0)),
                            worst_share=worst, within=within, f32_gap=float(np.max(gap, initial=0.0)),
                            ms=ms, ok=ok))
        print(f"scene (a): {name} {shape}: card against CPU up to {err.max(initial=0.0):.3e} "
              f"(median {float(np.median(err)) if err.size else 0.0:.3e}), {within:.4f} of the "
              f"results within their allowance (limit {share}), the largest {worst:.3f} of it "
              f"(the CPU's f32 against f64: median "
              f"{float(np.median(gap)) if np.size(gap) else 0.0:.3e}, largest "
              f"{np.max(gap, initial=0.0):.3e}); card {ms:.3f} ms{extra}", flush=True)
        if not ok:
            print(f"scene (a): {name} FAILED: {within:.4f} of the results within their allowance "
                  f"(limit {share}); the largest difference {err.max():.3e}", flush=True)

    def models(name, shape, got, want, exact, ms):
        d = np.abs(_unit_np(np, got) - _unit_np(np, want)).max(-1).reshape(-1)
        gap = np.abs(_unit_np(np, want) - _unit_np(np, exact)).max(-1).reshape(-1)
        record(name, shape, d, _allowance(np, GEOM_MODEL, gap), gap, ms)

    def sets(name, shape, got, want, exact, residual, ms, extra=""):
        """Real solutions as sets: for each of the CPU's f64 real solutions
        (``residual`` within GEOM_REAL), the distance to the card's nearest
        candidate and to the CPU f32's; the card's distances at the median
        and at GEOM_SET_QUANTILE within GEOM_COND times the CPU's (or
        GEOM_MODEL)."""
        pairs = _set_distances(np, got, exact, exact, residual)
        card = np.array([p[0] for p in pairs])
        cpu = np.array([p[0] for p in _set_distances(np, want, exact, exact, residual)])
        qs = (0.5, GEOM_SET_QUANTILE)
        got_q = [float(np.quantile(card, q)) for q in qs]
        want_q = [float(np.quantile(cpu, q)) for q in qs]
        ok = all(g <= max(GEOM_MODEL, GEOM_COND * w) for g, w in zip(got_q, want_q))
        records.append(dict(name=name, shape=shape, card_quantiles=got_q, cpu_quantiles=want_q,
                            card_max=float(card.max()), cpu_max=float(cpu.max()), ms=ms, ok=ok))
        print(f"scene (a): {name} {shape}: {len(pairs)} real solutions in f64 on the CPU; the "
              f"nearest candidate's distance at the median and {GEOM_SET_QUANTILE}: card "
              f"{got_q[0]:.3e}, {got_q[1]:.3e} (largest {card.max():.3e}), CPU f32 "
              f"{want_q[0]:.3e}, {want_q[1]:.3e} (largest {cpu.max():.3e}); card {ms:.3f} ms"
              f"{extra}", flush=True)
        if not ok:
            print(f"scene (a): {name} FAILED: the card's real solutions at the median and "
                  f"{GEOM_SET_QUANTILE} {got_q} against the CPU's {want_q} (limit {GEOM_COND} x, "
                  f"floor {GEOM_MODEL})", flush=True)

    def poses(name, shape, got, want, exact, ms, extra=""):
        d = np.maximum(np.abs(got[0] - want[0]).max((-2, -1)), np.abs(got[1] - want[1]).max(-1))
        gap = np.maximum(np.abs(want[0] - exact[0]).max((-2, -1)),
                         np.abs(want[1] - exact[1]).max(-1))
        record(name, shape, d.reshape(-1), _allowance(np, GEOM_POSE, gap).reshape(-1),
               gap.reshape(-1), ms, extra)

    got, want, exact, ms = both(tv.run_8point, x1[s8], x2[s8])
    models("8-point", list(s8.shape), got, want, exact, ms)
    got, want, exact, ms = both(tv.run_7point, x1[s7], x2[s7])
    sets("7-point", list(s7.shape), got, want, exact,
         _epipolar_residual(np, exact, x1[s7], x2[s7]), ms)
    got, want, exact, ms = both(tv.run_homography_dlt, p1[s4], p2[s4])
    models("homography DLT", list(s4.shape), got, want, exact, ms)
    got, want, exact, ms = both(tv.run_5point, n1[s5], n2[s5])
    basis = torch.randn(h, 4, 3, 3, generator=torch.Generator().manual_seed(1))
    act = solvers._action_matrix(basis)
    qr_card = _time_call(torch, lambda: solvers._qr_eigvals(act.to(dev)), reps=3)[1]
    t0 = time.perf_counter()
    solvers._qr_eigvals(act)
    qr_cpu = (time.perf_counter() - t0) * 1e3
    sets("5-point", list(s5.shape), got, want, exact,
         _essential_residual(np, exact, n1[s5], n2[s5]), ms,
         f"; its 120 shifted-QR steps on [{h}, 10, 10]: card {qr_card:.1f} ms, CPU "
         f"{qr_cpu:.1f} ms")
    records[-1].update(qr_card_ms=qr_card, qr_cpu_ms=qr_cpu)
    got, want, exact, ms = both(tv.efficient_pnp, pts_cam, norm3[1])
    poses("EPnP", [SCENE_N], got, want, exact, ms)
    big = make_scene(np, seed=22)
    clean = slice(big["n_out"], None)  # a corrupted track makes PnP ill-posed
    got, want, exact, ms = both(lambda a, b, k: tv.solve_pnp_batched(a, b, k),
                                np.broadcast_to(big["pts"][clean],
                                                (SCENE_S,) + big["pts"][clean].shape),
                                big["tracks"][:, clean], big["k"])
    poses("LM PnP", [SCENE_S, SCENE_N - big["n_out"]], got, want, exact, ms)

    # one bundle adjustment (at a quarter of the tracks: (c) adjusts the
    # whole scene on both devices), within GEOM_ROT and GEOM_EXTENT
    small = make_scene(np, n=GEOM_BA_N, seed=23)
    mask = small["vis"].copy()
    mask[:, :small["n_out"]] = 0.0
    proj = tv.projection_matrices(*(torch.from_numpy(small[x]) for x in ("q0", "t0", "k")))
    points0 = tv.triangulate_tracks(proj, torch.from_numpy(small["tracks"]),
                                    torch.from_numpy(mask)).numpy()
    ba = lambda q, t, p, o, m, k: tv.bundle_adjust(q, t, p, o, m, k, iters=SCENE_BA_ITERS,
                                                   huber_delta=SCENE_MAX_REPROJ)
    got, want, exact, ms = both(ba, small["q0"], small["t0"], points0, small["tracks"], mask,
                                small["k"])
    extent = float(np.abs(small["pts"]).max() + np.abs(small["t"]).max())
    share = lambda a, b: max(float(_rot_err(np, a.q, b.q).max()) / GEOM_ROT,
                             float(np.abs(a.points - b.points).max()) / (GEOM_EXTENT * extent),
                             float(np.abs(a.t - b.t).max()) / (GEOM_EXTENT * extent))
    record("bundle adjustment", [SCENE_S, GEOM_BA_N], [share(got[0], want[0])], [1.0],
           [share(want[0], exact[0])], ms,
           f" (shares: the largest of rotation / {GEOM_ROT} rad, translation and point error / "
           f"{GEOM_EXTENT} of the extent {extent:.2f}); rms card {float(got[1]):.4f} px, CPU "
           f"{float(want[1]):.4f} px")
    card_defaults_check(torch, np, tv, x1, x2, sc["k"])
    return records


def card_defaults_check(torch, np, tv, x1, x2, k):
    """Numpy in, the card by default: default_kmat and every registered
    robust estimator with no device given run on the card."""
    data = {"m_kpts0": x1.astype(np.float64), "m_kpts1": x2.astype(np.float64), "K0": k, "K1": k}
    if tv.default_kmat(SCENE_IMG, SCENE_IMG).device.type != "cuda":
        raise SmokeError("scene (a): default_kmat did not default to the card")
    for kind, name in tv.list_estimators():
        out = tv.get_estimator(kind, name, {"num_hypotheses": GEOM_HYPOTHESES})(data)
        placed = {out["inliers"].device.type} | {m.device.type for m in (
            out["M_0to1"] if isinstance(out["M_0to1"], tuple) else (out["M_0to1"],))}
        if placed != {"cuda"} or not out["success"]:
            raise SmokeError(f"scene (a): estimator {kind}/{name} on numpy inputs: success "
                             f"{out['success']}, outputs on {placed}")
        print(f"scene (a): estimator {kind}/{name} on numpy inputs ran on the card: "
              f"{int(out['inliers'].sum())} of {len(x1)} inliers", flush=True)


class _StageClock:
    """Times the stages of reconstruct_scene where it calls them: wraps the
    named functions of ``twoview.scene_ba`` so that each outermost call is
    timed (host clock, synchronized on the card), its host synchronizations
    counted in torch's sync debug mode and its peak memory read."""

    STAGES = dict(init_ba="init BA", refine_poses="refine poses",
                  triangulate_tracks_ransac="RANSAC triangulation", bundle_adjust="global BA",
                  filter_points3d="filter")

    def __init__(self, torch, dev):
        self.torch, self.dev, self.records, self.depth = torch, dev, [], 0

    def measure(self, label, fn, *args, **kwargs):
        import warnings

        torch = self.torch
        cuda = self.dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn(*args, **kwargs)
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode("default")
                    torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        where = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                        if SYNC_WARNING in str(w.message))
        self.records.append(dict(stage=label, ms=ms, syncs=sum(where.values()), where=dict(where),
                                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30 if cuda
                                 else None))
        return out

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            if self.depth:  # a stage's own calls belong to it
                return fn(*args, **kwargs)
            self.depth += 1
            try:
                return self.measure(self.STAGES[name], fn, *args, **kwargs)
            finally:
                self.depth -= 1

        return timed

    def run(self, scene_ba, fn, *args, **kwargs):
        saved = {name: getattr(scene_ba, name) for name in self.STAGES}
        for name, f in saved.items():
            setattr(scene_ba, name, self.wrap(name, f))
        try:
            return self.measure("whole", fn, *args, **kwargs)
        finally:
            for name, f in saved.items():
                setattr(scene_ba, name, f)


def _recon_to(torch, rec, dev):
    from comet_tpu_torch.twoview import BAState, SceneReconstruction

    return SceneReconstruction(state=BAState(*(x.to(dev) for x in rec.state)),
                               valid_tracks=rec.valid_tracks.to(dev),
                               inlier_mask=rec.inlier_mask.to(dev), rms=rec.rms.to(dev))


def _scene_gates(torch, np, sc, rec):
    """tests/test_scene_ba_staged.py:170-195's gates on a reconstruction
    (on the CPU): {name: (value, limit, passed)}."""
    from comet_tpu_torch.twoview import corresponding_points_alignment

    n_out = sc["n_out"]
    valid = rec.valid_tracks.numpy()
    kept = rec.state.points.numpy()[valid]
    want = sc["pts"][valid]
    sim = corresponding_points_alignment(torch.from_numpy(kept), torch.from_numpy(want))
    aligned = (float(sim.s) * torch.from_numpy(kept) @ sim.r + sim.t).numpy()
    g = SCENE_GATES
    values = dict(
        rot_deg=(float(np.median(np.degrees(_rot_err(np, rec.state.q.numpy(), sc["q"])))),
                 g["rot_deg"], "<"),
        t=(float(np.median(np.abs(rec.state.t.numpy() - sc["t"]))), g["t"], "<"),
        corrupted_valid=(float(valid[:n_out].mean()), g["corrupted_valid"], "<"),
        clean_valid=(float(valid[n_out:].mean()), g["clean_valid"], ">"),
        aligned=(float(np.median(np.linalg.norm(aligned - want, axis=-1))), g["aligned"], "<"))
    return {k: (v, lim, v < lim if op == "<" else v > lim) for k, (v, lim, op) in values.items()}


def scene_phase(torch, np, dev, smi):
    """Phase 14: scene geometry on the card. (a) solver_checks; (b) the
    done-criterion scene (make_scene) on the card: estimate_preliminary_cameras
    and reconstruct_scene, held to the test's gates, its COLMAP model written
    and read back, and a disparity map made from the true depths aligned to
    the reconstruction by dense_depth; (c) the same scene through the port on
    the CPU (the preliminary RANSAC replaying the card's samples), the card
    held to it; (d) per stage the card's and the CPU's ms, the card's host
    synchronizations and peak memory. Returns the phase's record."""
    import os
    import tempfile

    from comet_tpu_torch import twoview as tv
    from comet_tpu_torch.geometry import quat_to_matrix
    from comet_tpu_torch.twoview import estimators, scene_ba
    from comet_tpu_torch.utils import colmap_io, dense_depth

    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        raise SmokeError("scene: TF32 matmuls are on; the geometry must run in f32")
    rec = dict(solvers=solver_checks(torch, np, tv, dev, smi))
    # every part runs and prints before the phase fails
    failures = [f"(a) {r['name']}" for r in rec["solvers"] if not r["ok"]]
    sc = make_scene(np)
    cpu = torch.device("cpu")
    on = {k: torch.from_numpy(v).to(dev) for k, v in sc.items() if isinstance(v, np.ndarray)}
    off = {k: torch.from_numpy(v) for k, v in sc.items() if isinstance(v, np.ndarray)}
    kmat = tv.default_kmat(SCENE_IMG, SCENE_IMG, device=dev)
    if not np.array_equal(kmat.cpu().numpy(), sc["k"]):
        raise SmokeError(f"scene: default_kmat is {kmat.cpu().numpy()}, not the scene's K")
    recon_args = dict(ba_iters=SCENE_BA_ITERS, ba_rounds=SCENE_BA_ROUNDS,
                      max_reproj_error=SCENE_MAX_REPROJ)

    def preliminary(d):
        return tv.estimate_preliminary_cameras(d["tracks"][None], d["vis"][None], SCENE_IMG,
                                               SCENE_IMG)

    def reconstruct(d, k):
        return tv.reconstruct_scene(d["q0"], d["t0"], d["tracks"], d["vis"], k, **recon_args)

    # (b) the card: a first run (allocator, cuSOLVER and cuBLAS handles), the
    # whole pipeline timed alone, then the staged run; the samples the
    # preliminary RANSAC drew are kept for the CPU to replay
    drawn = []
    draw = estimators.ransac_samples

    def keep_samples(*args, **kwargs):
        drawn.append(draw(*args, **kwargs))
        return drawn[-1]

    estimators.ransac_samples = keep_samples
    try:
        cams, prelim = preliminary(on)
    finally:
        estimators.ransac_samples = draw
    reconstruct(on, kmat)
    whole = _StageClock(torch, dev)
    got = whole.measure("whole", reconstruct, on, kmat)
    staged = _StageClock(torch, dev)
    staged.measure("preliminary", preliminary, on)
    staged.run(scene_ba, reconstruct, on, kmat)
    got_cpu = _recon_to(torch, got, cpu)
    gates = _scene_gates(torch, np, sc, got_cpu)
    for name, (value, limit, ok) in gates.items():
        print(f"scene (b): {name} {value:.4f} (gate {limit}){'' if ok else ' FAILED'}", flush=True)
    failures += [f"(b) gate {k}" for k, (_, _, ok) in gates.items() if not ok]
    # the preliminary poses are frame-0-relative, column convention: camera
    # i's rotation against the truth's R_i^T R_0 (R row convention)
    r_true = np.stack([_rotmat_np(np, x) for x in sc["q"]])
    r_rel = np.einsum("sji,jk->sik", r_true, r_true[0])
    prel_q = cams["q"][0].cpu()
    prel_err = np.degrees(np.arccos(np.clip((np.einsum(
        "sij,sij->s", quat_to_matrix(prel_q).numpy(), r_rel) - 1) / 2, -1.0, 1.0)))
    if not (np.isfinite(prel_err).all() and prel_q[0].tolist() == [1.0, 0.0, 0.0, 0.0]):
        failures.append(f"(b) preliminary rotations {prel_err}, frame 0 {prel_q[0]}")
    print(f"scene (b): preliminary cameras: median rotation error against the truth "
          f"{float(np.median(prel_err[1:])):.4f} deg, largest {float(prel_err.max()):.4f}",
          flush=True)

    # the COLMAP model of the card's reconstruction, written and read back
    with tempfile.TemporaryDirectory() as tmp:
        model = colmap_io.scene_to_colmap(got_cpu.state.q, got_cpu.state.t, sc["k"],
                                          sc["tracks"], got_cpu, (SCENE_IMG, SCENE_IMG))
        colmap_io.write_model_text(model, os.path.join(tmp, "sparse"))
        back = colmap_io.read_model_text(os.path.join(tmp, "sparse"))
        want_points = int(((got_cpu.inlier_mask & got_cpu.valid_tracks[None]).sum(0) >= 2).sum())
        if (len(back.images) != SCENE_S or len(back.points3d) != want_points
                or len(back.points3d) != len(model.points3d)):
            failures.append(f"(b) COLMAP model read back with {len(back.images)} images, "
                            f"{len(back.points3d)} points ({want_points} expected)")
        elif not np.allclose(np.stack([p.xyz for p in back.points3d.values()]),
                             np.stack([p.xyz for p in model.points3d.values()]), atol=1e-5):
            failures.append("(b) COLMAP points read back differ")

        # a disparity map made from the middle camera's true depths (an
        # affine map of their inverse, as a monocular network's is; the
        # arc's end cameras see the cloud partly outside the image), aligned
        # to the reconstruction's sparse depths in that camera
        n_out, view = sc["n_out"], SCENE_S // 2
        uv = np.round(sc["tracks"][view, n_out:]).astype(int)
        inside = (uv >= 0).all(-1) & (uv < SCENE_IMG).all(-1)
        disp = np.zeros((SCENE_IMG, SCENE_IMG), np.float32)
        disp[uv[inside, 1], uv[inside, 0]] = 0.7 / sc["depth"][view, n_out:][inside] + 0.05
        proj = tv.projection_matrices(got_cpu.state.q[view:view + 1],
                                      got_cpu.state.t[view:view + 1], off["k"])[0].numpy()
        ph = np.concatenate([got_cpu.state.points.numpy()[n_out:],
                             np.ones((SCENE_N - n_out, 1), np.float32)], 1) @ proj.T
        keep = got_cpu.valid_tracks.numpy()[n_out:] & inside
        uvd = np.concatenate([uv, ph[:, 2:]], 1)[keep].astype(np.float64)
        t0 = time.perf_counter()
        depth = dense_depth.align_disparity_to_sparse(disp, uvd)
        depth_ms = (time.perf_counter() - t0) * 1e3
        got_d = depth[uvd[:, 1].astype(int), uvd[:, 0].astype(int)]
        depth_err = float(np.median(np.abs(got_d - uvd[:, 2]) / uvd[:, 2]))
        dense_depth.write_colmap_array(depth, os.path.join(tmp, "depth.bin"))
        same = np.array_equal(dense_depth.read_colmap_array(os.path.join(tmp, "depth.bin")), depth)
        cloud, _ = dense_depth.unproject_depth_map(depth, sc["k"], proj[:, :3], proj[:, 3])
    if not (depth_err < DEPTH_REL and same and len(cloud) == int((depth > 0).sum())):
        failures.append(f"(b) dense depth: median relative error {depth_err:.4f}, COLMAP array "
                        f"read back equal {same}, {len(cloud)} points")
    print(f"scene (b): COLMAP model of {len(back.points3d)} points and {SCENE_S} images "
          f"written and read back; dense depth aligned to {len(uvd)} sparse depths in "
          f"{depth_ms:.1f} ms on the host, median relative error {depth_err:.5f} "
          f"(limit {DEPTH_REL})", flush=True)

    # (c) the same scene through the port on the CPU, the preliminary
    # RANSAC replaying the card's samples
    replay = [d.cpu() for d in drawn]
    estimators.ransac_samples = lambda *args, **kwargs: replay.pop(0)
    cpu_clock = _StageClock(torch, cpu)
    try:
        cams_cpu, prelim_cpu = cpu_clock.measure("preliminary", preliminary, off)
    finally:
        estimators.ransac_samples = draw
    want = cpu_clock.run(scene_ba, reconstruct, off, off["k"])
    extent = float(np.abs(sc["pts"]).max() + np.abs(sc["t"]).max())
    both_valid = got_cpu.valid_tracks.numpy() & want.valid_tracks.numpy()
    diffs = dict(
        preliminary_masks=float((prelim["fmat_inlier_mask"].cpu() ==
                                 prelim_cpu["fmat_inlier_mask"]).float().mean()),
        preliminary_rot=float(_rot_err(np, cams["q"].cpu().numpy(), cams_cpu["q"].numpy()).max()),
        rot=float(_rot_err(np, got_cpu.state.q.numpy(), want.state.q.numpy()).max()),
        t=float(np.abs(got_cpu.state.t.numpy() - want.state.t.numpy()).max()) / extent,
        points=float(np.abs(got_cpu.state.points.numpy()[both_valid]
                            - want.state.points.numpy()[both_valid]).max()) / extent,
        valid=float((got_cpu.valid_tracks == want.valid_tracks).float().mean()),
        inliers=float((got_cpu.inlier_mask == want.inlier_mask).float().mean()))
    limits = dict(preliminary_masks=GEOM_MASKS, preliminary_rot=GEOM_ROT, rot=GEOM_ROT,
                  t=GEOM_EXTENT, points=GEOM_EXTENT, valid=GEOM_MASKS, inliers=GEOM_MASKS)
    failed = {k: v for k, v in diffs.items()
              if (v < limits[k] if k in ("preliminary_masks", "valid", "inliers") else v > limits[k])}
    print(f"scene (c): the card against the CPU: {json.dumps(diffs)} (limits "
          f"{json.dumps(limits)}; masks as shares of equal entries, t and points as shares of "
          f"the extent {extent:.3f}); rms card {float(got.rms):.4f} px, CPU "
          f"{float(want.rms):.4f} px", flush=True)
    failures += [f"(c) {k} {v}" for k, v in failed.items()]

    # (d) per stage
    stages = []
    for card_r, cpu_r in zip(staged.records, cpu_clock.records):
        stages.append(dict(stage=card_r["stage"], card_ms=card_r["ms"], cpu_ms=cpu_r["ms"],
                           syncs=card_r["syncs"], peak_gib=card_r["peak_gib"],
                           where=card_r["where"]))
    w = whole.records[0]
    stages.append(dict(stage="whole, alone", card_ms=w["ms"], cpu_ms=None, syncs=w["syncs"],
                       peak_gib=w["peak_gib"], where=w["where"]))
    for s in stages:
        print(f"scene (d): {s['stage']}: card {s['card_ms']:.1f} ms, "
              + (f"CPU {s['cpu_ms']:.1f} ms, " if s["cpu_ms"] is not None else "")
              + f"{s['syncs']} host syncs {s['where']}, peak "
              + (f"{s['peak_gib']:.3f} GiB" if s["peak_gib"] is not None else "not measured"),
              flush=True)
    rec.update(stages=stages, gates=gates, diffs=diffs, depth_err=depth_err,
               seconds=time.perf_counter() - t_phase)
    print(f"scene: phase 14 in {rec['seconds']:.1f} s, on {smi}", flush=True)
    if failures:
        raise SmokeError(f"scene: {'; '.join(failures)}")
    return rec


# phase 15: the point-matching stack (matching/, models/superpoint.py; no
# kernel). Glue-factory's HPatches evaluation resizes to 480 px; the
# experiments take 512 keypoints, LightGlue and SuperGlue depth 9 at width 256.
MATCH_IMG = 480
MATCH_KP = 512
MATCH_PAIRS = 8
MATCH_EXPERIMENTS = ("superpoint+nn", "sift+nn", "superpoint+lightglue_homography",
                     "superpoint+superglue")
# random LightGlue and SuperGlue weights match nothing over SuperPoint's
# descriptors (both filter thresholds), so (b) loads these two a checkpoint:
# every layer's update zeroed and the final projections a scaled identity,
# which scores pairs by MATCH_COSINE_SCALE x their descriptors' cosine (a
# random SuperPoint's descriptors are nearly parallel: cosines ~0.975, the
# best two of a row ~0.001 apart)
MATCH_LOADED = ("superpoint+lightglue_homography", "superpoint+superglue")
MATCH_COSINE_SCALE = 2000.0
# the adaptive LightGlue of (a): depth / width confidence
MATCH_ADAPTIVE = (0.95, 0.99)
# card against CPU in f32 (TF32 off), relative to the largest |value| (at
# least 1): network outputs and the log assignments
MATCH_TOL = 1e-4
# an argmax or top-k may differ between the card and the CPU only where the
# CPU's two candidates are closer than this (log assignment, or keypoint
# score relative to the largest)
MATCH_NEAR_TIE = 1e-4
# (b): the row at MATCH_CPU_PAIRS pairs on the card against the same command
# on the CPU (made there on the CPU: ~1 s per SuperPoint image on the card
# machine's CPU), the CPU's RANSAC replaying the card's samples: the match
# count within 1 %, precision and recall within 0.01; where every pair
# replayed its samples the corner error within 1e-3 relative and the
# accuracy buckets equal, else (a near-tie changed a pair's match count, so
# its fit drew other samples) within 10 % and one pair
MATCH_CPU_PAIRS = 3
MATCH_ROW = dict(num_matches=0.01, prec_recall=0.01, H_error=1e-3, H_error_redrawn=0.1)


def _keypoint_diffs(np, got_kp, got_sc, want_kp, want_sc, window):
    """Keypoints of the card (got) against the CPU (want): (disagreements,
    near-ties among them, slots reordered where the sets agree). A keypoint
    in one set only is a near-tie where its score is 0 (the padding, an exact
    tie), within MATCH_NEAR_TIE of the other set's last score (the top-k's
    cut), or of a keypoint of the other set within ``window`` pixels (the
    suppression's comparisons: a plateau of nearly equal scores)."""
    tol = MATCH_NEAR_TIE * max(float(np.abs(want_sc).max()), 1e-12)

    def key(kp):
        return [tuple(p) for p in kp.astype(np.int64)]

    gk, wk = key(got_kp), key(want_kp)
    diff = near = 0
    for pts, scores, other_kp, other_sc in ((gk, got_sc, want_kp, want_sc),
                                             (wk, want_sc, got_kp, got_sc)):
        others = set(key(other_kp))
        for p, s in zip(pts, scores):
            if p in others:
                continue
            diff += 1
            close = np.abs(other_kp - np.asarray(p)).max(axis=1) <= window
            if (s == 0 or abs(s - other_sc[-1]) <= tol
                    or (close.any() and np.abs(other_sc[close] - s).min() <= tol)):
                near += 1
    order = sum(a != b for a, b in zip(gk, wk))  # slots, with the sets equal
    return diff, near, order


def _gap(np, v):
    """The distance between the two largest entries of v."""
    top = np.sort(v)[-2:]
    return top[1] - top[0]


def _match_diffs(np, got, want, la_got, la_want):
    """matches0 of the card against the CPU: (disagreements, near-ties), a
    near-tie where a row or a column it involves has its two best log
    assignment entries within MATCH_NEAR_TIE on either device."""
    rows = np.nonzero(got != want)[0]
    near = 0
    for i in rows:
        gaps = [_gap(np, la[i]) for la in (la_got, la_want)]
        for j in {int(got[i]), int(want[i])} - {-1}:
            gaps += [_gap(np, la[:, j]) for la in (la_got, la_want)]
        near += min(gaps) <= MATCH_NEAR_TIE
    return len(rows), near


def _argmax_diffs(np, la_got, la_want):
    """Each row's argmax of the inner log assignment, card against CPU:
    (rows that differ, near-ties among them: the CPU's or the card's best two
    entries of the row within MATCH_NEAR_TIE)."""
    rows = np.nonzero(la_got.argmax(1) != la_want.argmax(1))[0]
    return len(rows), int(sum(min(_gap(np, la_got[i]), _gap(np, la_want[i])) <= MATCH_NEAR_TIE
                              for i in rows))


def _rel_err(np, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


def _cosine_weights(torch, module):
    """``module``'s state with every layer's update zeroed and its final
    projections MATCH_COSINE_SCALE^(1/2) x (dim^(1/4)) x identity: the
    matcher then scores pairs by MATCH_COSINE_SCALE x their descriptors'
    cosine (the checkpoint (b) loads)."""
    sd = {k: v.clone() for k, v in module.state_dict().items()}
    # both matchers divide the projections' product by sqrt(dim)
    scale = MATCH_COSINE_SCALE ** 0.5 * module.dim ** 0.25
    for k in sd:
        last = k.split(".")[-2] if "." in k else k
        if k.startswith(("input_proj", "final_proj")) or ".final_proj." in k:
            # the input projection embeds narrower descriptors in the first columns
            eye = torch.eye(*sd[k].shape) if k.endswith("weight") else None
            sd[k] = eye * (scale if "final_proj" in k else 1.0) if eye is not None else \
                torch.zeros_like(sd[k])
        elif last in ("ffn_lin2", "merge2") or k.startswith("kenc.out."):
            sd[k] = torch.zeros_like(sd[k])
        elif ".matchability." in k:
            sd[k] = torch.zeros_like(sd[k]) if k.endswith("weight") else torch.full_like(sd[k], 8.0)
    if "bin_score" in sd:
        sd["bin_score"] = torch.tensor(1.0)
    return sd


def _adaptive_biases(torch, module):
    """Token-confidence and matchability biases that make the adaptive
    LightGlue act on random weights: layer 0 partly confident, layer 1 all
    confident (it stops there), matchabilities near 1 - width confidence
    (it prunes)."""
    with torch.no_grad():
        for i, tc in enumerate(module.token_confidence):
            tc.token.bias.fill_(1.8 if i == 0 else 12.0)
            module.log_assignment[i].matchability.bias.fill_(-4.6)
    return module


def match_module_checks(torch, np, dev, smi):
    """Phase 15 (a): SuperPoint, SIFT, LightGlue (adaptivity off and on) and
    SuperGlue on the card against the port on the CPU, same weights and
    inputs, at full width. Returns the records."""
    import copy

    from comet_tpu_torch.matching import benchmarks, lightglue, sift, superglue
    from comet_tpu_torch.matching.extractors import build_superpoint
    from comet_tpu_torch.models.blocks import init_params

    cpu = torch.device("cpu")
    img0, img1, _ = benchmarks.make_synthetic_pairs(1, (MATCH_IMG, MATCH_IMG), seed=0,
                                                    device=cpu)[0]
    records = []

    def record(name, ok, **fields):
        records.append(dict(name=name, ok=ok, **fields))
        print(f"matching (a): {name}: {json.dumps(fields)}{'' if ok else ' FAILED'}", flush=True)

    # SuperPoint: 512 keypoints of a 480 x 480 image
    sp = build_superpoint(MATCH_KP, seed=0)
    sp_card = copy.deepcopy(sp).to(dev)
    with torch.no_grad():
        feats = {}
        for side, img in (("0", img0), ("1", img1)):
            want = sp(img[..., 0])
            got = sp_card(img[..., 0].to(dev))
            feats[side] = want
            wk, ws = want.keypoints.numpy(), want.scores.numpy()
            gk, gs = got.keypoints.cpu().numpy(), got.scores.cpu().numpy()
            diff, near, order = _keypoint_diffs(np, gk, gs, wk, ws, 2 * sp.nms_radius + 1)
            same = (gk == wk).all(axis=1)
            err_sc = _rel_err(np, gs, ws) if order == 0 else _rel_err(np, np.sort(gs), np.sort(ws))
            err_d = _rel_err(np, got.descriptors.cpu().numpy()[same], want.descriptors.numpy()[same])
            record(f"SuperPoint image {side}", diff == near and err_sc <= MATCH_TOL
                   and err_d <= MATCH_TOL, keypoints=MATCH_KP, zero_score=int((ws == 0).sum()),
                   disagreements=diff, near_ties=near, slots_reordered=int(order),
                   score_err=err_sc, descriptor_err=err_d, tol=MATCH_TOL)
        # SIFT
        want = sift.extract_sift(img0, MATCH_KP)
        got = sift.extract_sift(img0.to(dev), MATCH_KP)
        wk, ws = want["keypoints"].numpy(), want["scores"].numpy()
        gk, gs = got["keypoints"].cpu().numpy(), got["scores"].cpu().numpy()
        diff, near, order = _keypoint_diffs(np, gk, gs, wk, ws, 1)
        same = (gk == wk).all(axis=1)
        err_d = _rel_err(np, got["descriptors"].cpu().numpy()[same],
                         want["descriptors"].numpy()[same])
        record("SIFT", diff == near and _rel_err(np, gs, ws) <= MATCH_TOL and err_d <= MATCH_TOL,
               keypoints=MATCH_KP, zero_score=int((ws == 0).sum()), disagreements=diff,
               near_ties=near, slots_reordered=int(order), descriptor_err=err_d, tol=MATCH_TOL)

        # the matchers on SuperPoint's features of the pair, keypoints
        # normalized by the image size as the pipeline does
        def norm(k):
            return k / (MATCH_IMG - 1.0) * 2.0 - 1.0

        args = (norm(feats["0"].keypoints), feats["0"].descriptors,
                norm(feats["1"].keypoints), feats["1"].descriptors)
        valid = dict(valid0=feats["0"].scores > 0, valid1=feats["1"].scores > 0)
        for label, adaptive in (("off", None), ("adaptive", MATCH_ADAPTIVE)):
            conf = dict(depth=9, dim=256, num_heads=4, filter_threshold=0.0)
            if adaptive:
                conf.update(depth_confidence=adaptive[0], width_confidence=adaptive[1])
            m = lightglue.LightGlueMatcher(**conf)
            init_params(m, torch.Generator().manual_seed(0))
            if adaptive:
                _adaptive_biases(torch, m)
            m.eval()
            want = m(*args, **valid)
            got = copy.deepcopy(m).to(dev)(*(a.to(dev) for a in args),
                                          **{k: v.to(dev) for k, v in valid.items()})
            got = {k: v.cpu() for k, v in got.items()}
            la_w, la_g = want["log_assignment"].numpy(), got["log_assignment"].numpy()
            diff, near = _match_diffs(np, got["matches0"].numpy(), want["matches0"].numpy(),
                                      la_g[:-1, :-1], la_w[:-1, :-1])
            rows, rows_near = _argmax_diffs(np, la_g[:-1, :-1], la_w[:-1, :-1])
            same_adapt = all(torch.equal(got[k], want[k]) for k in ("stop_layer", "prune0",
                                                                    "prune1"))
            err = _rel_err(np, la_g, la_w)
            record(f"LightGlue depth 9, adaptivity {label}", diff == near and rows == rows_near
                   and same_adapt and err <= MATCH_TOL,
                   matches=int((want["matches0"] >= 0).sum()), disagreements=diff,
                   near_ties=near, row_argmax_disagreements=rows, row_argmax_near_ties=rows_near,
                   stop_layer=int(want["stop_layer"]),
                   pruned0=int((want["prune0"] < want["stop_layer"]).sum()),
                   adaptive_equal=same_adapt, log_assignment_err=err, tol=MATCH_TOL)
        m = superglue.SuperGlueMatcher(depth=9, dim=256, sinkhorn_iters=50, filter_threshold=0.0)
        init_params(m, torch.Generator().manual_seed(0))
        m.eval()
        want = m(*args, **valid)
        got = {k: v.cpu() for k, v in copy.deepcopy(m).to(dev)(
            *(a.to(dev) for a in args), **{k: v.to(dev) for k, v in valid.items()}).items()}
        la_w, la_g = want["log_assignment"].numpy(), got["log_assignment"].numpy()
        diff, near = _match_diffs(np, got["matches0"].numpy(), want["matches0"].numpy(),
                                  la_g[:-1, :-1], la_w[:-1, :-1])
        rows, rows_near = _argmax_diffs(np, la_g[:-1, :-1], la_w[:-1, :-1])
        err = _rel_err(np, la_g, la_w)
        record("SuperGlue depth 9, 50 Sinkhorn iterations", diff == near and rows == rows_near
               and err <= MATCH_TOL, matches=int((want["matches0"] >= 0).sum()),
               disagreements=diff, near_ties=near, row_argmax_disagreements=rows,
               row_argmax_near_ties=rows_near, log_assignment_err=err, tol=MATCH_TOL)
    return records


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _run_cli(cli, argv):
    """``cli.main(argv)``: its printed lines."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue().splitlines()


def _timed_match(torch, cli, configs, estimators, dev, argv, sampler):
    """``cli.main(argv)`` of ``match`` on ``dev`` with ``sampler`` as the
    RANSAC's ``ransac_samples``, its pipeline's extractor and matcher timed
    where the CLI calls them (synchronized on the card): (row, {seconds,
    extractor_ms (both images), matcher_ms: medians over the pairs after the
    first, which builds the models; peak_gib on the card})."""
    draw, build = estimators.ransac_samples, configs.build_pipeline
    ms = {"extractor": [], "matcher": []}

    def timed(fn, part):
        def call(*args):
            _sync(torch, dev)
            t0 = time.perf_counter()
            result = fn(*args)
            _sync(torch, dev)
            ms[part].append((time.perf_counter() - t0) * 1e3)
            return result

        if hasattr(fn, "holder"):  # a matcher that loads checkpoints
            call.holder = fn.holder
        return call

    def build_timed(*args, **kwargs):
        pipe = build(*args, **kwargs)
        pipe.extractor = timed(pipe.extractor, "extractor")
        pipe.matcher = timed(pipe.matcher, "matcher")
        return pipe

    estimators.ransac_samples, configs.build_pipeline = sampler, build_timed
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        row = json.loads(_run_cli(cli, argv)[-1])
        seconds = time.perf_counter() - t0
    finally:
        estimators.ransac_samples, configs.build_pipeline = draw, build
    ext = [a + b for a, b in zip(ms["extractor"][2::2], ms["extractor"][3::2])]
    return row, dict(seconds=seconds, extractor_ms=statistics.median(ext),
                     matcher_ms=statistics.median(ms["matcher"][1:]),
                     peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30
                     if dev.type == "cuda" else None)


def _row_gaps(card, host, replayed_all):
    """The entries of a ``match`` row outside MATCH_ROW (card against CPU):
    {key: (card, cpu)}."""
    off = {}
    for k, c in card.items():
        h = host[k]
        if k == "experiment" or (c is None and h is None):
            continue
        if (c is None) != (h is None):
            off[k] = (c, h)
            continue
        if k == "num_matches":
            lim = MATCH_ROW["num_matches"] * max(abs(h), 1.0)
        elif k.startswith("H_error"):
            lim = (MATCH_ROW["H_error"] if replayed_all else MATCH_ROW["H_error_redrawn"]) * \
                max(abs(h), 1.0)
        elif k.startswith("H_acc"):
            lim = 0.0 if replayed_all else 1.0 / MATCH_CPU_PAIRS + 1e-9
        else:
            lim = MATCH_ROW["prec_recall"]
        if abs(c - h) > lim:
            off[k] = (c, h)
    return off


def match_phase(torch, np, counters, dev, smi):
    """Phase 15: the matching stack on the card, TF32 off for its
    comparisons. (a) ``match_module_checks``; (b) ``cli.main match`` per
    experiment on the card and on the CPU (the RANSAC replaying the card's
    samples), and ``match --list``; (c) the superpoint keypoint backend and
    ``cli.main eval --keypoints superpoint``; (d) per experiment the ms per
    pair split into extractor and matcher, host syncs and peak memory on the
    card and the CPU. No kernel may launch in (a), (b), (d) or (c)'s seeding.
    Returns the phase's record."""
    import csv
    import os
    import tempfile

    from comet_tpu_torch import cli
    from comet_tpu_torch.data import fixtures, keypoints
    from comet_tpu_torch.matching import benchmarks, configs, experiments, lightglue, superglue
    from comet_tpu_torch.models.blocks import init_params
    from comet_tpu_torch.twoview import estimators
    from comet_tpu_torch.weights import module_params_to_jax

    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        raise SmokeError("matching: TF32 matmuls are on; the comparisons run in f32")
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    cpu = torch.device("cpu")
    rec, failures = {}, []
    _reset(counters)
    try:
        rec["modules"] = match_module_checks(torch, np, dev, smi)
        failures += [f"(a) {r['name']}" for r in rec["modules"] if not r["ok"]]

        with tempfile.TemporaryDirectory() as tmp:
            # (b) the CLI; the trainable matchers load the cosine checkpoint
            ckpt = {}
            for name, cls in zip(MATCH_LOADED, (lightglue.LightGlueMatcher,
                                                superglue.SuperGlueMatcher)):
                exp = configs.get_experiment(name)["matcher"]
                exp.pop("name")
                m = cls(**exp)
                init_params(m, torch.Generator().manual_seed(0))
                m.load_state_dict(_cosine_weights(torch, m))
                # written as the JAX package's save_experiment writes it
                ckpt[name] = os.path.join(tmp, name.replace("+", "_"))
                experiments.save_experiment(ckpt[name], 1, module_params_to_jax(m))
            names = _run_cli(cli, ["match", "--list"])
            if names != configs.list_experiments() or len(names) != 11:
                failures.append(f"(b) match --list printed {names}")
            print(f"matching (b): match --list: {len(names)} names", flush=True)
            rows, timing = {}, {}
            draw = estimators.ransac_samples
            for name in MATCH_EXPERIMENTS:
                base = ["match", "--experiment", name, "--image-size", str(MATCH_IMG)]
                if name in ckpt:
                    base += ["--load-experiment", ckpt[name]]
                drawn, replayed, timing[name] = [], [0, 0], {}

                def keep(n, *a, **k):
                    drawn.append((n, draw(n, *a, **k)))
                    return drawn[-1][1]

                def replay(n, *a, **k):
                    if drawn and drawn[0][0] == n:
                        replayed[0] += 1
                        return drawn.pop(0)[1].cpu()
                    replayed[1] += 1  # a near-tie changed this pair's match count
                    if drawn:
                        drawn.pop(0)
                    return draw(n, *a, **k)

                # the row on the card at MATCH_PAIRS pairs, timed for (d); then
                # at MATCH_CPU_PAIRS on the card and on the CPU, the CPU's
                # RANSAC replaying the card's samples
                card, timing[name]["card"] = _timed_match(torch, cli, configs, estimators, dev,
                                                          base + ["--n-pairs", str(MATCH_PAIRS)],
                                                          draw)
                small = base + ["--n-pairs", str(MATCH_CPU_PAIRS)]
                card_small, _ = _timed_match(torch, cli, configs, estimators, dev, small, keep)
                host, timing[name]["cpu"] = _timed_match(torch, cli, configs, estimators, cpu,
                                                         small + ["--device", "cpu"], replay)
                bad = [k for k, v in card.items() if k != "experiment" and
                       not (isinstance(v, float) and math.isfinite(v))]
                off = _row_gaps(card_small, host, replayed[1] == 0)
                rows[name] = dict(card=card, card_small=card_small, cpu=host, replayed=replayed)
                print(f"matching (b): match --experiment {name}"
                      + (" --load-experiment <cosine checkpoint>" if name in ckpt else "")
                      + f" --image-size {MATCH_IMG}: at {MATCH_PAIRS} pairs, card "
                      f"{json.dumps(card)} in {timing[name]['card']['seconds']:.1f} s; at "
                      f"{MATCH_CPU_PAIRS} pairs, card {json.dumps(card_small)}, CPU "
                      f"{json.dumps(host)} in {timing[name]['cpu']['seconds']:.1f} s (RANSAC "
                      f"samples replayed {replayed[0]}, drawn anew {replayed[1]})"
                      + (f"; not finite {bad}" if bad else "") + (f"; off {off}" if off else ""),
                      flush=True)
                if bad or off:
                    failures.append(f"(b) {name}: not finite {bad}, off {off}")

                # (d) the host synchronizations of one benchmark pair on the card
                pipe = configs.build_pipeline(name, image_hw=(MATCH_IMG, MATCH_IMG))
                if name in ckpt:
                    experiments.load_experiment_into_pipeline(pipe, ckpt[name])
                pair = benchmarks.make_synthetic_pairs(1, (MATCH_IMG, MATCH_IMG), seed=1,
                                                       device=dev)
                benchmarks.run_homography_benchmark(pipe, pair)  # build and warm
                clock = _StageClock(torch, dev)
                clock.measure("benchmark", benchmarks.run_homography_benchmark, pipe, pair)
                r = clock.records[0]
                timing[name]["card"].update(syncs_per_pair=r["syncs"], where=r["where"],
                                            benchmark_ms_per_pair=r["ms"])
                for where, t in timing[name].items():
                    last = MATCH_PAIRS if where == "card" else MATCH_CPU_PAIRS
                    print(f"matching (d): {name} on the {where}: extractor "
                          f"{t['extractor_ms']:.2f} ms per pair (both images), matcher "
                          f"{t['matcher_ms']:.2f} ms (medians over pairs 2-{last})"
                          + (f"; one benchmark pair {t['benchmark_ms_per_pair']:.1f} ms with "
                             f"{t['syncs_per_pair']} host syncs {t['where']}; peak "
                             + (f"{t['peak_gib']:.3f} GiB" if t["peak_gib"] is not None
                                else "not measured") if where == "card" else ""), flush=True)
            rec["cli"], rec["timing"] = rows, timing
            launched = _launches(counters)
            if sum(launched.values()):
                failures.append(f"(a), (b), (d): kernels launched {launched}")
            print(f"matching: K1-K5 launches over (a), (b) and (d): {launched}", flush=True)

            # (c) the superpoint keypoint backend on a fixture frame, then
            # the CLI's eval with it at full width
            amd = os.path.join(tmp, "AMD")
            fixtures.generate_amd_fixture(os.path.join(amd, "AMD_eval"), n_seqs=1,
                                          n_frames=CLI_AMD_FRAMES, seed=4)
            from comet_tpu_torch.config import get_config
            from comet_tpu_torch.data import AMDDataset

            cfg = get_config("ours")
            sample = AMDDataset(os.path.join(amd, "AMD_eval"), crop_size=cfg.img_size,
                                seq_len=cfg.seqlen)[0]
            frame0 = np.asarray(sample.images[0])
            u8 = keypoints.denormalize_image(frame0)
            sp_card = keypoints.detect_superpoint(u8, cfg.track_num, device=dev)
            sp_cpu = keypoints.detect_superpoint(u8, cfg.track_num, device=cpu)
            # the detections' disagreements (the frame's flat background gives
            # plateaus of equal heatmap values that the two devices round apart)
            gray = u8.astype(np.float32).mean(axis=-1) / 255.0
            gray = torch.as_tensor(np.pad(gray, ((0, -gray.shape[0] % 8), (0, -gray.shape[1] % 8))))
            with torch.no_grad():
                outs = [keypoints._SP_CACHE[(cfg.track_num, None, d)](gray.to(d))
                        for d in (dev, cpu)]
            det_diff, det_near, det_order = _keypoint_diffs(
                np, outs[0].keypoints.cpu().numpy(), outs[0].scores.cpu().numpy(),
                outs[1].keypoints.numpy(), outs[1].scores.numpy(), 9)
            seeded = {where: keypoints.seed_query_points(
                frame0, sample.first_mask, cfg.track_num, cfg.min_track_num, backend="superpoint",
                rng=np.random.default_rng(0), device=d) for where, d in (("card", dev), ("cpu", cpu))}
            same_det = sp_card.shape == sp_cpu.shape and np.array_equal(sp_card, sp_cpu)
            same_seed = np.array_equal(seeded["card"], seeded["cpu"])
            launched = _launches(counters)
            ok = (seeded["card"].shape == (cfg.track_num, 2) and np.isfinite(seeded["card"]).all()
                  and (same_seed or not same_det) and det_diff == det_near
                  and not sum(launched.values()))
            print(f"matching (c): detect_superpoint on a {u8.shape[0]} x {u8.shape[1]} fixture "
                  f"frame: {len(sp_card)} keypoints on the card, {len(sp_cpu)} on the CPU, equal "
                  f"{same_det} ({det_diff} of the top {cfg.track_num} differ, {det_near} of them "
                  f"near-ties; {det_order} slots reordered among near-equal scores); "
                  f"seed_query_points(backend='superpoint'): {seeded['card'].shape}, "
                  f"equal to the CPU's {same_seed}; launches {launched}"
                  + ("" if ok else " FAILED"), flush=True)
            if not ok:
                failures.append("(c) superpoint seeding")
            _reset(counters)
            out = os.path.join(tmp, "out_eval")
            t0 = time.perf_counter()
            _run_cli(cli, ["eval", "--data-root", os.path.join(amd, "AMD_eval"), "--keypoints",
                           "superpoint", "--max-sequences", "1", "--output-dir", out])
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            with open(os.path.join(out, "test_results.csv")) as f:
                csv_rows = list(csv.DictReader(f))
            bad = [k for row in csv_rows for k, v in row.items() if not math.isfinite(float(v))]
            print(f"matching (c): python -m comet_tpu_torch.cli eval --keypoints superpoint "
                  f"--max-sequences 1 (full width): {eval_s:.1f} s wall, {len(csv_rows)} CSV row, "
                  f"not finite {bad}; the forward's launches {_launches(counters)}", flush=True)
            if len(csv_rows) != 1 or bad:
                failures.append(f"(c) eval --keypoints superpoint: {len(csv_rows)} rows, {bad}")
            rec["eval_s"] = eval_s
            rec["seeding_equal"] = same_seed
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"matching: phase 15 in {rec['seconds']:.1f} s, on {smi}", flush=True)
    if failures:
        raise SmokeError(f"matching: {'; '.join(failures)}")
    return rec


# phase 16: matcher training, the ALIKED, DISK and KeyNet extractors and the
# DINOv2 backbone on K1. (a) trains each experiment's matcher at its own width
# (LightGlue / SuperGlue depth 9, width 256) on 512 SuperPoint keypoints of
# MATCH_IMG px homography pairs, batch TRAIN16_BATCH, for TRAIN16_STEPS steps
# (a batch every 3 steps), a checkpoint every TRAIN16_CKPT with TRAIN16_VAL
# validation pairs, then one --resume step
TRAIN16_EXPERIMENTS = ("superpoint+lightglue_homography", "superpoint+superglue")
TRAIN16_STEPS = 24
TRAIN16_BATCH = 4
TRAIN16_CKPT = 8
TRAIN16_VAL = 2
# the first step on the card (f32, TF32 off) against the same step on the CPU:
# the loss within TRAIN16_LOSS_RTOL; each gradient tensor within
# TRAIN16_GRAD_RTOL of its norm, or of TRAIN16_GRAD_FLOOR x the largest
# tensor's norm where its own is smaller (the key biases of SuperGlue's
# attention, which a softmax over keys cannot see, hold rounding noise only)
TRAIN16_LOSS_RTOL = 1e-4
TRAIN16_GRAD_RTOL = 1e-3
TRAIN16_GRAD_FLOOR = 1e-3
# (a) also overfits LightGlue's fixed batch (its first experiment's, at its
# width) for OVERFIT16_STEPS steps of Adam at OVERFIT16_LR: the loss must fall
# by OVERFIT16_FALL of its first value: half the fall of the CPU reading
# (tools/matcher_overfit.py --jax: 14.339 -> 13.309 over 30 steps, 7.2 %). At
# the experiments' lr 1e-4 the loss of either package sits at -ln 1e-8 from
# the second step on (matcher_nll_loss's floor), so the check runs at 1e-5
OVERFIT16_STEPS = 30
OVERFIT16_LR = 1e-5
OVERFIT16_FALL = 0.035
# (b): the extractors of EXTRACT16_EXPERIMENTS on the card against the CPU, on
# the two images of a benchmark pair, at MATCH_IMG px with 512 keypoints
# the NMS window of each (pixels): a keypoint missing from one set is a
# near-tie where a keypoint of the other set this close has its score
EXTRACT16 = dict(extractor_aliked=5, extractor_disk=5, extractor_keynet=15)
EXTRACT16_EXPERIMENTS = ("aliked+nn", "disk+nn", "keynet+nn", "aliked+lightglue_homography")
# ALIKED keypoints are sub-pixel: the same keypoint within this many pixels
EXTRACT16_SUBPIXEL = 1e-2
# (c): backbone_dinov2 (ViT-S/14: C 384, 6 heads of 64, depth 12) at 224 px
# and with allow_resize at 480 x 640 (-> 476 x 630, 34 x 45 patches); bf16 on
# the card against the same ViT in f32 with the plain attention on the card,
# relative to each output's largest |value| (REF_RTOL's reasoning: a stack of
# 12 bf16 blocks drifts by ~1 % of the range)
BACKBONE16_SIZES = ((224, 224), (480, 640))
BACKBONE16_RTOL = 3e-2
BACKBONE16_CALLS = 3


def _grad_gaps(torch, got, want):
    """(worst ratio of |g_card - g_cpu| to its allowance, tensor name): the
    allowance is TRAIN16_GRAD_RTOL x max(|g_cpu|, TRAIN16_GRAD_FLOOR x the
    largest |g_cpu|), norms over each tensor."""
    norms = {n: float(g.norm()) for n, g in want.items()}
    floor = TRAIN16_GRAD_FLOOR * max(norms.values())
    return max((float((got[n] - g).norm()) / (TRAIN16_GRAD_RTOL * max(norms[n], floor)), n)
               for n, g in want.items())


def _step_gradients(torch, module, step, batch, dev):
    """(loss, {name: gradient on the CPU}) of one train step of a copy of
    ``module`` on ``dev``, through an Adam of learning rate 0 (the weights
    stay as they are)."""
    import copy

    m = copy.deepcopy(module).to(dev).train()
    loss = float(step(m, torch.optim.Adam(m.parameters(), lr=0.0),
                      {k: v.to(dev) for k, v in batch.items()}))
    return loss, {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
                  for n, p in m.named_parameters()}


def train16(torch, np, counters, dev, tmp):
    """Phase 16 (a): per experiment, the first train step on the card
    against the CPU, then ``cli.main match --train`` on the card (timed per
    step, host syncs counted, peak memory, checkpoints checked), one
    ``--resume`` step, and a profile of one step. Returns the records."""
    import copy
    import os
    import warnings

    from comet_tpu_torch import cli
    from comet_tpu_torch.matching import configs, experiments, train
    from comet_tpu_torch.matching.registry import get_model

    cpu = torch.device("cpu")
    records = {}
    for name in TRAIN16_EXPERIMENTS:
        conf = configs.get_experiment(name)
        tb = conf["train"]
        ext_conf = dict(conf["extractor"])
        extractor = get_model(ext_conf.pop("name"), **ext_conf)
        mat_conf = dict(conf["matcher"])
        mat_name = mat_conf.pop("name")
        build = (train.build_superglue_train_step if mat_name == "matcher_superglue"
                 else train.build_matcher_train_step)
        batch = train.make_homography_training_batch(
            extractor, np.random.default_rng(tb["seed"]), batch_size=TRAIN16_BATCH,
            image_hw=(MATCH_IMG, MATCH_IMG), difficulty=tb["homography"]["difficulty"],
            max_angle=tb["homography"]["max_angle"],
            th_positive=conf["ground_truth"]["th_positive"],
            th_negative=conf["ground_truth"]["th_negative"], device=dev)
        module = cli._init_matcher(get_model(mat_name, **mat_conf), batch["desc0"].shape[-1],
                                   tb["seed"])
        _reset(counters)
        loss_card, g_card = _step_gradients(torch, module, build(), batch, dev)
        loss_cpu, g_cpu = _step_gradients(torch, module, build(), batch, cpu)
        loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
        worst, worst_name = _grad_gaps(torch, g_card, g_cpu)
        gt0 = batch["gt0"]
        labels = dict(matched=int((gt0 >= 0).sum()), unmatched=int((gt0 == -1).sum()),
                      ignored=int((gt0 == -2).sum()))

        # the CLI's training on the card: each step timed (synchronized), the
        # whole run's host synchronizations counted with their source lines
        exp_dir = os.path.join(tmp, name.replace("+", "_"))
        step_ms, saved = [], (train.build_matcher_train_step, train.build_superglue_train_step)

        def timed(builder):
            def make():
                step = builder()

                def run(*args):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = step(*args)
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    return out

                return run

            return make

        train.build_matcher_train_step, train.build_superglue_train_step = map(timed, saved)
        argv = ["match", "--train", "--experiment", name, "--steps", str(TRAIN16_STEPS),
                "--batch-size", str(TRAIN16_BATCH), "--image-size", str(MATCH_IMG),
                "--exp-dir", exp_dir]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    lines = _run_cli(cli, argv + ["--ckpt-every", str(TRAIN16_CKPT), "--val-pairs",
                                                  str(TRAIN16_VAL)])
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            steps_ms = list(step_ms)
            resumed = _run_cli(cli, argv[:4] + ["--steps", "1"] + argv[6:] + ["--resume"])
        finally:
            train.build_matcher_train_step, train.build_superglue_train_step = saved
        where = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                        if SYNC_WARNING in str(w.message))
        row, row_resumed = json.loads(lines[-1]), json.loads(resumed[-1])
        launched = _launches(counters)
        files = sorted(os.listdir(exp_dir))
        saved_steps = list(range(TRAIN16_CKPT, TRAIN16_STEPS + 1, TRAIN16_CKPT)) + [TRAIN16_STEPS + 1]
        want_files = sorted([f"checkpoint_{s:08d}.{e}" for s in saved_steps
                             for e in ("json", "msgpack")]
                            + ["checkpoint_best.json", "checkpoint_best.msgpack", "log.txt"])
        _, meta = experiments.load_checkpoint(exp_dir, get_last=True)
        vals = sum(line.startswith("  val: H_err") for line in lines)
        ok = (loss_err <= TRAIN16_LOSS_RTOL and worst <= 1.0 and files == want_files
              and meta["step"] == TRAIN16_STEPS + 1 and resumed[0] == f"resumed {exp_dir} at step "
              f"{TRAIN16_STEPS}" and vals == TRAIN16_STEPS // TRAIN16_CKPT
              and all(math.isfinite(row[k]) for k in ("loss_first", "loss_last"))
              and not sum(launched.values()))

        # one step under the profiler: the device's share of it
        m = copy.deepcopy(module).to(dev).train()
        opt = train.make_adam(m, float(tb["lr"]))
        step = build()
        bdev = {k: v.to(dev) for k, v in batch.items()}
        for _ in range(2):
            step(m, opt, bdev)
        median = statistics.median(steps_ms[1:])
        prof = _profile_step(torch, lambda gt: step(m, opt, bdev), (), None, median)
        overfit = None
        if name == TRAIN16_EXPERIMENTS[0]:  # LightGlue on one fixed batch
            m = copy.deepcopy(module).to(dev).train()
            opt = train.make_adam(m, OVERFIT16_LR)
            overfit = [float(step(m, opt, bdev)) for _ in range(OVERFIT16_STEPS)]
            fall = 1.0 - overfit[-1] / overfit[0]
            print(f"training (a): {name}: {OVERFIT16_STEPS} steps on one fixed batch at lr "
                  f"{OVERFIT16_LR}: loss {overfit[0]:.6f} -> {overfit[-1]:.6f}, a fall of "
                  f"{fall:.4f} (at least {OVERFIT16_FALL}); curve "
                  f"{['%.4f' % x for x in overfit]}", flush=True)
            ok = ok and fall >= OVERFIT16_FALL and all(math.isfinite(x) for x in overfit)
        records[name] = dict(ok=ok, loss_card=loss_card, loss_cpu=loss_cpu, loss_err=loss_err,
                             overfit=overfit,
                             grad_worst=worst, grad_worst_tensor=worst_name, labels=labels,
                             row=row, row_resumed=row_resumed, seconds=seconds,
                             step_ms_median=median, step_ms_first=steps_ms[0], peak_gib=peak,
                             syncs=sum(where.values()), syncs_per_step=sum(where.values()) /
                             TRAIN16_STEPS, sync_where=dict(where), launches=launched,
                             files=files, profile=prof)
        print(f"training (a): {name}: first step card loss {loss_card:.6f} against CPU "
              f"{loss_cpu:.6f} (rel {loss_err:.2e}, tol {TRAIN16_LOSS_RTOL}); gradients: worst "
              f"{worst:.3f} of the allowance ({worst_name}; tol {TRAIN16_GRAD_RTOL} of each norm, "
              f"floor {TRAIN16_GRAD_FLOOR} of the largest); labels {labels}; match --train "
              f"{TRAIN16_STEPS} steps at batch {TRAIN16_BATCH}, {MATCH_IMG} px: "
              f"{json.dumps(row)} in {seconds:.1f} s; step {median:.1f} ms median (first "
              f"{steps_ms[0]:.1f}); peak {peak:.3f} GiB; host syncs {sum(where.values())} over the "
              f"run ({sum(where.values()) / TRAIN16_STEPS:.2f} per step) at {dict(where)}; one "
              f"step's device time {prof['device_ms']:.1f} ms in {prof['launches']} kernel "
              f"launches, idle share {prof['idle']:.2f}; checkpoints {files}; resumed: "
              f"{resumed[0]!r}, {json.dumps(row_resumed)}; K1-K5 launches {launched}"
              + ("" if ok else " FAILED"), flush=True)
    return records


def _subpixel_diffs(np, got_kp, got_sc, want_kp, want_sc, px, window):
    """:func:`_keypoint_diffs` with a distance: two keypoints are the same
    within ``px`` pixels (sub-pixel keypoints). Returns (disagreements,
    near-ties, pairs of indices (card, CPU) of the keypoints both sets
    hold)."""
    tol = MATCH_NEAR_TIE * max(float(np.abs(want_sc).max()), 1e-12)
    dist = np.abs(got_kp[:, None] - want_kp[None]).max(-1)
    diff = near = 0
    for d, scores, other_sc in ((dist, got_sc, want_sc), (dist.T, want_sc, got_sc)):
        for i in np.nonzero(d.min(1) > px)[0]:
            diff += 1
            close = d[i] <= window
            s = scores[i]
            if (s == 0 or abs(s - other_sc[-1]) <= tol
                    or (close.any() and np.abs(other_sc[close] - s).min() <= tol)):
                near += 1
    same = [(i, int(dist[i].argmin())) for i in range(len(got_kp)) if dist[i].min() <= px]
    return diff, near, same


def extract16(torch, np, counters, dev, tmp):
    """Phase 16 (b): ALIKED (aliked-n16), DISK and KeyNet on the card against
    the CPU on the two images of a benchmark pair; then ``match`` for
    EXTRACT16_EXPERIMENTS on the card and the CPU, as phase 15 (b). Returns
    the records."""
    import os

    from comet_tpu_torch import cli
    from comet_tpu_torch.matching import benchmarks, configs, experiments, lightglue
    from comet_tpu_torch.matching.registry import get_model
    from comet_tpu_torch.models.aliked import ALIKED
    from comet_tpu_torch.models.blocks import init_params
    from comet_tpu_torch.twoview import estimators
    from comet_tpu_torch.utils.serialization import save_params_msgpack
    from comet_tpu_torch.weights import module_params_to_jax

    cpu = torch.device("cpu")
    # ALIKED's random SDDH aggregation weights are drawn from [0, 1) (flax's
    # init), which makes every descriptor nearly parallel and every nearest
    # neighbour a near-tie; these weights sign them. The benchmark's pairs are
    # one-channel images, for which ALIKED builds a one-channel network.
    aliked = ALIKED("aliked-n16", in_ch=1)
    init_params(aliked, torch.Generator().manual_seed(0))
    with torch.no_grad():
        agg = aliked.desc_head.agg_weights
        agg.normal_(0.0, agg.shape[-1] ** -0.5, generator=torch.Generator().manual_seed(1))
    aliked_path = save_params_msgpack(os.path.join(tmp, "aliked_n16_gray.msgpack"), aliked)
    img0, img1, _ = benchmarks.make_synthetic_pairs(1, (MATCH_IMG, MATCH_IMG), seed=3,
                                                    device=cpu)[0]
    records, failures = {"extractors": {}, "rows": {}}, []
    _reset(counters)
    with torch.no_grad():
        for name, window in EXTRACT16.items():
            conf = {"params_path": aliked_path} if name == "extractor_aliked" else {}
            f_card = get_model(name, **conf, device=dev)
            f_cpu = get_model(name, **conf, device=cpu)
            rec = dict(disagreements=0, near_ties=0, descriptor_err=0.0, score_err=0.0,
                       valid_equal=True, card_ms=[], cpu_ms=[])
            for img in (img0, img1):
                f_card(img.to(dev))  # build and warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = f_card(img.to(dev))
                torch.cuda.synchronize()
                rec["card_ms"].append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                want = f_cpu(img)
                rec["cpu_ms"].append((time.perf_counter() - t0) * 1e3)
                gk, gs = got["keypoints"].cpu().numpy(), got["scores"].cpu().numpy()
                wk, ws = want["keypoints"].numpy(), want["scores"].numpy()
                # DISK's and KeyNet's keypoints lie on the pixel grid: the same
                # within half a pixel; ALIKED's are sub-pixel
                px = EXTRACT16_SUBPIXEL if name == "extractor_aliked" else 0.5
                diff, near, same = _subpixel_diffs(np, gk, gs, wk, ws, px, window)
                gi, wi = (np.array([a for a, _ in same]), np.array([b for _, b in same]))
                rec["disagreements"] += diff
                rec["near_ties"] += near
                rec["descriptor_err"] = max(rec["descriptor_err"], _rel_err(
                    np, got["descriptors"].cpu().numpy()[gi], want["descriptors"].numpy()[wi]))
                rec["score_err"] = max(rec["score_err"], _rel_err(np, gs[gi], ws[wi]))
                rec["valid_equal"] &= bool((got["valid"].cpu().numpy()[gi]
                                            == want["valid"].numpy()[wi]).all())
                rec.setdefault("valid", []).append(int(want["valid"].sum()))
            ok = (rec["disagreements"] == rec["near_ties"] and rec["valid_equal"]
                  and rec["descriptor_err"] <= MATCH_TOL and rec["score_err"] <= MATCH_TOL)
            rec["ok"] = ok
            records["extractors"][name] = rec
            print(f"extractors (b): {name} on 2 images of {MATCH_IMG} px, 512 keypoints: "
                  f"valid {rec['valid']}, {rec['disagreements']} keypoints differ "
                  f"({rec['near_ties']} near-ties), score err {rec['score_err']:.2e}, descriptor "
                  f"err {rec['descriptor_err']:.2e} (tol {MATCH_TOL}), valid equal "
                  f"{rec['valid_equal']}; ms per image card {rec['card_ms']}, CPU "
                  f"{rec['cpu_ms']}" + ("" if ok else " FAILED"), flush=True)
            if not ok:
                failures.append(f"(b) {name}")

    # the experiments' rows on the card and the CPU; ALIKED from the signed
    # weights, LightGlue from a cosine checkpoint over its 128-d descriptors
    saved = {n: configs.EXPERIMENTS[n] for n in EXTRACT16_EXPERIMENTS}
    lg = configs.get_experiment("aliked+lightglue_homography")["matcher"]
    lg.pop("name")
    m = lightglue.LightGlueMatcher(**lg, in_dim=128)
    init_params(m, torch.Generator().manual_seed(0))
    m.load_state_dict(_cosine_weights(torch, m))
    ckpt = os.path.join(tmp, "aliked_lightglue")
    experiments.save_experiment(ckpt, 1, module_params_to_jax(m))
    draw = estimators.ransac_samples
    try:
        for name in EXTRACT16_EXPERIMENTS:
            exp = configs.get_experiment(name)
            if exp["extractor"]["name"] == "extractor_aliked":
                exp["extractor"]["params_path"] = aliked_path
            configs.EXPERIMENTS[name] = exp
            base = ["match", "--experiment", name, "--image-size", str(MATCH_IMG)]
            if name in ("aliked+lightglue_homography",):
                base += ["--load-experiment", ckpt]
            drawn, replayed = [], [0, 0]

            def keep(n, *a, **k):
                drawn.append((n, draw(n, *a, **k)))
                return drawn[-1][1]

            def replay(n, *a, **k):
                if drawn and drawn[0][0] == n:
                    replayed[0] += 1
                    return drawn.pop(0)[1].cpu()
                replayed[1] += 1  # a near-tie changed this pair's match count
                if drawn:
                    drawn.pop(0)
                return draw(n, *a, **k)

            card, t_card = _timed_match(torch, cli, configs, estimators, dev,
                                        base + ["--n-pairs", str(MATCH_PAIRS)], draw)
            small = base + ["--n-pairs", str(MATCH_CPU_PAIRS)]
            card_small, _ = _timed_match(torch, cli, configs, estimators, dev, small, keep)
            host, t_cpu = _timed_match(torch, cli, configs, estimators, cpu,
                                       small + ["--device", "cpu"], replay)
            bad = [k for k, v in card.items() if k != "experiment" and
                   not (isinstance(v, float) and math.isfinite(v))]
            off = _row_gaps(card_small, host, replayed[1] == 0)
            records["rows"][name] = dict(card=card, card_small=card_small, cpu=host,
                                         replayed=replayed, card_timing=t_card, cpu_timing=t_cpu)
            print(f"extractors (b): match --experiment {name} --image-size {MATCH_IMG}: at "
                  f"{MATCH_PAIRS} pairs, card {json.dumps(card)} in {t_card['seconds']:.1f} s "
                  f"(extractor {t_card['extractor_ms']:.2f} + matcher {t_card['matcher_ms']:.2f} ms "
                  f"per pair); at {MATCH_CPU_PAIRS} pairs, card {json.dumps(card_small)}, CPU "
                  f"{json.dumps(host)} in {t_cpu['seconds']:.1f} s (extractor "
                  f"{t_cpu['extractor_ms']:.2f} + matcher {t_cpu['matcher_ms']:.2f} ms per pair; "
                  f"RANSAC samples replayed {replayed[0]}, drawn anew {replayed[1]})"
                  + (f"; not finite {bad}" if bad else "") + (f"; off {off}" if off else ""),
                  flush=True)
            if bad or off or card["num_matches"] <= 0:
                failures.append(f"(b) {name}: not finite {bad}, off {off}")
    finally:
        configs.EXPERIMENTS.update(saved)
        estimators.ransac_samples = draw
    records["launches"] = _launches(counters)
    if sum(records["launches"].values()):
        failures.append(f"(b) kernels launched {records['launches']}")
    print(f"extractors (b): K1-K5 launches {records['launches']}", flush=True)
    records["failures"] = failures
    return records


def backbone16(torch, np, F, attn, counters, dev, gen):
    """Phase 16 (c): ``backbone_dinov2`` (ViT-S/14, random weights) on the card
    at BACKBONE16_SIZES: K1 launches 12 times per call at each shape and the
    plain attention never; the outputs against the same ViT in f32 with the
    plain attention on the card; K1 timed at both shapes (``_k1_row``).
    Returns (records, K1 rows, launches by K1 shape)."""
    from comet_tpu_torch.matching.extractors import _build
    from comet_tpu_torch.matching.registry import get_model
    from comet_tpu_torch.models import vit

    records, failures = [], []
    bb = {size: get_model("backbone_dinov2", allow_resize=size != (224, 224), device=dev)
          for size in BACKBONE16_SIZES}
    ref = _build(vit.DinoViT(img_size=224, patch_size=14, embed_dim=384, depth=12, num_heads=6,
                             num_register_tokens=0), None, 0).to(dev)
    plain_calls = [0]
    reference = attn.attention_reference

    def counted_reference(*args, **kwargs):
        plain_calls[0] += 1
        return reference(*args, **kwargs)

    shapes = Counter()
    for size in BACKBONE16_SIZES:
        img = torch.rand(*size, 3, generator=gen, device=dev)
        bb[size](img)  # build, cast and warm
        torch.cuda.synchronize()
        _reset(counters)
        attn.attention_reference = counted_reference
        try:
            ms = []
            for _ in range(BACKBONE16_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = bb[size](img)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            attn.attention_reference = reference
        launches = _launches(counters)
        shapes.update(attn.fused_attention.launch_shapes)
        # the reference: the ViT in f32, its attention the plain version
        # (K1 takes no f32), on the same resized image
        x = img[None]
        if size != (224, 224):
            nh, nw = size[0] // 14 * 14, size[1] // 14 * 14
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
                              align_corners=False, antialias=True).permute(0, 2, 3, 1)
        saved = vit.fused_attention
        vit.fused_attention = lambda q, k, v, h: reference(q, k, v, h, (q.shape[-1] // h) ** -0.5)
        try:
            with torch.no_grad():
                tokens, cls = ref(x, return_cls=True)
        finally:
            vit.fused_attention = saved
        errs = dict(descriptors=_rel_err(np, out["descriptors"].cpu(), tokens.cpu()),
                    global_descriptor=_rel_err(np, out["global_descriptor"].cpu(), cls.cpu()))
        tokens_n = tokens.shape[1] + 1
        ok = (launches["K1"] == 12 * BACKBONE16_CALLS and plain_calls[0] == 0
              and sum(launches.values()) == launches["K1"]
              and max(errs.values()) <= BACKBONE16_RTOL
              and out["features"].shape == (1, 384, x.shape[1] // 14, x.shape[2] // 14))
        records.append(dict(size=size, tokens=tokens_n, ms=ms, launches=launches, errs=errs,
                            plain_calls=plain_calls[0], ok=ok))
        print(f"backbone (c): backbone_dinov2 ViT-S/14 at {size[0]} x {size[1]}"
              + (f" -> {x.shape[1]} x {x.shape[2]}" if size != (224, 224) else "")
              + f" ({tokens_n} tokens): {BACKBONE16_CALLS} calls, launches {launches} (12 K1 per "
              f"call wanted), plain attention calls {plain_calls[0]}; against f32 with the plain "
              f"attention: {json.dumps(errs)} (tol {BACKBONE16_RTOL} of the range); ms per call "
              f"{['%.2f' % t for t in ms]}" + ("" if ok else " FAILED"), flush=True)
        if not ok:
            failures.append(f"(c) at {size}")
    rows = [_k1_row(torch, F, attn, dev, gen, f"dinov2 backbone {r['tokens']} tokens", 1,
                    r["tokens"], r["tokens"], 384, 6, True) for r in records]
    return records, rows, shapes, failures


def train_extract_phase(torch, np, F, attn, counters, dev, smi):
    """Phase 16: matcher training (a), the new extractors (b) and the DINOv2
    backbone on K1 (c), with TF32 off for the comparisons. Returns the
    phase's record."""
    import tempfile

    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        raise SmokeError("phase 16: TF32 matmuls are on; the comparisons run in f32")
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    failures = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            training = train16(torch, np, counters, dev, tmp)
            t_train = time.perf_counter() - t0
            failures += [f"(a) {n}" for n, r in training.items() if not r["ok"]]
            t0 = time.perf_counter()
            extracted = extract16(torch, np, counters, dev, tmp)
            t_extract = time.perf_counter() - t0
            failures += extracted["failures"]
        t0 = time.perf_counter()
        backbone, k1_rows, k1_shapes, bb_failures = backbone16(
            torch, np, F, attn, counters, dev, torch.Generator(device=dev).manual_seed(16))
        t_backbone = time.perf_counter() - t0
        failures += bb_failures
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    rec = dict(training=training, extracted=extracted, backbone=backbone, k1_rows=k1_rows,
               k1_shapes=k1_shapes, seconds=time.perf_counter() - t_phase,
               parts=dict(training=t_train, extractors=t_extract, backbone=t_backbone))
    print(f"phase 16: {rec['seconds']:.1f} s (training {t_train:.1f}, extractors "
          f"{t_extract:.1f}, backbone {t_backbone:.1f}), on {smi}", flush=True)
    if failures:
        raise SmokeError(f"phase 16: {'; '.join(failures)}")
    return rec


# phase 17: line matching, depth ground truth and the cached-prediction
# pipelines (matching/lines.py, deeplsd.py, gluestick.py, depth_gt.py,
# eval_pipeline.py, cache_loader.py, viz.py; no kernel). (a) runs the two line
# experiments as named (GlueStick depth 6, width 128), GlueStick at the
# registry's width and DeepLSD at base 32 on phase 15's MATCH_PAIRS synthetic
# MATCH_IMG px pairs (512 keypoints, 64 lines), LINES17_CPU_PAIRS of them on
# the CPU too; GlueStick loads the weights of ``_gluestick_cosine`` (random
# ones match nothing)
LINES17 = (("superpoint+lsd+gluestick", {}), ("deeplsd+gluestick", {}),
           ("superpoint+lsd+gluestick", {"depth": 9, "dim": 256}))
LINES17_CPU_PAIRS = 3
# the fields a march reads, card against CPU, within LINES17_FIELD_TOL
# (``_field_gaps``); segments within LINES17_SEG_TOL px
LINES17_FIELD_TOL = 1e-5
LINES17_SEG_TOL = 1e-3
# the field check must see the card's orientation (DeepLSD: twice the line
# angle) moved by LINES17_PERTURB rad where a march reads it
LINES17_PERTURB = 1e-4
# (b): the depth maps' size and keypoints; (c): the pipelines' pairs
DEPTH17_KP = 512
PIPE17_PAIRS = 4
PIPE17_AMD_PAIRS = 2


def _gib(x):
    return "not measured" if x is None else f"{x:.3f} GiB"


def _sync_ms(torch, dev, fn, *args):
    _sync(torch, dev)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(torch, dev)
    return out, (time.perf_counter() - t0) * 1e3


def _field_gaps(torch, np, lines, gray, dev, detector, threshold):
    """The fields a detector marches on both devices: (value gap, orientation
    gap, the check's reach (the orientation gap of a perturbed card field,
    the share of the marched pixels where the perturbation is seen), the
    CPU's march fields). The LSD stand-in: the Sobel's magnitude
    (gap relative to its range) and orientation (its difference, 2 pi
    wrapped, times the magnitude over the magnitude's range: the gradient's
    perpendicular part); DeepLSD: the distance field (relative to its range)
    and the line angle (its difference times the angle head's vector norm
    over that norm's largest: the vector's perpendicular part)."""
    fields, out = [], []
    for d in (dev, torch.device("cpu")):
        g = gray.to(d)
        with torch.no_grad():
            if detector is None:
                gx, gy = lines.image_gradients(g)
                mag = lines.gradient_magnitude(gx, gy)
                out.append((mag, torch.atan2(gy, gx), mag))
                fields.append((mag, out[-1][1]))
            else:
                f = detector.module(d)(g)
                out.append((f["df"], 2.0 * f["angle"],
                            torch.linalg.vector_norm(f["angle_vec"], dim=-1)))
                fields.append((torch.exp(-f["df"] / detector.tau), f["angle"] + math.pi / 2.0))
    (gv, gt, _), (wv, wt, ww) = [tuple(a.cpu().double().numpy() for a in o) for o in out]

    def orientation_gap(theta):
        dth = np.abs(theta - wt) % (2 * np.pi)
        dth = np.minimum(dth, 2 * np.pi - dth)
        return float((dth * ww).max() / max(float(ww.max()), 1e-12))

    # the check's reach: the card's orientation moved by LINES17_PERTURB at
    # every pixel a march step can pass (the value field over half the
    # threshold), and the share of those pixels where that move alone
    # would exceed LINES17_FIELD_TOL
    read = fields[1][0].numpy() > threshold / 2
    reach = (orientation_gap(gt + LINES17_PERTURB * read),
             float((LINES17_PERTURB * ww[read] / max(float(ww.max()), 1e-12)
                    > LINES17_FIELD_TOL).mean()))
    value_gap = float(np.abs(gv - wv).max() / max(float(wv.max() - wv.min()), 1e-12))
    return value_gap, orientation_gap(gt), reach, fields[1]


def _gluestick_cosine(torch, module):
    """GlueStick's state with every layer's update zeroed, the keypoint and
    endpoint encoders' last layers zeroed, the input and endpoint
    projections identities and the final projections MATCH_COSINE_SCALE^(1/2)
    x dim^(1/4) x identity: points and lines are then scored by
    MATCH_COSINE_SCALE x the dot product of their (leading) descriptor
    entries (random weights match nothing)."""
    sd = {k: v.clone() for k, v in module.state_dict().items()}
    scale = MATCH_COSINE_SCALE ** 0.5 * module.dim ** 0.25
    for k in sd:
        head = k.split(".")[0]
        if head in ("input_proj", "endpoint_proj", "final_proj", "final_line_proj"):
            eye = torch.eye(*sd[k].shape) if k.endswith("weight") else None
            sd[k] = (eye * (scale if head.startswith("final") else 1.0) if eye is not None
                     else torch.zeros_like(sd[k]))
        elif k.startswith(("kenc.encoder.fc4.", "lenc.encoder.fc4.")) or ".mlp.fc1." in k:
            sd[k] = torch.zeros_like(sd[k])
    sd["bin_score"], sd["line_bin_score"] = torch.tensor(1.0), torch.tensor(1.0)
    return sd


def _segment_slots(np, got, want):
    """Slots whose validity differs or, both valid, whose endpoints are more
    than LINES17_SEG_TOL px apart."""
    gv, wv = got.valid.cpu().numpy(), want.valid.cpu().numpy()
    err = np.abs(got.segments.cpu().numpy() - want.segments.cpu().numpy()).reshape(len(gv), -1)
    return np.nonzero((gv != wv) | (wv & (err.max(1) > LINES17_SEG_TOL)))[0]


def lines17(torch, np, dev):
    """Phase 17 (a): per configuration of LINES17, on LINES17_CPU_PAIRS pairs
    the card against the CPU: SuperPoint's keypoints (near-ties counted), the
    detector's fields and segments (a differing segment must come back when
    the card marches the CPU's fields: a near-tie of the fields' rounding),
    GlueStick on the CPU's features (log assignments within MATCH_TOL,
    matches equal but for near-ties); then the benchmark over MATCH_PAIRS
    pairs on the card, ms per pair of the extractor, the detector and the
    matcher, host syncs per pair and peak memory. Returns (records,
    failures)."""
    from comet_tpu_torch.matching import benchmarks, configs, lines
    from comet_tpu_torch.models.blocks import init_params
    from comet_tpu_torch.weights import module_params_to_jax

    cpu = torch.device("cpu")
    pairs = benchmarks.make_synthetic_pairs(MATCH_PAIRS, (MATCH_IMG, MATCH_IMG), seed=0, device=dev)
    records, failures = [], []
    for name, matcher in LINES17:
        label = name + (f" (GlueStick depth {matcher['depth']}, width {matcher['dim']})" if matcher
                        else "")
        pipes = {d: configs.build_pipeline(name, image_hw=(MATCH_IMG, MATCH_IMG), matcher=matcher)
                 for d in ("card", "cpu")}
        m = type(pipes["cpu"].matcher.matcher)(**pipes["cpu"].matcher.matcher.conf, in_dim=256,
                                               line_in_dim=3)
        init_params(m, torch.Generator().manual_seed(0))
        m.load_state_dict(_gluestick_cosine(torch, m))
        params = module_params_to_jax(m)
        for p in pipes.values():
            p.matcher.holder["params"] = params
        rec = dict(name=label, kp_diff=0, kp_near=0, line_diff=0, line_near=0, field_gap=0.0,
                   match_diff=0, match_near=0, line_match_diff=0, line_match_near=0, la_err=0.0,
                   perturbed_gap=math.inf, perturb_seen=1.0)
        for i in range(LINES17_CPU_PAIRS):
            img0, img1, _ = pairs[i]
            feats = {}
            for side, img in (("0", img0), ("1", img1)):
                got = pipes["card"].extractor(img)
                want = pipes["cpu"].extractor(img.cpu())
                feats[side] = want
                d, n, _ = _keypoint_diffs(np, got["keypoints"].cpu().numpy(),
                                          got["scores"].cpu().numpy(), want["keypoints"].numpy(),
                                          want["scores"].numpy(), 9)
                rec["kp_diff"] += d
                rec["kp_near"] += n
                det = pipes["cpu"].extractor.line_detector
                gray = img.mean(dim=-1)
                kw = {} if det is None else dict(mag_threshold=0.3, angle_tol=0.4)
                mag_gap, th_gap, reach, fields = _field_gaps(
                    torch, np, lines, gray, dev, det, kw.get("mag_threshold", 0.02))
                rec["field_gap"] = max(rec["field_gap"], mag_gap, th_gap)
                rec["perturbed_gap"] = min(rec["perturbed_gap"], reach[0])
                rec["perturb_seen"] = min(rec["perturb_seen"], reach[1])
                segs = lambda o: lines.LineSegments(o["lines"], o["line_scores"],  # noqa: E731
                                                    o["line_valid"])
                slots = _segment_slots(np, segs(got), segs(want))
                replay = lines.march_segments_from_fields(*(f.to(dev) for f in fields),
                                                          max_lines=64, **kw)
                rec["line_diff"] += len(slots)
                rec["line_near"] += int(sum(i not in _segment_slots(np, replay, segs(want))
                                            for i in slots))
            # the matcher on the CPU's features, on both devices
            card_m = pipes["card"].matcher
            f_card = [{k: v.to(dev) if hasattr(v, "to") else v for k, v in feats[s].items()}
                      for s in "01"]
            got = {k: v.cpu() for k, v in card_m(*f_card).items()}
            want = pipes["cpu"].matcher(feats["0"], feats["1"])
            for key, la, dk, nk in (("matches0", "log_assignment", "match_diff", "match_near"),
                                    ("line_matches0", "line_log_assignment", "line_match_diff",
                                     "line_match_near")):
                lg, lw = got[la].numpy(), want[la].numpy()
                rec["la_err"] = max(rec["la_err"], _rel_err(np, lg, lw))
                d, n = _match_diffs(np, got[key].numpy(), want[key].numpy(), lg[:-1, :-1],
                                    lw[:-1, :-1])
                rec[dk] += d
                rec[nk] += n
        # the benchmark on the card, then the parts' ms per pair
        pipe = pipes["card"]
        t0 = time.perf_counter()
        row = benchmarks.run_homography_benchmark(pipe, pairs)
        _sync(torch, dev)
        rec["benchmark_s"] = time.perf_counter() - t0
        ms = {"extractor": [], "detector": [], "matcher": []}
        det = pipe.extractor.line_detector
        for img0, img1, _ in pairs:
            f = []
            for img in (img0, img1):
                out, t = _sync_ms(torch, dev, pipe.extractor, img)
                f.append(out)
                ms["extractor"].append(t)
                gray = img.mean(dim=-1)
                _, t = _sync_ms(torch, dev, (lambda g: lines.detect_line_segments(g, 64))
                                if det is None else det, gray)
                ms["detector"].append(t)
            ms["matcher"].append(_sync_ms(torch, dev, pipe.matcher, *f)[1])
        clock = _StageClock(torch, dev)
        clock.measure("benchmark", benchmarks.run_homography_benchmark, pipe, pairs[:1])
        r = clock.records[0]
        rec.update(row=row, syncs_per_pair=r["syncs"], where=r["where"], peak_gib=r["peak_gib"],
                   extractor_ms=2 * statistics.median(ms["extractor"][2:]),
                   detector_ms=2 * statistics.median(ms["detector"][2:]),
                   matcher_ms=statistics.median(ms["matcher"][1:]))
        bad = [k for k, v in row.items() if isinstance(v, float) and not math.isfinite(v)
               and k != "H_error_ransac"]
        ok = (rec["kp_diff"] == rec["kp_near"] and rec["line_diff"] == rec["line_near"]
              and rec["field_gap"] <= LINES17_FIELD_TOL < rec["perturbed_gap"]
              and rec["la_err"] <= MATCH_TOL
              and rec["match_diff"] == rec["match_near"]
              and rec["line_match_diff"] == rec["line_match_near"] and not bad)
        print(f"lines (a): {label}: on {LINES17_CPU_PAIRS} pairs card against CPU: keypoints "
              f"{rec['kp_diff']} differ ({rec['kp_near']} near-ties), lines {rec['line_diff']} "
              f"differ ({rec['line_near']} near-ties of the fields: the card's march on the CPU's "
              f"fields gives the CPU's), fields within {rec['field_gap']:.2e} (tol "
              f"{LINES17_FIELD_TOL}; the card's orientation moved by {LINES17_PERTURB} rad where "
              f"a march reads it reads {rec['perturbed_gap']:.2e}, and at "
              f"{100 * rec['perturb_seen']:.1f} % of those pixels alone would be seen), log "
              f"assignments within {rec['la_err']:.2e} (tol {MATCH_TOL}), "
              f"matches {rec['match_diff']} differ ({rec['match_near']} near-ties), line matches "
              f"{rec['line_match_diff']} ({rec['line_match_near']} near-ties); benchmark at "
              f"{MATCH_PAIRS} pairs on the card {json.dumps(row)} in {rec['benchmark_s']:.1f} s; "
              f"per pair: extractor {rec['extractor_ms']:.1f} ms (both images; of it the detector "
              f"{rec['detector_ms']:.1f}), matcher {rec['matcher_ms']:.1f} ms, "
              f"{rec['syncs_per_pair']} host syncs {rec['where']}, peak {_gib(rec['peak_gib'])}"
              + ("" if ok else " FAILED"), flush=True)
        if not ok:
            failures.append(f"(a) {label}")
        records.append(rec)
    return records, failures


def _plane_views(np, size, n_kp, seed=0):
    """Two size x size views of a plane with exact depth maps (holes of
    depth 0), n_kp keypoints of view 0 and their noisy projections into view
    1 (the last quarter at random) and 64 segments with their warps."""
    rng = np.random.default_rng(seed)
    f = 0.9 * size
    k = np.asarray([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]])
    axis = np.asarray([0.2, 1.0, 0.1]) / np.linalg.norm([0.2, 1.0, 0.1])
    kx = np.asarray([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    r = np.eye(3) + np.sin(0.15) * kx + (1 - np.cos(0.15)) * kx @ kx
    t = np.asarray([0.4, -0.1, 0.05])
    n, d = np.asarray([0.1, -0.05, 1.0]), 4.0
    ys, xs = np.mgrid[0:size, 0:size] + 0.5
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(k).T
    depth0 = d / (rays @ n)
    n1 = r @ n
    depth1 = (d + n1 @ t) / (rays @ n1)
    for dm in (depth0, depth1):
        for _ in range(6):
            y, x = rng.integers(0, size - size // 8, 2)
            dm[y:y + size // 8, x:x + size // 10] = 0.0
    h01 = k @ (r + np.outer(t, n) / d) @ np.linalg.inv(k)

    def warp(p):
        q = np.concatenate([p, np.ones_like(p[:, :1])], -1) @ h01.T
        return q[:, :2] / q[:, 2:]

    kp0 = rng.uniform(2, size - 2, (n_kp, 2))
    kp1 = warp(kp0) + rng.normal(0, 0.5, kp0.shape)
    kp1[3 * n_kp // 4:] = rng.uniform(2, size - 2, (n_kp - 3 * n_kp // 4, 2))
    l0 = rng.uniform(4, size - 4, (64, 2, 2))
    l1 = warp(l0.reshape(-1, 2)).reshape(64, 2, 2) + rng.normal(0, 0.3, (64, 2, 2))
    return {k_: np.asarray(v, np.float32) for k_, v in dict(
        kp0=kp0, kp1=kp1, depth0=depth0, depth1=depth1, K0=k, K1=k, R=r, t=t, l0=l0,
        l1=l1).items()}


def depth17(torch, np, dev):
    """Phase 17 (b): ``gt_matches_from_pose_depth`` (with circle and
    epipolar checks) and ``gt_line_matches_from_pose_depth`` on DEPTH17_KP
    keypoints and 64 segments of MATCH_IMG px depth maps, card against CPU:
    labels equal, ms per call. Returns (record, failures)."""
    from comet_tpu_torch.matching import depth_gt

    s = _plane_views(np, MATCH_IMG, DEPTH17_KP)
    pose = ("depth0", "depth1", "K0", "K1", "R", "t")
    calls = {
        "gt_matches_from_pose_depth": lambda a: depth_gt.gt_matches_from_pose_depth(
            a["kp0"], a["kp1"], *(a[k] for k in pose), cc_threshold=4.0, epi_threshold=1.0),
        "gt_line_matches_from_pose_depth": lambda a: depth_gt.gt_line_matches_from_pose_depth(
            a["l0"], a["l1"], *(a[k] for k in pose)),
    }
    rec, failures = {}, []
    for name, fn in calls.items():
        out, times = {}, {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            a = {k: torch.as_tensor(v, device=d) for k, v in s.items()}
            fn(a)
            ts = []
            for _ in range(5):
                res, t = _sync_ms(torch, d, fn, a)
                ts.append(t)
            out[where], times[where] = res, statistics.median(ts)
        keys = [k for k in out["cpu"] if k.startswith(("matches", "line_matches", "visible",
                                                       "assignment"))]
        unequal = [k for k in keys if not torch.equal(out["card"][k].cpu(), out["cpu"][k])]
        m = out["cpu"]["matches0" if "matches0" in out["cpu"] else "line_matches0"]
        rec[name] = dict(card_ms=times["card"], cpu_ms=times["cpu"], unequal=unequal,
                         matched=int((m >= 0).sum()))
        print(f"depth GT (b): {name} ({DEPTH17_KP} keypoints, 64 segments, {MATCH_IMG} px): labels "
              f"{'equal' if not unequal else f'UNEQUAL {unequal}'} card against CPU ({keys}; "
              f"{rec[name]['matched']} matched), card {times['card']:.2f} ms, CPU "
              f"{times['cpu']:.2f} ms per call", flush=True)
        if unequal:
            failures.append(f"(b) {name}")
    return rec, failures


def _slot_map(np, got_kp, want_kp):
    """For each keypoint slot of the card, the CPU's slot of the same
    keypoint; None where the sets differ or a keypoint repeats."""
    where = {tuple(p): i for i, p in enumerate(want_kp.tolist())}
    slots = [where.get(tuple(p)) for p in got_kp.tolist()]
    if len(where) != len(want_kp) or len(slots) != len(want_kp) or None in slots:
        return None
    return np.asarray(slots)


def _pair_matches(torch, np, ext, items, preds):
    """One pair of a pipeline's loader, card against CPU: (keypoint
    disagreements, near-ties among them, whether matches0 compared, its
    disagreements, near-ties among them). ``items``/``preds`` are (card,
    CPU); ``ext`` the extractors (card, CPU) or None where the model is the
    synthetic pairs' oracle. Where both devices found the same keypoints,
    the card's matches0 and similarities are put in the CPU's slots
    (``_slot_map``) and compared index for index; a differing match is a
    near-tie where a row or a column it involves has its two best
    similarities within MATCH_NEAR_TIE (``_match_diffs``)."""
    m = [np.asarray(p["matches0"].cpu() if hasattr(p["matches0"], "cpu") else p["matches0"])
         for p in preds]
    if ext is None:
        return 0, 0, True, int((m[0] != m[1]).sum()), 0
    feats = [[e(it[f"image{s}"]) for s in "01"] for e, it in zip(ext, items)]
    kd = kn = 0
    slots = []
    for side in (0, 1):
        g, w = (f[side] for f in feats)
        gk, wk = g["keypoints"].cpu().numpy(), w["keypoints"].numpy()
        d, n, _ = _keypoint_diffs(np, gk, g["scores"].cpu().numpy(), wk, w["scores"].numpy(), 1)
        kd, kn = kd + d, kn + n
        slots.append(_slot_map(np, gk, wk))
    if kd or slots[0] is None or slots[1] is None:
        return kd, kn, False, 0, 0
    s0, s1 = slots
    got = np.full_like(m[1], -1)
    got[s0] = np.where(m[0] >= 0, s1[np.clip(m[0], 0, None)], -1)
    sims = []
    for f0, f1 in feats:
        sim = (f0["descriptors"] @ f1["descriptors"].T).cpu().numpy()
        ok = f0["valid"].cpu().numpy()[:, None] & f1["valid"].cpu().numpy()[None, :]
        sims.append(np.where(ok, sim, -np.inf))
    card_sim = np.empty_like(sims[0])
    card_sim[np.ix_(s0, s1)] = sims[0]
    md, mn = _match_diffs(np, got, m[1], card_sim, sims[1])
    return kd, kn, True, md, mn


def _pipeline_models(torch, np, cli, dev, tmp, images, pairs_file, amd, have_h5py):
    """(c): each pipeline's model over its loader on the card against the
    CPU, pair by pair (``_pair_matches``: keypoints and matches0 equal but
    for near-ties); without h5py, ``run`` and --export-features raising,
    naming it. Returns (records, failures)."""
    import os

    from comet_tpu_torch.matching import eval_pipeline, registry

    confs = [
        ("hpatches, synthetic", eval_pipeline.HomographyEvalPipeline,
         {"data": {"n_pairs": PIPE17_PAIRS, "image_size": MATCH_IMG}}),
        ("hpatches, pairs file", eval_pipeline.HomographyEvalPipeline,
         {"data": {"image_dir": images, "pairs_file": pairs_file}}),
        ("relpose, synthetic", eval_pipeline.RelativePoseEvalPipeline,
         {"data": {"n_pairs": PIPE17_PAIRS}}),
        ("relpose, AMD fixture", eval_pipeline.RelativePoseEvalPipeline,
         {"data": {"amd_dir": amd, "max_pairs": PIPE17_AMD_PAIRS}}),
    ]
    records, failures = [], []
    for label, cls, conf in confs:
        pipes = [cls(conf, device=d) for d in (dev, torch.device("cpu"))]
        loaders = [list(p.get_dataloader()) for p in pipes]
        models = [p.get_model() for p in pipes]
        mc = pipes[1].conf["model"]
        oracle = "kpts_proj0" in loaders[1][0]
        ext = None if oracle else [registry.get_model(mc["extractor"], **mc["extractor_conf"],
                                                      device=p.device) for p in pipes]
        t0 = time.perf_counter()
        rec = dict(name=label, pairs=len(loaders[1]), kp_diff=0, kp_near=0, compared=0,
                   match_diff=0, match_near=0, matches=[])
        for items in zip(*loaders):
            preds = [mdl(it) for mdl, it in zip(models, items)]
            kd, kn, compared, md, mn = _pair_matches(torch, np, ext, items, preds)
            rec["compared"] += compared
            rec["kp_diff"] += kd
            rec["kp_near"] += kn
            rec["match_diff"] += md
            rec["match_near"] += mn
            rec["matches"].append(int((np.asarray(preds[1]["matches0"]) >= 0).sum()))
        _sync(torch, dev)
        rec["seconds"] = time.perf_counter() - t0
        raised = None
        if not have_h5py:
            try:
                cls(conf, device=dev).run(os.path.join(tmp, "no_h5py"))
            except ModuleNotFoundError as exc:
                raised = str(exc)
        ok = (rec["kp_diff"] == rec["kp_near"] and rec["match_diff"] == rec["match_near"]
              and (have_h5py or (raised is not None and "h5py" in raised)))
        print(f"pipelines (c): {label}: {rec['pairs']} pairs, card against CPU: keypoints "
              f"{rec['kp_diff']} differ ({rec['kp_near']} near-ties), matches0 "
              f"{rec['match_diff']} differ index for index on the {rec['compared']} pairs with "
              f"equal keypoints ({rec['match_near']} near-ties); "
              f"matches per pair {rec['matches']}; {rec['seconds']:.1f} s"
              + ("" if have_h5py else f"; run raised: {raised}") + ("" if ok else " FAILED"),
              flush=True)
        if not ok:
            failures.append(f"(c) {label}")
        records.append(rec)
    if have_h5py:
        print("pipelines (c): h5py is installed: the .h5 file round trip is held to the JAX "
              "package on the CPU (tests/test_torch_port_pipelines.py), not run here", flush=True)
        return records, failures
    try:
        _run_cli(cli, ["match", "--experiment", "sift+nn", "--export-features", images])
        raised = None
    except ModuleNotFoundError as exc:
        raised = str(exc)
    print(f"pipelines (c): --export-features raised: {raised}; the .h5 file round trip was not "
          "run on the card (no h5py on this machine)", flush=True)
    if raised is None or "h5py" not in raised:
        failures.append("(c) --export-features without h5py")
    return records, failures


def pipelines17(torch, np, dev, tmp):
    """Phase 17 (c): the fixtures (a directory of MATCH_IMG px images, a
    pairs file of their known warps, an AMD fixture), then the pipelines'
    models (``_pipeline_models``). Returns (records, failures, have_h5py)."""
    import importlib.util
    import os

    from PIL import Image

    from comet_tpu_torch import cli
    from comet_tpu_torch.data import fixtures
    from comet_tpu_torch.matching import benchmarks

    images = os.path.join(tmp, "images")
    os.makedirs(images)
    rng = np.random.default_rng(17)
    lines_ = []
    for i in range(2):
        img = benchmarks.synthetic_texture(rng, MATCH_IMG, MATCH_IMG)
        h = benchmarks.random_homography(rng, MATCH_IMG, MATCH_IMG)
        warped = benchmarks.warp_image(torch.as_tensor(img), torch.as_tensor(h, dtype=torch.float32))
        for name, a in ((f"a{i}.png", img), (f"b{i}.png", warped.numpy())):
            Image.fromarray((np.clip(a[..., 0], 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(images, name))
        lines_.append(f"a{i}.png b{i}.png " + " ".join(f"{v:.9g}" for v in h.ravel()))
    pairs_file = os.path.join(tmp, "pairs.txt")
    with open(pairs_file, "w") as f:
        f.write("\n".join(lines_) + "\n")
    amd = os.path.join(tmp, "AMD")
    fixtures.generate_amd_fixture(amd, n_seqs=1, n_frames=2 * PIPE17_AMD_PAIRS + 1, seed=17)
    have_h5py = importlib.util.find_spec("h5py") is not None
    print(f"pipelines (c): h5py {'is' if have_h5py else 'is NOT'} installed here", flush=True)
    records, failures = _pipeline_models(torch, np, cli, dev, tmp, images, pairs_file, amd,
                                         have_h5py)
    return records, failures, have_h5py


def lines_pipelines_phase(torch, np, counters, dev, smi):
    """Phase 17: line matching (a), depth ground truth (b) and the
    cached-prediction pipelines (c), TF32 off for the comparisons; no kernel
    may launch. Returns the phase's record."""
    import tempfile

    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        raise SmokeError("phase 17: TF32 matmuls are on; the comparisons run in f32")
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    _reset(counters)
    failures, parts = [], {}
    try:
        t0 = time.perf_counter()
        lines_rec, f = lines17(torch, np, dev)
        parts["lines"], failures = time.perf_counter() - t0, failures + f
        t0 = time.perf_counter()
        depth_rec, f = depth17(torch, np, dev)
        parts["depth"], failures = time.perf_counter() - t0, failures + f
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            pipe_rec, f, have_h5py = pipelines17(torch, np, dev, tmp)
        parts["pipelines"], failures = time.perf_counter() - t0, failures + f
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    launched = _launches(counters)
    if sum(launched.values()):
        failures.append(f"kernels launched {launched}")
    rec = dict(lines=lines_rec, depth=depth_rec, pipelines=pipe_rec, h5py=have_h5py, parts=parts,
               seconds=time.perf_counter() - t_phase)
    print(f"phase 17: {rec['seconds']:.1f} s (lines {parts['lines']:.1f}, depth GT "
          f"{parts['depth']:.1f}, pipelines {parts['pipelines']:.1f}); K1-K5 launches {launched}; "
          f"on {smi}", flush=True)
    if failures:
        raise SmokeError(f"phase 17: {'; '.join(failures)}")
    return rec


# phase 18: resuming the JAX package's training run, checkpoints of a
# tensor-parallel model, and the matching helpers on the card. (a) phase 8's
# train steps on the default route: RESUME18_STEPS steps, the state written in
# the JAX package's checkpoint layout (jax_train_state, the port's msgpack
# writer) and restored through training.auto_resume into a fresh model,
# optimizer and scheduler; the next step taken RESUME18_RERUNS times from the
# uninterrupted state, whose spread (the plain backwards' atomics) sets the
# restored step's tolerance, RESUME18_SPREAD x it (0 where the reruns agree
# bit for bit)
RESUME18_STEPS = 2
RESUME18_RERUNS = 3
RESUME18_SPREAD = 2.0
# (c): the patches of matching/patches.py at these corners of a 3 x 480 x 640
# image (ps 31), and benchmark_model's calls of K1
HELPERS18_PS = 31
HELPERS18_CORNERS = 256
HELPERS18_REPS = 50


def _masked_moments(tree, trained, convert_leaf, path=()):
    """A flax tree of per-parameter values with the leaves of parameters
    not in ``trained`` as optax's masked-out leaves, ``{}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _masked_moments(v, trained, convert_leaf, path + (k,))
        else:
            out[k] = v if convert_leaf(path + (k,), v)[0] in trained else {}
    return out


def jax_train_state(model, optimizer, scheduler):
    """The port's training state as the JAX package's checkpoint tree, in
    flax's layout, as ``tools/orbax_to_msgpack.py`` writes it:
    ``{"params": the model's flax variables, "opt": optax's
    multi_transform({"train": masked(chain(clip_by_global_norm,
    adamw))}, ...) state}``, ``exp_avg`` -> ``mu``, ``exp_avg_sq`` -> ``nu``,
    the scheduler's count -> both counts. The inverse of
    ``training.checkpoints``' mapping, built on ``weights.module_params_to_jax``."""
    import numpy as np
    import torch

    from comet_tpu_torch.weights import convert_leaf, module_params_to_jax

    names = {id(p): n for n, p in model.named_parameters()}
    held = [p for group in optimizer.param_groups for p in group["params"]]
    trained = {names[id(p)] for p in held}
    count = np.array(scheduler.last_epoch, np.int32)

    def moments(key):
        values = {n: torch.zeros((), device=p.device).expand(p.shape)
                  for n, p in model.named_parameters()}
        for p in held:
            if p in optimizer.state:
                values[names[id(p)]] = optimizer.state[p][key]
        tree = module_params_to_jax(model, values)
        return {"params": _masked_moments(tree["params"], trained, convert_leaf)}

    adam = {"count": count, "mu": moments("exp_avg"), "nu": moments("exp_avg_sq")}
    return {"params": module_params_to_jax(model), "opt": {"inner_states": {
        "freeze": {"inner_state": {}},
        "train": {"inner_state": {"0": {}, "1": {"0": adam, "1": {}, "2": {"count": count}}}}}}}


def _trained_params(model, optimizer):
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: p.detach().clone() for g in optimizer.param_groups for p in g["params"]}


def _largest_gap(got, want):
    return max((got[n] - want[n]).abs().max().item() for n in want)


def resume18(torch, tcfg, geom, models, training, serialization, cfg, model, counters, dev, tmp):
    """Phase 18 (a): returns its record."""
    import copy
    import os

    import numpy as np

    model.set_route(tcfg.KernelRoute())
    gt = _train_gt(torch, np, geom, cfg, dev)
    requests = [_request(torch, cfg, 200 + i, dev) for i in range(RESUME18_STEPS + 1)]
    optimizer, scheduler = training.build_optimizer(model, cfg.train.lr, steps_per_epoch=100)
    step = training.build_train_step(model, cfg, optimizer, scheduler)
    _reset(counters)
    for images, queries in requests[:-1]:
        step(images, queries, gt)
    launched = _launches(counters)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt_state, sched_state = copy.deepcopy(optimizer.state_dict()), scheduler.state_dict()

    # the JAX package's layout, written with the port's msgpack writer
    path = os.path.join(tmp, "ckpt", f"ckpt_{RESUME18_STEPS - 1:06d}")
    os.makedirs(path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = serialization.msgpack_serialize(jax_train_state(model, optimizer, scheduler))
    with open(os.path.join(path, "state.msgpack"), "wb") as f:
        f.write(blob)
    write_s, nbytes = time.perf_counter() - t0, len(blob)
    del blob

    # the uninterrupted next step, RESUME18_RERUNS times from the same state
    reruns = []
    for i in range(RESUME18_RERUNS):
        if i:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(params[n])
            optimizer.load_state_dict(copy.deepcopy(opt_state))
            scheduler.load_state_dict(sched_state)
        aux = step(*requests[-1], gt)
        reruns.append((aux["loss"].item(), _trained_params(model, optimizer)))
    loss_spread = max(abs(a[0] - b[0]) for a in reruns for b in reruns)
    param_spread = max(_largest_gap(a[1], b[1]) for a in reruns for b in reruns)

    # restored into a fresh model, optimizer and scheduler on the card
    fresh = models.build_comet(cfg, device=dev, seed=1)
    f_opt, f_sched = training.build_optimizer(fresh, cfg.train.lr, steps_per_epoch=100)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start, state = training.auto_resume(os.path.join(tmp, "ckpt"), {
        "model": fresh, "optimizer": f_opt, "scheduler": f_sched, "epoch": -1})
    torch.cuda.synchronize()
    read_s, count = time.perf_counter() - t0, f_sched.last_epoch
    unequal = [n for n, p in fresh.named_parameters() if not torch.equal(p, params[n])]
    held = [p for g in f_opt.param_groups for p in g["params"]]
    moments_unequal = sum(
        not torch.equal(f_opt.state[p][k], opt_state["state"][i][k])
        for i, p in enumerate(held) for k in ("exp_avg", "exp_avg_sq"))
    steps = {float(f_opt.state[p]["step"]) for p in held}
    want_steps = {float(st["step"]) for st in opt_state["state"].values()}
    lr, want_lr = f_opt.param_groups[0]["lr"], opt_state["param_groups"][0]["lr"]
    f_step = training.build_train_step(fresh, cfg, f_opt, f_sched)
    _reset(counters)
    aux = f_step(*requests[-1], gt)
    restored_launches = _launches(counters)
    loss = aux["loss"].item()
    loss_gap = abs(loss - reruns[0][0])
    param_gap = _largest_gap(_trained_params(fresh, f_opt), reruns[0][1])
    rec = dict(bytes=nbytes, write_s=write_s, read_s=read_s, start=start, epoch=state["epoch"],
               unequal=unequal, moments_unequal=moments_unequal, steps=sorted(steps),
               sched=count, lr=lr, loss=loss, rerun_losses=[r[0] for r in reruns],
               loss_spread=loss_spread, param_spread=param_spread, loss_gap=loss_gap,
               param_gap=param_gap, launches=launched, restored_launches=restored_launches)
    ok = (start == RESUME18_STEPS and state["epoch"] == RESUME18_STEPS - 1 and not unequal
          and not moments_unequal and steps == want_steps == {float(RESUME18_STEPS)}
          and count == RESUME18_STEPS and lr == want_lr and math.isfinite(loss)
          and loss_gap <= RESUME18_SPREAD * loss_spread
          and param_gap <= RESUME18_SPREAD * param_spread
          and launched == {k: RESUME18_STEPS * n for k, n in PER_FORWARD["default"].items()}
          and restored_launches == PER_FORWARD["default"])
    print(f"phase 18 (a): {RESUME18_STEPS} train steps (default route), the state in the JAX "
          f"package's checkpoint layout: {nbytes} bytes, written in {write_s:.1f} s, restored "
          f"by auto_resume into a fresh model, optimizer and scheduler in {read_s:.1f} s (start "
          f"epoch {start}); parameters unequal {len(unequal)}, moments unequal "
          f"{moments_unequal}, step {sorted(steps)}, scheduler count {count}, lr "
          f"{lr:.6g} (want {want_lr:.6g}); next step from the restored state: loss {loss:.6f} "
          f"against {reruns[0][0]:.6f} uninterrupted (|diff| {loss_gap:.3e}), camera "
          f"parameters |diff| {param_gap:.3e}; spread of {RESUME18_RERUNS} uninterrupted steps: "
          f"loss {loss_spread:.3e}, parameters {param_spread:.3e} (tolerance {RESUME18_SPREAD} x "
          f"the spread); launches {launched} over {RESUME18_STEPS} steps, {restored_launches} in "
          f"the restored step" + ("" if ok else " FAILED"), flush=True)
    if not ok:
        raise SmokeError(f"phase 18 (a): {rec}")
    del fresh, f_opt, f_sched, f_step, reruns, params, opt_state, optimizer, scheduler, step
    torch.cuda.empty_cache()
    return rec


def _tp_save18(torch, training, model, optimizer, scheduler, ckpt_dir):
    """Phase 18 (b) in a rank, after the first tensor-parallel step: the
    checkpoint (every rank calls ``save_checkpoint``; the shards gathered
    whole, rank 0 writes), timed, and this rank's shards of the parameters
    and of the Adam moments as they were saved."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = training.save_checkpoint(ckpt_dir, 0, {"model": model, "optimizer": optimizer,
                                                  "scheduler": scheduler})
    held = [p for g in optimizer.param_groups for p in g["params"]]
    return dict(path=path, save_s=time.perf_counter() - t0,
                params={n: p.detach().clone() for n, p in model.named_parameters()},
                moments=[{k: optimizer.state[p][k].clone() for k in ("exp_avg", "exp_avg_sq")}
                         for p in held])


def _moments_match(torch, optimizer, saved, part):
    """The optimizer's moments, each through ``part(i, tensor)``, equal
    bit for bit to the saved shards; and its steps."""
    held = [p for g in optimizer.param_groups for p in g["params"]]
    equal = all(torch.equal(part(i, optimizer.state[p][k]), saved["moments"][i][k])
                for i, p in enumerate(held) for k in ("exp_avg", "exp_avg_sq"))
    return equal, sorted({float(optimizer.state[p]["step"]) for p in held})


def _tp_restore18(torch, models, training, parallel, data_parallel, cfg, route, mesh, dev, gt,
                  request, tp_model, tp_optimizer, saved, uninterrupted):
    """Phase 18 (b) in a rank: the checkpoint restored into the replicated
    model (this rank's part of every whole tensor equal to its shard as
    saved) and into a fresh tensor-parallel model (equal to the shards),
    then the second step from that state, against the uninterrupted one."""
    import os

    held_tp = [p for g in tp_optimizer.param_groups for p in g["params"]]
    rec = dict(save_s=saved["save_s"],
               bytes=os.path.getsize(os.path.join(saved["path"], training.checkpoints.STATE_FILE)))
    for kind in ("replicated", "tp"):
        model = models.build_comet(cfg, device=dev, seed=1, route=route)
        if kind == "tp":
            parallel.shard_params_tp(mesh, model)
        optimizer, scheduler = training.build_optimizer(model, cfg.train.lr, steps_per_epoch=100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        training.restore_checkpoint(saved["path"], {"model": model, "optimizer": optimizer,
                                                    "scheduler": scheduler})
        torch.cuda.synchronize()
        rec[f"{kind}_read_s"] = time.perf_counter() - t0
        whole = kind == "replicated"  # this rank's part of each whole tensor, else the shard
        rec[f"{kind}_params_equal"] = all(
            torch.equal(parallel.shard_of(tp_model, n, p.detach()) if whole else p,
                        saved["params"][n]) for n, p in model.named_parameters())
        rec[f"{kind}_moments_equal"], rec[f"{kind}_steps"] = _moments_match(
            torch, optimizer, saved,
            lambda i, t: parallel.local_part(held_tp[i], t) if whole else t)
        rec[f"{kind}_sched"] = scheduler.last_epoch
        if kind == "tp":
            trained = data_parallel.replicate_train_state(mesh, model, optimizer)
            aux = training.build_train_step(trained, cfg, optimizer, scheduler)(*request, gt)
            rec.update(loss=aux["loss"].item(), norm=optimizer.last_norm.item(),
                       want_loss=uninterrupted["losses"][1], want_norm=uninterrupted["norms"][1])
            del trained, aux
        del model, optimizer, scheduler
        torch.cuda.empty_cache()
    return rec


def check_tp18(ranks, smi):
    """Phase 18 (b)'s records from phase 12's ranks, held to their checks
    (the step after the restore at phase 12 (e)'s REF_RTOL)."""
    for r, rec in enumerate(ranks):
        loss_gap = abs(rec["loss"] - rec["want_loss"]) / abs(rec["want_loss"])
        norm_gap = abs(rec["norm"] - rec["want_norm"]) / abs(rec["want_norm"])
        ok = (all(rec[f"{k}_params_equal"] and rec[f"{k}_moments_equal"]
                  and rec[f"{k}_steps"] == [1.0] and rec[f"{k}_sched"] == 1
                  for k in ("replicated", "tp"))
              and loss_gap <= REF_RTOL and norm_gap <= REF_RTOL)
        print(f"phase 18 (b), rank {r}: tensor-parallel checkpoint (data 1, model 2, gloo on one "
              f"card) after one step: {rec['bytes']} bytes, saved in {rec['save_s']:.1f} s; "
              f"restored into the replicated model in {rec['replicated_read_s']:.1f} s (this "
              f"rank's parts equal to its shards: parameters {rec['replicated_params_equal']}, "
              f"moments {rec['replicated_moments_equal']}) and into tensor parallelism in "
              f"{rec['tp_read_s']:.1f} s (parameters {rec['tp_params_equal']}, moments "
              f"{rec['tp_moments_equal']}); the next step from it: loss {rec['loss']:.6f} "
              f"against {rec['want_loss']:.6f} uninterrupted ({loss_gap:.2e}), norm "
              f"{rec['norm']:.6g} against {rec['want_norm']:.6g} ({norm_gap:.2e}; limit "
              f"{REF_RTOL}); on {smi}" + ("" if ok else " FAILED"), flush=True)
        if not ok:
            raise SmokeError(f"phase 18 (b) rank {r}: {rec}")


def helpers18(torch, np, attn, k1_rows, dev, smi):
    """Phase 18 (c): the matching helpers on the card. Returns the record."""
    from comet_tpu_torch.matching import misc, patches, tools

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(18)
    img = torch.rand(3, 480, 640, generator=gen)
    corners = torch.rand(HELPERS18_CORNERS, 2, generator=gen) * torch.tensor([700.0, 540.0]) - 30
    got = patches.extract_patches(img.to(dev), corners.to(dev), HELPERS18_PS)
    want = patches.extract_patches(img, corners, HELPERS18_PS)
    imgs, kpts = img[None].repeat(2, 1, 1, 1), corners.view(2, -1, 2)
    got_b = patches.batch_extract_patches(imgs.to(dev), kpts.to(dev), HELPERS18_PS)
    want_b = patches.batch_extract_patches(imgs, kpts, HELPERS18_PS)
    equal = all(g.is_cuda and torch.equal(g.cpu(), w) for g, w in zip(got + got_b, want + want_b))
    batch = {"image": np.zeros((2, 3, 8, 8), np.float32), "views": [torch.ones(2, 4), {
        "kpts": torch.zeros(2, 5, 2), "n": 3}], "name": "pair", "none": None}
    moved = misc.batch_to_device(batch, dev)
    leaves = []
    misc.map_tensor(moved, leaves.append)
    on_card = all(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves)
    # benchmark_model of K1 at the ViT's shape, beside phase 3's CUDA-event time
    where, b, lq, lk, c, h, *_ = K1_SHAPES[0]
    qkv = torch.randn(b, lq, 3 * c, device=dev).bfloat16()
    q, k, v = qkv.split(c, dim=-1)
    bench = tools.benchmark_model(lambda x: attn.fused_attention(*x, h), (q, k, v),
                                  r=HELPERS18_REPS, warmup=5)
    event_ms = next(r["ms"] for r in k1_rows if r["where"] == where)
    rec = dict(patches_equal=equal, on_card=on_card, leaves=len(leaves), bench=bench,
               event_ms=event_ms)
    print(f"phase 18 (c): extract_patches and batch_extract_patches (ps {HELPERS18_PS}, "
          f"{HELPERS18_CORNERS} corners of a 3 x 480 x 640 image, the clamp included) on the "
          f"card equal to the CPU: {equal}; batch_to_device of a nested batch: {len(leaves)} "
          f"leaves, every tensor on the card: {on_card}; benchmark_model of K1 at {where} "
          f"[{b},{lq},{c}] H{h}: {bench['mean']:.4f} ms mean ({bench['std']:.4f} std, host clock, "
          f"launch + synchronize) against {event_ms:.4f} ms between CUDA events (phase 3); on "
          f"{smi}", flush=True)
    if not (equal and on_card and bench["mean"] > 0):
        raise SmokeError(f"phase 18 (c): {rec}")
    return rec


def resume_phase(torch, np, tcfg, geom, models, training, serialization, attn, cfg, model,
                 counters, k1_rows, distributed, dev, smi):
    """Phase 18: (a) ``resume18``; (b) ``check_tp18`` of phase 12's ranks;
    (c) ``helpers18``. Returns the records and the phase's seconds."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        resumed = resume18(torch, tcfg, geom, models, training, serialization, cfg, model,
                           counters, dev, tmp)
    check_tp18(distributed["tp_ckpt"], smi)
    helped = helpers18(torch, np, attn, k1_rows, dev, smi)
    seconds = time.perf_counter() - t0
    print(f"phase 18: {seconds:.1f} s, on {smi}", flush=True)
    return dict(seconds=seconds, resumed=resumed, tp=distributed["tp_ckpt"], helpers=helped)


# ---------------------------------------------------------------------------
# phase 19: the reference's released checkpoints into the port without JAX
# (comet_tpu_torch/utils/convert_torch_weights.py). (a) a full-width `ours`
# checkpoint in the reference's layout (phase 5's weights from seed 0, the
# trackers' coordinate updates held at 0, the DINOv2 pos_embed at its stored
# 37 x 37 grid, a "module." prefix, wrapped in
# {"model": ...}) converted by the module's command, loaded as `--checkpoint`
# loads it and run on both routes against the CPU; (b) `--self-test` at full
# width; (c) an official-layout LightGlue (the release's names, no
# input_proj) and a superpoint_v1 SuperPoint converted, on the card against
# the CPU, the LightGlue adaptive and pruning.
# ---------------------------------------------------------------------------
CONVERT19_GRID = 37
CONVERT19_POS_STD = 0.02  # DINOv2's pos_embed init
CONVERT19_TIMEOUT = 300
CONVERT19_MODULE = "comet_tpu_torch.utils.convert_torch_weights"
CONVERT19_OUTPUTS = ("coarse_track", "pred_track", "track_vis", "track_score", "pred_pose_enc")
# (a): each output on the card in bf16 against the same weights' f32 forward
# on the CPU, within REF_RTOL of the CPU's largest value. The checkpoint holds
# the trackers' coordinate updates at 0 (``_still_tracks``, as phase 12 (e)
# does): with them, the random trackers turned bf16 rounding into 5.4 % of the
# coarse tracks' range, 16 % of the refined tracks' and 97 % of the scores'
# (H100). The scores (the inverse spread of a softmax over random fine
# features, normalized by its largest frame) still miss it: PyTorch's own
# bf16 forward on the CPU moves them by 5.2 % of their range, the card by
# 4.2 % (H100). An output in CONVERT19_KNOWN_MISS that misses is printed as
# such and held instead to the CPU's bf16 trackers (``COMET._track``, the part
# of the forward that makes the scores) within REF_RTOL; it fails where those
# meet REF_RTOL against f32 (the miss would then be the card's own).
CONVERT19_KNOWN_MISS = ("track_score",)
# (c): the adaptive LightGlue (MATCH_ADAPTIVE) prunes after layer 0 and
# stops after layer CONVERT19_STOP. Layer 0's token-confidence and
# matchability biases put the thresholds in the widest gap between two
# points' logits within the CONVERT19_SPLIT quantiles (measured on the CPU),
# so no point sits within rounding of a threshold; the layers between take
# -CONVERT19_FAR (no point confident: none pruned, no stop), layer
# CONVERT19_STOP +CONVERT19_FAR (every point confident: the stop).
CONVERT19_STOP = 3
CONVERT19_SPLIT = (0.3, 0.7)
CONVERT19_FAR = 12.0


def _run_child(argv, timeout):
    """``argv`` in a child process from the checkout's root: (exit code,
    stdout, stderr, wall seconds, the child's peak resident bytes sampled
    from /proc every 20 ms once it runs ``argv``, or None where /proc does
    not show them). Neither the child's ``ru_maxrss`` nor its first samples
    would do: until its exec the child counts the parent's pages."""
    import os
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    page, peak, done = os.sysconf("SC_PAGE_SIZE"), [None], threading.Event()
    own = ("\0".join(argv) + "\0").encode()

    def sample():
        while not done.is_set():
            try:
                with open(f"/proc/{proc.pid}/cmdline", "rb") as f:
                    execed = f.read() == own
                with open(f"/proc/{proc.pid}/statm") as f:
                    resident = int(f.read().split()[1]) * page
                if execed:
                    peak[0] = max(peak[0] or 0, resident)
            except (OSError, ValueError, IndexError):
                pass
            done.wait(0.02)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        err += f"\n(killed after {timeout} s)"
    finally:
        done.set()
        sampler.join()
    return proc.returncode, out, err, time.perf_counter() - t0, peak[0]


def _in_gib(nbytes):
    return None if nbytes is None else nbytes / 2 ** 30


def convert19a(torch, np, tcfg, models, serialization, cfg, counters, dev, tmp, beside):
    """Phase 19 (a): returns its record. ``beside()`` is called as the CPU's
    forwards start (they take most of (a), on the host's cores)."""
    import filecmp
    import os

    from comet_tpu_torch import cli
    from comet_tpu_torch.utils import convert_torch_weights as conv
    from comet_tpu_torch.weights import module_params_to_jax, params_from_jax

    rec = {}
    # the reference's layout of phase 5's weights: the mapping's inverse
    t0 = time.perf_counter()
    cpu_model = _still_tracks(torch, models.build_comet(cfg.replace(compute_dtype="float32"),
                                                        device="cpu", seed=0))
    flat = conv.flatten_params(module_params_to_jax(cpu_model)["params"])
    mapping = conv.build_mapping(cfg)
    rng = np.random.default_rng(0)
    sd = {}
    for path, value in flat.items():
        key, tf = mapping[path]
        if tf is conv.t_conv:
            value = value.transpose(3, 2, 0, 1)
        elif tf is conv.t_linear:
            value = value.T
        elif tf is not conv.t_none:  # the pos_embed, at DINOv2's stored grid
            value = CONVERT19_POS_STD * rng.standard_normal(
                (1, 1 + CONVERT19_GRID ** 2, value.shape[-1]), dtype=np.float32)
        sd["module." + key] = torch.from_numpy(np.ascontiguousarray(value))
    del flat
    bin_path = os.path.join(tmp, "best.bin")
    torch.save({"model": sd}, bin_path)
    rec["parameters"] = sum(v.numel() for v in sd.values())
    del sd
    rec["make_s"], rec["bin_bytes"] = time.perf_counter() - t0, os.path.getsize(bin_path)

    # the module's command, as a user runs it, beside its import alone (the
    # resident floor of a process that imports torch)
    rec["import_rss"] = _run_child([sys.executable, "-c", f"import {CONVERT19_MODULE}"],
                                   CONVERT19_TIMEOUT)[4]
    out_path = os.path.join(tmp, "best.msgpack")
    rc, out, err, rec["command_s"], rec["command_rss"] = _run_child(
        [sys.executable, "-m", CONVERT19_MODULE, "--bin", bin_path, "--out", out_path],
        CONVERT19_TIMEOUT)
    rec["command_out"] = out.strip()
    if rc != 0 or rec["command_out"] != f"wrote {out_path} (0 missing, 0 unmapped)":
        raise SmokeError(f"convert (a): the command exited {rc}: {out[-2000:]} {err[-2000:]}")
    rec["msgpack_bytes"] = os.path.getsize(out_path)

    # its stages in this process, each timed
    t0 = time.perf_counter()
    sd = conv.load_reference(bin_path)
    rec["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree, missing, unmapped = conv.convert(sd, conv.comet_template(cfg), cfg)
    rec["convert_s"] = time.perf_counter() - t0
    del sd
    again = os.path.join(tmp, "again.msgpack")
    t0 = time.perf_counter()
    serialization.save_params_msgpack(again, tree)
    rec["write_s"] = time.perf_counter() - t0
    rec["same_file"] = filecmp.cmp(out_path, again, shallow=False)
    os.remove(again)
    t0 = time.perf_counter()
    from_file = serialization.load_params_msgpack(out_path, cfg)
    rec["read_s"] = time.perf_counter() - t0
    in_memory = params_from_jax(tree, cfg)
    del tree
    rec["bitwise"] = set(from_file) == set(in_memory) and all(
        from_file[k].dtype == v.dtype and torch.equal(from_file[k], v)
        for k, v in in_memory.items())
    del in_memory

    # `--checkpoint`'s path onto the card, and the same weights on the CPU
    t0 = time.perf_counter()
    card = cli._init_model(cfg, 0, out_path, inference=False, device=dev)
    torch.cuda.synchronize()
    rec["card_load_s"] = time.perf_counter() - t0
    rec["card_bitwise"] = all(torch.equal(v.cpu(), from_file[k])
                              for k, v in card.state_dict().items())
    cpu_model.load_state_dict(from_file)
    cpu_bf16 = models.build_comet(cfg, device="cpu", seed=0)
    cpu_bf16.load_state_dict(from_file)
    del from_file
    images, queries = _request(torch, cfg, 100, dev)
    beside()
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = {k: v.float() for k, v in cpu_model(images.cpu(), queries.cpu()).items()}
    rec["cpu_f32_s"] = time.perf_counter() - t0
    # PyTorch's own bf16 of the outputs in CONVERT19_KNOWN_MISS: the
    # trackers' part of the forward (``COMET._track``), without the camera's
    t0 = time.perf_counter()
    tracked = {}
    with torch.inference_mode():
        cpu_bf16._track(images.cpu(), queries.cpu(), tracked)
    rec["cpu_bf16_s"] = time.perf_counter() - t0
    del cpu_model, cpu_bf16
    rec["routes"] = {}
    for route_name, route in (("default", tcfg.KernelRoute()), ("fused", tcfg.FUSED_ROUTE)):
        card.set_route(route)
        _reset(counters)
        with torch.inference_mode():
            got = card(images, queries)
        torch.cuda.synchronize()
        gaps = {}
        for key in CONVERT19_OUTPUTS:
            g, w = got[key].float().cpu(), want[key]
            gaps[key] = dict(err=(g - w).abs().max().item(), scale=w.abs().max().item(),
                             finite=bool(torch.isfinite(g).all()))
            if key in CONVERT19_KNOWN_MISS:
                w16 = tracked[key].float()
                gaps[key].update(err_bf16=(g - w16).abs().max().item(),
                                 cpu_bf16_err=(w16 - w).abs().max().item())
        rec["routes"][route_name] = dict(launches=_launches(counters), gaps=gaps)
    del card
    torch.cuda.empty_cache()
    return rec


def convert19b():
    """Phase 19 (b): ``--self-test`` in a child process; returns its record."""
    rc, out, err, seconds, rss = _run_child(
        [sys.executable, "-m", CONVERT19_MODULE, "--self-test"], CONVERT19_TIMEOUT)
    lines = [ln for ln in out.splitlines() if ln.startswith("self-test[")]
    return dict(rc=rc, lines=lines, seconds=seconds, rss=rss, err=err[-2000:])


def _widest_gap(np, logits):
    """The middle of the widest gap between two sorted logits within the
    CONVERT19_SPLIT quantiles, and the gap."""
    v = np.sort(logits)
    lo, hi = (int(q * (len(v) - 1)) for q in CONVERT19_SPLIT)
    i = lo + int(np.argmax(np.diff(v[lo:hi + 1])))
    return float(v[i] + v[i + 1]) / 2, float(v[i + 1] - v[i])


def _pruning_biases(torch, np, m, args, valid):
    """Token-confidence and matchability biases of ``m`` (in place) that make
    it prune after layer 0 and stop after layer CONVERT19_STOP on these
    inputs; returns the layer-0 gaps."""
    k0, d0, k1, d1 = args
    v0, v1 = valid["valid0"], valid["valid1"]
    with torch.no_grad():
        d0, d1 = m.transformers[0](m.input_proj(d0), m.input_proj(d1), m.posenc(k0),
                                   m.posenc(k1), v0, v1)
        gaps = {}
        for name, lin, thr in (
                ("confidence", m.token_confidence[0].token,
                 math.log(0.9 / 0.1)),  # confidence_threshold(0, depth) = 0.9
                ("matchability", m.log_assignment[0].matchability,
                 math.log(0.01 / 0.99))):  # 1 - MATCH_ADAPTIVE's width confidence
            logits = torch.cat([lin(d0)[:, 0][v0], lin(d1)[:, 0][v1]]).numpy()
            mid, gaps[name] = _widest_gap(np, logits)
            lin.bias.add_(thr - mid)
        for i in range(1, CONVERT19_STOP + 1):
            m.token_confidence[i].token.bias.fill_(
                CONVERT19_FAR if i == CONVERT19_STOP else -CONVERT19_FAR)
    return gaps


def convert19c(torch, np, dev):
    """Phase 19 (c): returns its records."""
    import copy
    import re

    from comet_tpu_torch.matching import benchmarks, lightglue
    from comet_tpu_torch.matching.extractors import build_superpoint
    from comet_tpu_torch.models.blocks import init_params
    from comet_tpu_torch.models.superpoint import SuperPointBackbone
    from comet_tpu_torch.utils import convert_torch_weights as conv
    from comet_tpu_torch.weights import module_params_from_jax, module_params_to_jax

    records = []

    def record(name, ok, **fields):
        records.append(dict(name=name, ok=ok, **fields))
        print(f"convert (c): {name}: {json.dumps(fields)}{'' if ok else ' FAILED'}", flush=True)

    # SuperPoint: superpoint_v1.pth's layout (OIHW, no prefix) of seed 0's weights
    flat = conv.flatten_params(module_params_to_jax(
        build_superpoint(MATCH_KP, seed=0).backbone)["params"])
    sp_sd = {}
    for name in conv.SUPERPOINT_LAYERS:
        sp_sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(flat[f"{name}/kernel"].transpose(3, 2, 0, 1)))
        sp_sd[f"{name}.bias"] = torch.from_numpy(flat[f"{name}/bias"])
    sp = build_superpoint(MATCH_KP, seed=1)
    sp.backbone.load_state_dict(module_params_from_jax(
        conv.convert_superpoint(sp_sd, module_params_to_jax(SuperPointBackbone())), sp.backbone))
    sp_card = copy.deepcopy(sp).to(dev)
    img0, img1, _ = benchmarks.make_synthetic_pairs(1, (MATCH_IMG, MATCH_IMG), seed=0,
                                                    device=torch.device("cpu"))[0]
    feats = {}
    with torch.no_grad():
        for side, img in (("0", img0), ("1", img1)):
            want, got = sp(img[..., 0]), sp_card(img[..., 0].to(dev))
            feats[side] = want
            wk, ws = want.keypoints.numpy(), want.scores.numpy()
            gk, gs = got.keypoints.cpu().numpy(), got.scores.cpu().numpy()
            diff, near, order = _keypoint_diffs(np, gk, gs, wk, ws, 2 * sp.nms_radius + 1)
            same = (gk == wk).all(axis=1)
            err_sc = _rel_err(np, gs, ws) if order == 0 else _rel_err(np, np.sort(gs), np.sort(ws))
            err_d = _rel_err(np, got.descriptors.cpu().numpy()[same],
                             want.descriptors.numpy()[same])
            record(f"converted SuperPoint, image {side}", diff == near and err_sc <= MATCH_TOL
                   and err_d <= MATCH_TOL, keypoints=MATCH_KP, zero_score=int((ws == 0).sum()),
                   disagreements=diff, near_ties=near, slots_reordered=int(order),
                   score_err=err_sc, descriptor_err=err_d, tol=MATCH_TOL)

    def norm(k):
        return k / (MATCH_IMG - 1.0) * 2.0 - 1.0

    args = (norm(feats["0"].keypoints), feats["0"].descriptors,
            norm(feats["1"].keypoints), feats["1"].descriptors)
    valid = dict(valid0=feats["0"].scores > 0, valid1=feats["1"].scores > 0)
    # LightGlue: the release's layout of seed 0's weights with the Identity
    # input_proj and pruning biases
    conf = dict(depth=9, dim=256, num_heads=4, filter_threshold=0.0,
                depth_confidence=MATCH_ADAPTIVE[0], width_confidence=MATCH_ADAPTIVE[1])
    src = lightglue.LightGlueMatcher(**conf)
    init_params(src, torch.Generator().manual_seed(0))
    with torch.no_grad():
        src.input_proj.weight.copy_(torch.eye(conf["dim"]))
        src.input_proj.bias.zero_()
    gaps = _pruning_biases(torch, np, src, args, valid)
    mapping = conv.build_lightglue_mapping(conf["depth"])
    lg_sd = {}
    for path, value in conv.flatten_params(module_params_to_jax(src)["params"]).items():
        if path.startswith("input_proj/"):
            continue
        key, tf = mapping[path]
        key = re.sub(r"^transformers\.(\d+)\.(self_attn|cross_attn)\.", r"\2.\1.", key)
        lg_sd[key] = torch.from_numpy(np.ascontiguousarray(value.T if tf is conv.t_linear
                                                           else value))
    m = lightglue.LightGlueMatcher(**conf)
    init_params(m, torch.Generator().manual_seed(1))
    tree, missing, unmapped = conv.convert_lightglue(lg_sd, module_params_to_jax(m),
                                                     depth=conf["depth"])
    m.load_state_dict(module_params_from_jax(tree, m))
    m.eval()
    same_weights = all(torch.equal(v, src.state_dict()[k]) for k, v in m.state_dict().items())
    with torch.no_grad():
        want = m(*args, **valid)
        got = copy.deepcopy(m).to(dev)(*(a.to(dev) for a in args),
                                       **{k: v.to(dev) for k, v in valid.items()})
    got = {k: v.cpu() for k, v in got.items()}
    la_w, la_g = want["log_assignment"].numpy(), got["log_assignment"].numpy()
    diff, near = _match_diffs(np, got["matches0"].numpy(), want["matches0"].numpy(),
                              la_g[:-1, :-1], la_w[:-1, :-1])
    rows, rows_near = _argmax_diffs(np, la_g[:-1, :-1], la_w[:-1, :-1])
    same_adapt = all(torch.equal(got[k], want[k]) for k in ("stop_layer", "prune0", "prune1"))
    stop = int(want["stop_layer"])
    pruned = [int((want[f"prune{i}"] < stop).sum()) for i in (0, 1)]
    err = _rel_err(np, la_g, la_w)
    record("converted LightGlue depth 9, adaptive", diff == near and rows == rows_near
           and same_adapt and err <= MATCH_TOL and sum(pruned) > 0 and stop < conf["depth"]
           and not missing and not unmapped and same_weights,
           release_keys=len(lg_sd), missing=len(missing), unmapped=len(unmapped),
           weights_equal_source=same_weights, layer0_gaps=gaps,
           matches=int((want["matches0"] >= 0).sum()), disagreements=diff, near_ties=near,
           row_argmax_disagreements=rows, row_argmax_near_ties=rows_near, stop_layer=stop,
           pruned0=pruned[0], pruned1=pruned[1], adaptive_equal=same_adapt,
           log_assignment_err=err, tol=MATCH_TOL)
    return records


def convert_phase(torch, np, tcfg, models, serialization, cfg, counters, dev, smi):
    """Phase 19: (a) ``convert19a``, (b) ``convert19b``, (c) ``convert19c``,
    TF32 off for (c)'s comparisons; each part runs and prints before the
    phase fails on a check (a failed conversion command fails it at once).
    Returns the records and the phase's seconds."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    if torch.backends.cuda.matmul.allow_tf32:
        raise SmokeError("phase 19: TF32 matmuls are on; the comparisons run in f32")
    t_phase = time.perf_counter()
    failures, self_test = [], []
    with ThreadPoolExecutor(1) as pool, tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        # (b)'s child runs beside (a)'s forwards on the CPU
        a = convert19a(torch, np, tcfg, models, serialization, cfg, counters, dev, tmp,
                       lambda: self_test.append(pool.submit(convert19b)))
        a["seconds"] = time.perf_counter() - t0
        b = self_test[0].result()
    print(f"convert (a): a full-width 'ours' reference checkpoint of {a['parameters']} "
          f"parameters, {a['bin_bytes']} bytes, made in {a['make_s']:.1f} s; the command "
          f"'{a['command_out']}' in {a['command_s']:.1f} s, its peak RSS "
          f"{_gib(_in_gib(a['command_rss']))} (importing the module alone "
          f"{_gib(_in_gib(a['import_rss']))}); {a['msgpack_bytes']} bytes; in this process "
          f"torch.load {a['load_s']:.1f} s, convert {a['convert_s']:.1f} s, write "
          f"{a['write_s']:.1f} s (the same bytes as the command's: {a['same_file']}), read "
          f"{a['read_s']:.1f} s (the in-memory conversion bit for bit: {a['bitwise']}); onto "
          f"the card by --checkpoint's "
          f"path in {a['card_load_s']:.1f} s (bit for bit: {a['card_bitwise']}); the CPU's "
          f"forward in f32 {a['cpu_f32_s']:.1f} s, its trackers in bf16 {a['cpu_bf16_s']:.1f} s; "
          f"on {smi}", flush=True)
    if not (a["same_file"] and a["bitwise"] and a["card_bitwise"]):
        failures.append("(a) the file, its read or the card's weights differ from the "
                        "in-memory conversion")
    for route_name, r in a["routes"].items():
        ok, held = r["launches"] == PER_FORWARD[route_name], {}
        for key, g in r["gaps"].items():
            limit = REF_RTOL * g["scale"]
            ok &= g["finite"]
            if g["err"] <= limit:
                continue
            if key not in CONVERT19_KNOWN_MISS or g["cpu_bf16_err"] <= limit:
                ok = False
                continue
            held[key] = dict(card_to_cpu_bf16=g["err_bf16"] / g["scale"],
                             cpu_bf16_to_f32=g["cpu_bf16_err"] / g["scale"])
            ok &= g["err_bf16"] <= limit

        def ratios(field):
            return json.dumps({k: float(f"{g[field] / max(g['scale'], 1e-12):.3e}")
                               for k, g in r["gaps"].items() if field in g})
        print(f"convert (a), {route_name} route: launches {r['launches']} (phase 5's "
              f"{PER_FORWARD[route_name]}); max |card bf16 - CPU f32| / max |CPU f32| "
              f"{ratios('err')} (limit {REF_RTOL}); max |CPU bf16 - CPU f32| / max |CPU f32| "
              f"{ratios('cpu_bf16_err')}; missed and held to the CPU's bf16 trackers "
              f"{json.dumps(held)}{'' if ok else ' FAILED'}", flush=True)
        if not ok:
            failures.append(f"(a) {route_name} route")
    print(f"convert (b): --self-test (beside (a)'s CPU forwards) exited {b['rc']} in "
          f"{b['seconds']:.1f} s, peak RSS {_gib(_in_gib(b['rss']))}: {' | '.join(b['lines'])}",
          flush=True)
    want_lines = [f"self-test[{p}]" for p in ("ours", "abl_all", "abl_track", "abl_time",
                                              "abl_uvz")]
    if b["rc"] != 0 or [ln.split(":")[0] for ln in b["lines"]] != want_lines or not all(
            ln.endswith(" 0 missing, 0 unmapped") for ln in b["lines"]):
        failures.append(f"(b) the self-test: {b['lines']} {b['err']}")
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        c = convert19c(torch, np, dev)
        c_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    failures += [f"(c) {r['name']}" for r in c if not r["ok"]]
    seconds = time.perf_counter() - t_phase
    print(f"phase 19: {seconds:.1f} s ((a) {a['seconds']:.1f} with (b) beside it, (c) "
          f"{c_s:.1f}), on {smi}", flush=True)
    if failures:
        raise SmokeError(f"phase 19: {'; '.join(failures)}")
    return dict(seconds=seconds, a=a, b=b, c=c)


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
        serve = serving_phase(torch, tcfg, windowed, serialization, serving, kernels, cfg, model,
                              counters, dev, smi)
        distributed = distributed_phase(torch, np, data, geom, tcfg, models, training, parallel,
                                        cfg, model, counters, dev, smi)
        loads = load_phase(torch, np, data, cfg, counters, dev, smi)
        _reset(counters)
        scene = scene_phase(torch, np, dev, smi)
        if sum(_launches(counters).values()):
            raise SmokeError(f"scene: kernels launched {_launches(counters)}; the geometry has none")
        matching = match_phase(torch, np, counters, dev, smi)
        phase16 = train_extract_phase(torch, np, F, attn, counters, dev, smi)
        phase17 = lines_pipelines_phase(torch, np, counters, dev, smi)
        phase18 = resume_phase(torch, np, tcfg, geom, models, training, serialization, attn, cfg,
                               model, counters, checked["K1"], distributed, dev, smi)
        phase19 = convert_phase(torch, np, tcfg, models, serialization, cfg, counters, dev, smi)
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
    for r in phase16["k1_rows"]:
        # launches: K1 at this shape in phase 16 (c)'s backbone calls
        record.append(dict(
            name=f"K1 {r['where']} {r['shape']}", route="cuda", source="comet_tpu_torch/csrc/attn.cu",
            replaces="comet_tpu/ops/pallas_attn.py:106",
            launches=phase16["k1_shapes"].get(tuple(r["shape"]), 0), max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], host_us=r["host_us"],
            library_host_us=r["library_host_us"], tolerance=r["tolerance"],
            inference_host_us=r["inference_host_us"], launch_host_us=r["launch_host_us"],
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
    for route_name, t in distributed["tp_train"].items():
        print(f"tensor-parallel training, {route_name} route (model axis 2, gloo on one card): "
              f"steps {['%.1f' % x for x in t['ms']]} ms, parameter bytes per rank "
              f"{t['param_bytes']}, optimizer-state bytes per rank {t['state_bytes']}", flush=True)
    print(f"load: native library {'built' if loads['native'] else 'NOT built'} in "
          f"{loads['build_s']:.1f} s; ms per sequence: PIL {loads['pil_ms']:.1f} (decode "
          f"{loads['pil_raw_ms']:.1f}), native "
          + (f"{loads['native_ms']:.1f} (decode {loads['native_raw_ms']:.1f})" if loads["native"]
             else "not run (no build)") + f"; phase 13 {loads['seconds']:.1f} s", flush=True)
    whole = {s["stage"]: s for s in scene["stages"]}
    print(f"scene: phase 14 {scene['seconds']:.1f} s; reconstruct_scene at S {SCENE_S}, N "
          f"{SCENE_N}: card {whole['whole']['card_ms']:.1f} ms ({whole['whole, alone']['card_ms']:.1f} "
          f"alone, {whole['whole, alone']['syncs']} host syncs), CPU {whole['whole']['cpu_ms']:.1f} "
          f"ms; gates {json.dumps({k: round(v[0], 5) for k, v in scene['gates'].items()})}",
          flush=True)
    lines = "; ".join(
        f"{name} card {t['card']['extractor_ms']:.1f} + {t['card']['matcher_ms']:.1f} ms, CPU "
        f"{t['cpu']['extractor_ms']:.1f} + {t['cpu']['matcher_ms']:.1f} ms"
        for name, t in matching["timing"].items())
    print(f"matching: phase 15 {matching['seconds']:.1f} s; per pair at {MATCH_IMG} px, "
          f"extractor + matcher: {lines}", flush=True)
    trained = "; ".join(
        f"{name} step {t['step_ms_median']:.1f} ms (idle {t['profile']['idle']:.2f}), loss "
        f"{t['row']['loss_first']} -> {t['row']['loss_last']}, {t['syncs_per_step']:.2f} syncs per "
        f"step, peak {t['peak_gib']:.2f} GiB" for name, t in phase16["training"].items())
    extracted = "; ".join(
        f"{name} card {statistics.median(r['card_ms']):.1f} ms, CPU "
        f"{statistics.median(r['cpu_ms']):.1f} ms" for name, r in
        phase16["extracted"]["extractors"].items())
    backbone = "; ".join(f"{r['tokens']} tokens {statistics.median(r['ms']):.2f} ms, K1 "
                         f"{r['launches']['K1'] // BACKBONE16_CALLS} per call"
                         for r in phase16["backbone"])
    print(f"phase 16: {phase16['seconds']:.1f} s; training (batch {TRAIN16_BATCH}, {MATCH_IMG} px, "
          f"512 keypoints): {trained}; per image at {MATCH_IMG} px: {extracted}; "
          f"backbone_dinov2: {backbone}", flush=True)
    lined = "; ".join(f"{r['name']} extractor {r['extractor_ms']:.1f} ms (detector "
                      f"{r['detector_ms']:.1f}) + matcher {r['matcher_ms']:.1f} ms, "
                      f"{r['syncs_per_pair']} syncs, peak {_gib(r['peak_gib'])}"
                      for r in phase17["lines"])
    piped = "; ".join(f"{r['name']} card {r['card_s']:.1f} s, CPU {r['cpu_s']:.1f} s"
                      for r in phase17["pipelines"] if "card_s" in r)
    print(f"phase 17: {phase17['seconds']:.1f} s; per pair at {MATCH_IMG} px: {lined}; depth GT "
          + "; ".join(f"{k} card {v['card_ms']:.2f} ms, CPU {v['cpu_ms']:.2f} ms"
                      for k, v in phase17["depth"].items())
          + f"; pipelines (h5py {phase17['h5py']}): {piped or 'file round trip not run'}",
          flush=True)
    a, c = phase18["resumed"], phase18["helpers"]
    print(f"phase 18: {phase18['seconds']:.1f} s; the JAX layout's checkpoint {a['bytes']} bytes, "
          f"written {a['write_s']:.1f} s, restored {a['read_s']:.1f} s, the restored step's loss "
          f"|diff| {a['loss_gap']:.3e} (spread {a['loss_spread']:.3e}); TP checkpoint "
          f"{phase18['tp'][0]['bytes']} bytes, saved {phase18['tp'][0]['save_s']:.1f} s; "
          f"benchmark_model K1 {c['bench']['mean']:.4f} ms against {c['event_ms']:.4f} ms between "
          f"events", flush=True)
    a = phase19["a"]
    print(f"phase 19: {phase19['seconds']:.1f} s; the reference checkpoint {a['bin_bytes']} bytes "
          f"-> {a['msgpack_bytes']} bytes of msgpack: the command {a['command_s']:.1f} s (peak "
          f"RSS {_gib(_in_gib(a['command_rss']))}, its import alone "
          f"{_gib(_in_gib(a['import_rss']))}), torch.load {a['load_s']:.1f} s, convert "
          f"{a['convert_s']:.1f} s, write {a['write_s']:.1f} s, read {a['read_s']:.1f} s; "
          f"--self-test {phase19['b']['seconds']:.1f} s; the converted LightGlue stops at layer "
          f"{phase19['c'][-1]['stop_layer']} with {phase19['c'][-1]['pruned0']} + "
          f"{phase19['c'][-1]['pruned1']} points pruned", flush=True)
    print(f"chip_smoke: total {time.perf_counter() - started:.1f} s after the imports", flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
