"""GPU smoke check of the PyTorch/CUDA port (``comet_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py                         # the check, about a minute
    python3 chip_smoke.py --profile profile.txt   # + a torch.profiler table

Phases, each of which makes the script exit nonzero when it fails:

1. the card: its name, and its name and power limit from ``nvidia-smi``;
2. the build of the hand-written kernels (K1 ``csrc/attn.cu``, K2
   ``csrc/block.cu``) with ``nvcc`` for sm_90a, timed;
3. every kernel at every shape the main path gives it, in bf16: the kernel
   against its plain PyTorch version run in f32 on the same bf16 inputs,
   with the kernel's, the plain version's (bf16, on the card) and, for K1,
   ``F.scaled_dot_product_attention``'s median times over 25 runs;
4. a reference check on small inputs: the full-width ``ours`` model's coarse
   and fine update-formers and its camera predictor, on the card in bf16
   (through the kernels) against the same weights in f32 on the CPU (plain
   versions);
5. the main path: ``build_comet(get_config("ours"))`` on the card at full
   width (16 frames, 512 px, 512 tracks, bf16, random weights from seed 0)
   answers 3 seeded requests through ``COMET.forward`` and
   ``decode_predictions``; the kernels' launch counts are set to 0 just
   before and read just after, and must rise by the per-forward counts.

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

# peaks of one H100 SXM (data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# K1 at the main path's shapes: (where, B, Lq, Lk, C, heads, packed qkv, calls per forward)
K1_SHAPES = [
    ("vit self", 16, 581, 581, 768, 12, True, 12),
    ("aggregator self", 16, 577, 577, 768, 8, True, 4),
    ("aggregator cross to frame 0", 1, 8655, 577, 768, 8, False, 4),
    ("update-former virtual<-point", 16, 64, 512, 384, 8, False, 24),
    ("trajectory cross", 16, 1, 512, 768, 8, False, 4),
    ("trunk self", 1, 16, 16, 768, 8, True, 4),
    ("update-former point<-virtual", 16, 512, 64, 384, 8, False, 24),
]
# K2: (where, B, L, C, heads, hidden, calls per forward)
K2_SHAPES = [
    ("coarse time blocks", 576, 16, 384, 8, 1536, 24),
    ("coarse virtual blocks", 16, 64, 384, 8, 1536, 24),
    ("fine time blocks", 512, 16, 256, 8, 1024, 24),
]
K1_PER_FORWARD = sum(s[-1] for s in K1_SHAPES)  # 76
K2_PER_FORWARD = sum(s[-1] for s in K2_SHAPES)  # 72
K1_ATOL = 3e-2
# K2's output and its residual stream are each rounded to bf16 at their own
# magnitude (|y| reaches ~8, where one bf16 step is 0.0625): atol plus two
# bf16 steps relative to the value.
K2_ATOL, K2_RTOL = 3e-2, 2.0 ** -6
# bf16 on the card against f32 on the CPU, relative to the output's range:
# a stack of 12 bf16 blocks drifts by ~1 % of it (0.9 % for PyTorch's own
# bf16 of the same stack on the CPU), a wrong kernel by its whole size.
REF_RTOL = 3e-2
TIMING_RUNS = 25
REQUESTS = 3


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
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_k1(torch, F, attn, dev, gen):
    rows = []
    for where, b, lq, lk, c, h, packed, calls in K1_SHAPES:
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
        plain_ms = _median_ms(torch, lambda: attn.attention_reference(q, k, v, h, d ** -0.5))
        q4, k4, v4 = (t.view(b, t.shape[1], h, d).transpose(1, 2) for t in (q, k, v))
        library_ms = _median_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4))
        flops = 4 * b * h * lq * lk * d
        nbytes = 2 * (2 * b * lq * c + 2 * b * lk * c)  # q, k, v read once, out written once
        bound, bound_by = _bound_ms(flops, nbytes)
        rows.append(dict(kernel="K1", where=where, shape=[b, lq, lk, c, h], calls=calls,
                         max_abs_err=err, tolerance=f"atol {K1_ATOL}", ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound, bound_by=bound_by,
                         flops=flops, bytes=nbytes))
        print(f"K1 {where:32s} [B={b} Lq={lq} Lk={lk} C={c} H={h}] err {err:.3e} (atol {K1_ATOL}) "
              f"ms {ms:.4f} plain {plain_ms:.4f} sdpa {library_ms:.4f} bound {bound:.5f} ({bound_by})",
              flush=True)
    return rows


def check_k2(torch, block, dev, gen):
    rows = []
    for where, b, l, c, h, hid, calls in K2_SHAPES:
        def rnd(*shape, std=1.0):
            return (torch.randn(*shape, generator=gen, device=dev) * std).bfloat16()

        # lecun-normal-scale weights ([out, in]) and small biases
        w = [rnd(3 * c, c, std=c ** -0.5), rnd(3 * c, std=0.02), rnd(c, c, std=c ** -0.5),
             rnd(c, std=0.02), rnd(hid, c, std=c ** -0.5), rnd(hid, std=0.02),
             rnd(c, hid, std=hid ** -0.5), rnd(c, std=0.02)]
        x = rnd(b, l, c)
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
        plain_ms = _median_ms(torch, lambda: block.block_reference(x, *w, h))
        rows_ = b * l
        flops = rows_ * 2 * c * (3 * c + c + 2 * hid) + 4 * rows_ * l * c
        nbytes = 2 * (2 * rows_ * c + 4 * c * c + 2 * c * hid + 4 * c + hid + c)
        bound, bound_by = _bound_ms(flops, nbytes)
        rows.append(dict(kernel="K2", where=where, shape=[b, l, c, h, hid], calls=calls,
                         max_abs_err=err, tolerance=f"atol {K2_ATOL} + {K2_RTOL} |y|",
                         ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                         bound_by=bound_by, flops=flops, bytes=nbytes))
        print(f"K2 {where:32s} [B={b} L={l} C={c} H={h} hidden={hid}] err {err:.3e} "
              f"(plain bf16 {plain_err:.3e}; atol {K2_ATOL} + {K2_RTOL:.4f}|y|, excess {excess:.3e}) "
              f"ms {ms:.4f} plain {plain_ms:.4f} bound {bound:.5f} ({bound_by})", flush=True)
    return rows


def _request(torch, cfg, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    s, hw, n = cfg.seqlen, cfg.img_size, cfg.track_num
    images = torch.randn(1, s, hw, hw, 3, generator=gen, device=dev)
    queries = torch.rand(1, n, 2, generator=gen, device=dev) * (hw - 20) + 10
    return images, queries


def reference_check(torch, tcfg, models, model, dev):
    """The main path's modules at full width on small inputs: on the card in
    bf16 (through the kernels) against the same weights in f32 on the CPU
    (plain versions), within REF_RTOL of the reference's largest value."""
    cpu = models.build_comet(tcfg.get_config("ours").replace(compute_dtype="float32"),
                             device="cpu", seed=0)
    gen = torch.Generator().manual_seed(11)
    coarse_in = model.coarse_tracker.updateformer.input_transform.in_features
    fine_in = model.fine_tracker.updateformer.input_transform.in_features
    cases = [
        # coarse update-former: K2 at L 16 (time) and 64 (virtual), K1 both ways
        ("coarse update-former [1, 32 tracks, 16 frames]", "coarse_tracker.updateformer",
         (torch.randn(1, 32, 16, coarse_in, generator=gen),)),
        # fine update-former: K2 at C 256
        ("fine update-former [32 tracks, 1, 16 frames]", "fine_tracker.updateformer",
         (torch.randn(32, 1, 16, fine_in, generator=gen),)),
        # camera predictor: K1 in the ViT, the aggregator, T_P and the trunk
        ("camera predictor [1, 2 frames, 64 px, 32 tracks]", "camera_predictor",
         (torch.randn(1, 2, 64, 64, 3, generator=gen), torch.rand(1, 2, 32, 2, generator=gen) * 64,
          torch.rand(1, 2, 32, generator=gen))),
    ]
    worst = {}
    for where, path, args in cases:
        with torch.inference_mode():
            got = model.get_submodule(path)(*(a.to(dev) for a in args))
            want = cpu.get_submodule(path)(*args)
        if path == "camera_predictor":
            got, want = got.pred_pose_enc, want.pred_pose_enc
        got = got.float().cpu()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        worst[where] = err / scale
        print(f"reference check {where}: max |card bf16 - CPU f32| = {err:.3e}, "
              f"max |reference| = {scale:.3f}, ratio {err / scale:.2e} (limit {REF_RTOL})",
              flush=True)
        if not torch.isfinite(got).all() or not err <= REF_RTOL * scale:
            raise SmokeError(f"reference check {where}: max |diff| {err} > {REF_RTOL} * {scale}")
    return worst


def main_path(torch, cfg, model, models, geom, attn, block, dev, n_requests, card):
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

    torch.cuda.reset_peak_memory_stats()
    times = []
    attn.fused_attention.launches = 0
    block.fused_attn_block.launches = 0
    attn.fused_attention.launch_shapes.clear()
    block.fused_attn_block.launch_shapes.clear()
    for i, (images, queries) in enumerate(requests):
        k1_0, k2_0 = attn.fused_attention.launches, block.fused_attn_block.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(images, queries)
            q_abs, t_abs = models.decode_predictions(cfg, out["pred_pose_enc"][0], cams)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches = (attn.fused_attention.launches - k1_0, block.fused_attn_block.launches - k2_0)
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
        if launches != (K1_PER_FORWARD, K2_PER_FORWARD):
            raise SmokeError(f"request {i}: kernel launches {launches}, want "
                             f"{(K1_PER_FORWARD, K2_PER_FORWARD)}")
        print(f"request {i}: forward + decode {times[-1]:.1f} ms, launches K1 {launches[0]} "
              f"K2 {launches[1]}, outputs finite, frame 0 pinned", flush=True)
    total = (attn.fused_attention.launches, block.fused_attn_block.launches)
    shapes = dict(attn.fused_attention.launch_shapes)
    shapes.update(block.fused_attn_block.launch_shapes)
    want = {tuple(r[1:6]): n_requests * r[-1] for r in K1_SHAPES}
    want.update({tuple(r[1:6]): n_requests * r[-1] for r in K2_SHAPES})
    if shapes != want:
        raise SmokeError(f"main path launched the kernels at {shapes}, want {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(times[1:]) if len(times) > 1 else times[0]
    print(f"main path: {n_requests} requests, forward ms {['%.1f' % t for t in times]}, "
          f"median of requests 2-{n_requests} {med:.1f} ms = {1e3 / med:.2f} sequences/s, "
          f"peak memory {peak:.2f} GiB, on {card}", flush=True)
    return dict(total=total, shapes=shapes, times=times, requests=requests)


def profile(torch, model, images, queries, path):
    """torch.profiler over one warm forward: device time by operator."""
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
    k1_us = sum(e.self_device_time_total for e in kernels if "attn_fwd_kernel" in e.key)
    k2_us = sum(e.self_device_time_total for e in kernels if "attn_block_kernel" in e.key)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    print(f"profile: one forward, {wall:.1f} ms on the host clock (profiler on), "
          f"{device_us / 1e3:.1f} ms of device time in {sum(e.count for e in kernels)} kernel "
          f"launches, of which K1 {k1_us / 1e3:.2f} ms and K2 {k2_us / 1e3:.2f} ms; "
          f"table in {path}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="PATH", help="write a torch.profiler table of one forward")
    parser.add_argument("--requests", type=int, default=REQUESTS,
                        help=f"requests the main path answers (default {REQUESTS})")
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
        from comet_tpu_torch.ops import attn, block, kernels
    except ImportError as exc:
        print(f"chip_smoke: the comet_tpu_torch package is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "comet_tpu")]:
        print(f"chip_smoke: {name} was imported", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
          f"nvidia-smi: {smi}", flush=True)
    try:
        t0 = time.perf_counter()
        kernels.library()
        print(f"kernel build: {time.perf_counter() - t0:.1f} s "
              f"(nvcc {' '.join(kernels.NVCC_FLAGS[:2])}, {', '.join(kernels.SOURCES)})", flush=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        k1 = check_k1(torch, F, attn, dev, gen)
        k2 = check_k2(torch, block, dev, gen)
        cfg = tcfg.get_config("ours")
        t0 = time.perf_counter()
        model = models.build_comet(cfg, device=dev, seed=0)
        torch.cuda.synchronize()
        print(f"build_comet('ours') on {dev} in {time.perf_counter() - t0:.1f} s, "
              f"{sum(p.numel() for p in model.parameters())} parameters", flush=True)
        reference_check(torch, tcfg, models, model, dev)
        run = main_path(torch, cfg, model, models, geom, attn, block, dev, args.requests, smi)
        if args.profile:
            profile(torch, model, *run["requests"][0], args.profile)
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    k1_total, k2_total = run["total"]
    if k1_total == 0 or k2_total == 0:
        print("chip_smoke: FAILED: a kernel of the main path never launched", file=sys.stderr)
        return 1
    record = []
    for kernel, rows, source, replaces in (
        ("K1", k1, "comet_tpu_torch/csrc/attn.cu",
         "comet_tpu/ops/pallas_attn.py:106"),
        ("K2", k2, "comet_tpu_torch/csrc/block.cu",
         "comet_tpu/ops/pallas_block.py:150"),
    ):
        for r in rows:
            # launches: this kernel at this shape in the main path's run
            record.append(dict(
                name=f"{kernel} {r['where']} {r['shape']}", route="cuda", source=source,
                replaces=replaces, launches=run["shapes"][tuple(r["shape"])],
                max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
                tolerance=r["tolerance"],
            ))
    print(f"main path launches over {args.requests} requests: K1 {k1_total} ({K1_PER_FORWARD}/forward), "
          f"K2 {k2_total} ({K2_PER_FORWARD}/forward)", flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
