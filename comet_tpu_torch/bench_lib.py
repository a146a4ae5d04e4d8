"""Throughput benchmarks: end-to-end COMET inference, the train step, eval
with data, and K1's softmax forms.

Counterpart of ``comet_tpu/bench_lib.py`` (``run_benchmark``,
``run_train_benchmark``, ``run_eval_data_benchmark``) and of
``tools/micro_softmax_variants.py`` (``run_softmax_variants``).
Every function runs on the card unless ``device="cpu"`` is passed, and then
it times the host: its numbers are no device metric.

Baseline to beat: the PyTorch reference runs 41.53 FPS at seqlen=16 on an
RTX 4090 (README.md:211) = ~2.6 sequences/sec.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .config import CometConfig, KernelRoute, get_config
from .device import resolve_device
from .models import build_comet

REFERENCE_SEQ_PER_SEC = 41.53 / 16.0  # RTX 4090 baseline at seqlen=16

# the TPU tool's shapes: (name, B, Lq, Lk, C, heads)
SOFTMAX_SHAPES = (
    ("vit self", 16, 581, 581, 768, 12),
    ("agg self", 16, 578, 578, 768, 8),
)
# the tool's forms; base and exp2 are both K1's function (K1 computes its
# exponent as exp2 with log2 e folded into the scale)
SOFTMAX_FORMS = ("base", "nomax", "exp2", "bf16e")


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device}: {torch.cuda.get_device_name(device)}"
    return str(device)


class _Timer:
    """Host time, and on the card the device time between two CUDA events,
    of one batch of work ending in a synchronize."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize()
            self.start, self.end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            self.start.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
            torch.cuda.synchronize()
            self.device_s = self.start.elapsed_time(self.end) / 1e3
        else:
            self.device_s = None
        self.host_s = time.perf_counter() - self.t0


def run_benchmark(
    cfg: Optional[CometConfig] = None, warmup: int = 2, reps: int = 16, seed: int = 0,
    route: KernelRoute = KernelRoute(), device=None,
) -> Dict:
    """Forward throughput of the full model at batch 1, sequences/s.

    The model's parameters are cast to ``cfg.dtype`` once
    (``utils.serialization.cast_params_for_inference``), as JAX's benchmark
    casts them. Each rep draws fresh images and queries on the card from one
    ``torch.Generator`` (two separate draws: images, then queries) and runs
    the forward; a batch of ``reps`` reps is timed on the host clock and
    between CUDA events, and the median of 3 timed batches is kept.
    ``route`` picks the kernels (``config.KernelRoute``)."""
    from .utils.serialization import cast_params_for_inference

    device = resolve_device(device, "run_benchmark")
    cfg = cfg or get_config("ours")
    # one-time cast: the benchmark times inference, not f32 masters
    model = cast_params_for_inference(build_comet(cfg, device=device, seed=seed, route=route),
                                      cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (1, cfg.seqlen, cfg.img_size, cfg.img_size, 3)

    def run_many(n):
        with torch.inference_mode():
            acc = torch.zeros((), device=device)
            for _ in range(n):
                images = torch.randn(shape, generator=gen, device=device)
                queries = (torch.rand((1, cfg.track_num, 2), generator=gen, device=device)
                           * (cfg.img_size - 64) + 32)
                acc += model(images, queries)["pred_pose_enc"].sum()
        return float(acc)

    for _ in range(warmup):
        run_many(reps)
    batches = []
    for _ in range(3):
        with _Timer(device) as t:
            checksum = run_many(reps)
        batches.append(t)
    if not math.isfinite(checksum):
        raise RuntimeError("run_benchmark: the forward's outputs are not finite")
    host_s = statistics.median(t.host_s for t in batches)
    seq_per_sec = reps / host_s
    out = {
        "metric": f"sequences/sec/chip (seqlen={cfg.seqlen}, {cfg.img_size}px, N={cfg.track_num})",
        "value": round(seq_per_sec, 4),
        "unit": "seq/s",
        "vs_baseline": round(seq_per_sec / REFERENCE_SEQ_PER_SEC, 3),
        "fps": round(seq_per_sec * cfg.seqlen, 2),
        "ms_per_sequence": round(1000.0 * host_s / reps, 2),
        "device": _device_name(device),
        "device_ms_per_sequence": None,
    }
    if device.type == "cuda":
        out["device_ms_per_sequence"] = round(
            1000.0 * statistics.median(t.device_s for t in batches) / reps, 2)
    return out


def run_train_benchmark(
    cfg: Optional[CometConfig] = None, warmup: int = 2, reps: int = 8, seed: int = 0,
    route: KernelRoute = KernelRoute(), device=None,
) -> Dict:
    """Train-step throughput (forward, backward, clip and AdamW) of the full
    model at batch 1, steps/s.

    The model keeps f32 master parameters and computes in ``cfg.dtype``
    (bf16), with the optimizer of ``training.build_optimizer`` (lr
    ``cfg.train.lr``, 100 steps per epoch). Queries and gt cameras are drawn
    once and each rep's images afresh on the card, all from one
    ``torch.Generator``; a batch of ``reps`` steps is timed on the host
    clock and between CUDA events, and the median of 3 timed batches is
    kept. ``route`` picks the kernels (``config.KernelRoute``)."""
    from .geometry.cameras import CameraSet
    from .training.loop import build_train_step
    from .training.optim import build_optimizer

    device = resolve_device(device, "run_train_benchmark")
    cfg = cfg or get_config("ours")
    model = build_comet(cfg, device=device, seed=seed, route=route)
    optimizer, scheduler = build_optimizer(model, cfg.train.lr, steps_per_epoch=100)
    step = build_train_step(model, cfg, optimizer, scheduler)
    gen = torch.Generator(device=device).manual_seed(seed)
    s, hw = cfg.seqlen, cfg.img_size

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device)

    queries = torch.rand((1, cfg.track_num, 2), generator=gen, device=device) * (hw - 64) + 32
    q = draw(1, s, 4)
    t_uvz = draw(1, s, 3)
    t_uvz[..., 2] = 3.0
    gt = CameraSet(q=q / q.norm(dim=-1, keepdim=True), t_xyz=draw(1, s, 3), t_uvz=t_uvz,
                   focal=torch.full((1, s, 2), 1745.0, device=device),
                   pp=torch.full((1, s, 2), hw / 2.0, device=device),
                   ratio=torch.full((1,), 0.5, device=device))

    def run_many(n):
        acc = torch.zeros((), device=device)
        for _ in range(n):
            acc += step(draw(1, s, hw, hw, 3), queries, gt)["loss"]
        return float(acc)

    for _ in range(warmup):
        run_many(reps)
    batches = []
    for _ in range(3):
        with _Timer(device) as t:
            checksum = run_many(reps)
        batches.append(t)
    if not math.isfinite(checksum):
        raise RuntimeError("run_train_benchmark: the losses are not finite")
    host_s = statistics.median(t.host_s for t in batches)
    out = {
        "metric": f"train steps/sec/chip (seqlen={cfg.seqlen}, {cfg.img_size}px, "
                  f"N={cfg.track_num}, batch=1)",
        "value": round(reps / host_s, 4),
        "unit": "steps/s",
        "ms_per_step": round(1000.0 * host_s / reps, 2),
        "device": _device_name(device),
        "device_ms_per_step": None,
    }
    if device.type == "cuda":
        out["device_ms_per_step"] = round(
            1000.0 * statistics.median(t.device_s for t in batches) / reps, 2)
    return out


def run_eval_data_benchmark(
    cfg: Optional[CometConfig] = None,
    data_root: Optional[str] = None,
    max_sequences: int = 16,
    device_preprocess: bool = True,
    resample: str = "bilinear",
    seed: int = 0,
    eval_batch: int = 2,
    device=None,
) -> Dict:
    """End-to-end eval throughput with data: PIL decode + keypoint seeding +
    (card) preprocessing + the eval step, sequences/s. Without ``data_root``
    a synthetic AMD-layout fixture is written to a temporary directory. The
    parameters are cast to ``cfg.dtype`` once, as in :func:`run_benchmark`.
    One warm-up pass, then the median of 3 timed passes over n sequences."""
    import os
    import tempfile

    from .data.datasets import AMDDataset
    from .training.loop import evaluate
    from .utils.serialization import cast_params_for_inference

    device = resolve_device(device, "run_eval_data_benchmark")
    cfg = cfg or get_config("ours")
    model = cast_params_for_inference(build_comet(cfg, device=device, seed=seed), cfg.dtype)

    with tempfile.TemporaryDirectory() as tmp:
        if data_root is None:
            from .data.fixtures import generate_amd_fixture

            data_root = os.path.join(tmp, "AMD_eval")
            generate_amd_fixture(data_root, n_seqs=max(max_sequences, 8),
                                 n_frames=cfg.seqlen + 4)
        dataset = AMDDataset(data_root, crop_size=cfg.img_size, seq_len=cfg.seqlen,
                             use_augs=False)
        if device_preprocess:
            from .data.device_pipeline import DevicePreprocessDataset

            dataset = DevicePreprocessDataset(dataset, resample=resample, keep_on_device=True,
                                              decode="pil", device=device)
        n = min(len(dataset), max_sequences)
        quiet = dict(print_fn=lambda *a: None, eval_batch=eval_batch, device=device)
        evaluate(model, dataset, cfg, max_sequences=min(eval_batch, n), **quiet)
        times = []
        for _ in range(3):
            with _Timer(device) as t:
                evaluate(model, dataset, cfg, max_sequences=n, **quiet)
            times.append(t.host_s)
    seq_per_sec = n / statistics.median(times)
    return {
        "metric": f"eval-with-data sequences/sec (seqlen={cfg.seqlen}, {cfg.img_size}px, "
                  f"device_preprocess={device_preprocess}, decode=pil, "
                  f"resample={resample if device_preprocess else 'host-lanczos'})",
        "value": round(seq_per_sec, 4),
        "unit": "seq/s",
        "vs_baseline": round(seq_per_sec / REFERENCE_SEQ_PER_SEC, 3),
        "n_sequences": n,
        "n_passes": 3,
        "eval_batch": eval_batch,
        "device": _device_name(device),
    }


def run_softmax_variants(
    reps: int = 32, seed: int = 0, device=None,
    shapes: Sequence[Tuple[str, int, int, int, int, int]] = SOFTMAX_SHAPES,
    print_fn=print,
) -> List[Dict]:
    """The TPU tool's A/B of softmax forms in K1, at its shapes: bf16 q, k, v
    drawn on the card from ``seed``, each form's output against the plain
    reference (K1's function in f32 softmax, the tool's
    ``_reference_attention``) and its median time over ``reps`` calls
    between CUDA events (host time on the CPU). Prints the tool's lines and
    returns one dict per shape with ``forms``: {form: {ms, max_abs_err}}."""
    from .ops.attn import attention_reference, fused_attention

    device = resolve_device(device, "run_softmax_variants")
    gen = torch.Generator(device=device).manual_seed(seed)
    results = []
    for name, b, lq, lk, c, h in shapes:
        q, k, v = (torch.randn(b, n, c, generator=gen, device=device).bfloat16()
                   for n in (lq, lk, lk))
        want = attention_reference(q, k, v, h, (c // h) ** -0.5).float()
        print_fn(f"== {name} [{b}x{lq}x{c}, {h} heads]")
        forms = {}
        for form in SOFTMAX_FORMS:
            kind = "base" if form == "exp2" else form
            fn = lambda: fused_attention(q, k, v, h, softmax=kind)  # noqa: E731
            err = (fn().float() - want).abs().max().item()
            ms = _median_call_ms(fn, reps, device)
            forms[form] = dict(ms=ms, max_abs_err=err)
            print_fn(f"  {form:6s} {ms:7.3f} ms  maxerr={err:.2e}")
        results.append(dict(name=name, shape=[b, lq, lk, c, h], forms=forms))
    return results


# ~25 ms of the card's clock: longer than the host takes to queue the timed calls
_SLEEP_CYCLES = 50_000_000


def _median_call_ms(fn, reps: int, device: torch.device) -> float:
    """Median time of one call of fn over ``reps`` calls: between CUDA
    events on the card, on the host clock on the CPU. On the card the calls
    are queued behind a sleep kernel, so that the events time the card and
    not the host's launch path, which can be longer than a kernel."""
    fn()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize()
    torch.cuda._sleep(_SLEEP_CYCLES)
    events = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)
