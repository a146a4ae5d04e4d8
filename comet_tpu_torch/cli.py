"""Command-line interface of the port: ``python -m comet_tpu_torch.cli <eval|train|demo|bench|export|match>``.

Counterpart of ``comet_tpu/cli.py``, with its arguments and outputs:

  eval  --preset ours --data-root datasets/AMD/AMD_eval --output-dir out
  train --preset ours --data-root datasets/AMD --epochs 300 [--windowed]
  demo  --preset ours --data-root datasets/DCA_SpaceNet/model1/testing
  bench --preset ours --suite infer|train|data|all
  export --preset ours [--seq-frames 48] [--batch 1] [--output path.pt2]
  match --experiment superpoint+lightglue_homography [--load-experiment DIR] [--list]
  match --experiment superpoint+lightglue_homography --train [--exp-dir DIR] [--resume]
  match --pipeline hpatches|relpose [--exp-dir DIR] [--image-dir DIR [--pairs-file F]] [--inspect K]
  match --experiment superpoint+nn --export-features DIR [--exp-dir DIR]

Every command runs on the CUDA card unless ``--device cpu`` is given, and
raises without a card. ``eval`` writes ``test_results.csv`` rows compatible
with the reference's CsvLogger; ``train`` writes ``train_results.csv``,
``ckpt/ckpt_NNNNNN`` (the port's ``torch.save`` format) and the best
weights as ``ckpt/best.pt`` beside ``best.json``; ``demo`` writes per
sequence the results JSON, a GLB and an HTML scene, a reprojection video and
a COLMAP text model, and runs sequences longer than ``seqlen`` in windows;
``export`` writes a ``torch.export`` artifact of the forward (or of the
windowed chain for ``--seq-frames`` frames) and its JSON manifest
(``utils/serving.py``). ``train`` runs data-parallel with one process per
device: ``--n-devices N`` starts N local ranks, ``--coordinator HOST:PORT
--num-processes P --process-id I`` joins a group of P processes (NCCL on the
cards, gloo on the CPU); rank 0 alone writes the CSV, the checkpoints and
``best.*``. ``--loader native`` reads the frames with the C++ loader
(``native/``, built with ``g++`` at first use; it raises where the library
cannot be built, and never falls back to PIL), alone or under
``--device-preprocess``. ``--checkpoint`` takes the port's ``.pt`` weights,
a ``ckpt_NNNNNN`` directory of the port's training, or a flax ``.msgpack``
written by the JAX package (read without JAX). ``--keypoints superpoint``
seeds the queries with SuperPoint on the command's device. ``match`` runs a
named matching experiment (``matching/configs.py``) on the synthetic
homography benchmark and prints one JSON row, as the JAX package's does;
``--load-experiment`` reads matcher checkpoints of either package.
``match --train`` trains the experiment's matcher on generated homography
pairs and writes checkpoints that both packages read (``--resume``,
``--ckpt-every``, ``--val-pairs``, ``--batch-size``; ``--exp-dir`` also tees
the output to its ``log.txt``). ``match --pipeline hpatches|relpose`` runs a
cached-prediction evaluation pipeline (``matching/eval_pipeline.py``) into
``--exp-dir`` and prints its summary row; as in the JAX package its conf
comes from ``--n-pairs``, ``--seed``, ``--image-size`` and ``--image-dir``
alone, so ``--experiment`` does not change it (SIFT and mutual nearest
neighbours). ``--inspect K`` then draws its K worst pairs.
``--export-features DIR`` writes the experiment's extractor features of
every image in DIR to ``<exp-dir>/features.h5`` (read back by the
``cache_loader`` model). The ``.h5`` files are the JAX package's format.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

# the devices an artifact is exported for (JAX's --platforms)
EXPORT_DEVICES = ("cuda", "cpu")


def _common(parser):
    parser.add_argument("--preset", default="ours", help="ours|abl_all|abl_track|abl_time|abl_uvz")
    parser.add_argument("--data-root", default=None)
    parser.add_argument("--output-dir", default="outputs")
    parser.add_argument("--seqlen", type=int, default=None)
    parser.add_argument("--img-size", type=int, default=None)
    parser.add_argument("--track-num", type=int, default=None)
    parser.add_argument("--dataset", default=None, help="intrinsics key override")
    parser.add_argument("--checkpoint", default=None,
                        help="a weight file saved by utils.serialization.save_params (.pt), a "
                             "flax .msgpack of the JAX package, or a ckpt_NNNNNN directory of a "
                             "training run")
    parser.add_argument("--keypoints", default="corners", help="corners|grid|superpoint")
    parser.add_argument("--max-sequences", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--f32", action="store_true", help="disable bf16 compute")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    parser.add_argument(
        "--device-preprocess", action="store_true",
        help="crop, resize and normalize on the device (the default host path is PIL LANCZOS, "
             "the reference's); applies to eval, train and demo",
    )
    parser.add_argument("--device-resample", default="bilinear", choices=["bilinear", "lanczos"],
                        help="the device preprocessing's filter")
    parser.add_argument("--loader", default="pil", choices=["pil", "native"],
                        help="frame loader: pil (the reference's host path) or native (the "
                             "C++ loader, bit-exact against pil)")
    parser.add_argument("--eval-batch", type=int, default=1,
                        help="eval: sequences batched per forward")
    parser.add_argument(
        "--demo-seq-len", type=int, default=None,
        help="demo: total frames per sequence; when > seqlen the model runs in sliding windows "
             "of seqlen with pose chaining (windowed mode)",
    )


def _build(args):
    from .config import get_config

    cfg = get_config(args.preset)
    overrides = {}
    if args.seqlen:
        overrides["seqlen"] = args.seqlen
    if args.img_size:
        overrides["img_size"] = args.img_size
    if args.track_num:
        overrides["track_num"] = args.track_num
    if args.dataset:
        overrides["dataset"] = args.dataset
    if args.data_root:
        overrides["data_root"] = args.data_root
    if args.f32:
        overrides["compute_dtype"] = "float32"
    return cfg.replace(**overrides) if overrides else cfg


def _device(args):
    from .device import resolve_device

    return resolve_device(args.device, f"comet_tpu_torch.cli {args.command}")


def _finite_json(obj):
    """json.dumps-safe copy: non-finite floats become None (json.dumps
    would emit bare Infinity/NaN, which is not valid JSON)."""
    if isinstance(obj, dict):
        return {k: _finite_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite_json(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def _maybe_device_preprocess(dataset, args, device, keep_on_device=False):
    """Wrap a dataset in the loaders asked for: the device preprocessing
    (with the C++ loader's decode under ``--loader native``), or the C++
    loader alone; ``keep_on_device`` leaves the images on the device for
    consumers that feed them straight to the model (the eval loop)."""
    native = getattr(args, "loader", "pil") == "native"
    if getattr(args, "device_preprocess", False):
        from .data.device_pipeline import DevicePreprocessDataset

        return DevicePreprocessDataset(dataset, resample=args.device_resample,
                                       keep_on_device=keep_on_device,
                                       decode="native" if native else "pil", device=device)
    if native:
        from .data.native_loader import NativeLoaderDataset

        return NativeLoaderDataset(dataset)
    return dataset


def _init_model(cfg, seed=0, checkpoint=None, inference=True, device=None):
    """The model on ``device``, with random weights from ``seed`` or those of
    ``checkpoint``; for inference its parameters are cast to ``cfg.dtype``
    once (f32 masters are a training concern)."""
    from .models import build_comet
    from .utils.serialization import cast_params_for_inference, load_params

    model = build_comet(cfg, device=device, seed=seed)
    if checkpoint:
        if os.path.isdir(checkpoint):
            from .training.checkpoints import restore_checkpoint

            restore_checkpoint(checkpoint, {"model": model})
        else:
            load_params(checkpoint, model)
    if inference:
        cast_params_for_inference(model, cfg.dtype)
    return model


def _as_tensor(x, device):
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def cmd_eval(args):
    from .data import AMDDataset
    from .training import CsvLogger, evaluate

    cfg = _build(args)
    device = _device(args)
    model = _init_model(cfg, args.seed, args.checkpoint, device=device)
    dataset = AMDDataset(cfg.data_root, crop_size=cfg.img_size, seq_len=cfg.seqlen,
                         use_augs=False)
    dataset = _maybe_device_preprocess(dataset, args, device, keep_on_device=True)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = CsvLogger(os.path.join(args.output_dir, "test_results.csv"))
    t0 = time.time()
    metrics = evaluate(model, dataset, cfg, keypoint_backend=args.keypoints,
                       max_sequences=args.max_sequences, eval_batch=args.eval_batch or 1,
                       device=device)
    metrics["lr"] = 0.0
    logger.log(0, metrics)
    elapsed = time.time() - t0
    n = min(len(dataset), args.max_sequences or len(dataset))
    print(json.dumps(_finite_json({k: round(v, 5) for k, v in sorted(metrics.items())
                                   if not k.startswith("Auc_scene")}), indent=2))
    print(f"sequences/sec: {n / elapsed:.3f}")


def cmd_train(args):
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from .data import AMDDataset, seed_query_points
    from .parallel import init_distributed, make_mesh
    from .training import (
        CsvLogger, RunningStats, TrainingMonitor, auto_resume, build_optimizer,
        build_train_step, evaluate, fit_epoch, process_local_order, save_checkpoint,
    )
    from .training.data_parallel import agreed_steps, replicate_train_state
    from .training.loop import _merge_process_averages
    from .training.stats import TO_PLOT_METRICS

    cfg = _build(args)
    train_over = {}
    if args.epochs is not None:
        train_over["epochs"] = args.epochs
    if args.ckpt_interval is not None:
        train_over["ckpt_interval"] = args.ckpt_interval
    if args.eval_interval is not None:
        train_over["eval_interval"] = args.eval_interval
    if train_over:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train_over))

    windowed = args.windowed
    train_seq_len = (args.train_seq_len or 2 * cfg.seqlen) if windowed else cfg.seqlen
    train_ds = AMDDataset(os.path.join(cfg.data_root, "AMD_train"), crop_size=cfg.img_size,
                          seq_len=train_seq_len, use_augs=True, seed=cfg.train.seed)

    # data-parallel topology, one process per device: --coordinator joins a
    # group (every process passes it); --n-devices N > 1 alone starts N
    # local ranks that do; else one process on one device
    if args.coordinator:
        device = init_distributed(args.coordinator, args.num_processes, args.process_id,
                                  device=args.device)
        world, rank = dist.get_world_size(), dist.get_rank()
        global_batch = max(args.global_batch or world, 1)
    else:
        world, rank = 1, 0
        n_devices = max(args.n_devices or 1, 1)
        global_batch = max(args.global_batch or n_devices, 1)
        if 0 < len(train_ds) < global_batch:
            # batches are whole, so a batch wider than the data would give
            # no step: clamp it, and the devices to a count that divides it
            global_batch = len(train_ds)
            print(f"note: dataset smaller than the requested batch — clamped to global batch "
                  f"{global_batch}")
        n_devices = math.gcd(n_devices, global_batch)
        if n_devices > 1:
            return _spawn_local_ranks(args, n_devices, global_batch)
        device = _device(args)
    local_len = len(range(rank, len(train_ds), world))
    if world > 1:
        # an uneven global batch would silently floor each process's share
        if global_batch % world:
            raise SystemExit(f"--global-batch {global_batch} must be divisible by the process "
                             f"count {world}")
        local_batch = global_batch // world
        if 0 < local_len < local_batch:
            raise SystemExit(f"dataset shard ({local_len} sequences/process) smaller than the "
                             f"per-process batch {local_batch}; lower --global-batch")
    else:
        local_batch = global_batch = min(global_batch, max(local_len, 1))
    mesh = make_mesh(n_data=world, device=device) if world > 1 else None
    lead = rank == 0  # writes the CSV, the checkpoints and best.*
    steps_per_epoch = max(local_len // local_batch, 1)
    print(f"data-parallel: {world} device(s) x {world} process(es), global batch {global_batch}, "
          f"{steps_per_epoch} steps/epoch")

    model = _init_model(cfg, args.seed, args.checkpoint, inference=False, device=device)
    eval_ds = AMDDataset(os.path.join(cfg.data_root, "AMD_eval"), crop_size=cfg.img_size,
                         seq_len=cfg.seqlen, use_augs=False)
    train_ds = _maybe_device_preprocess(train_ds, args, device)
    eval_ds = _maybe_device_preprocess(eval_ds, args, device)
    optimizer, scheduler = build_optimizer(
        model, cfg.train.lr, steps_per_epoch, cfg.train.restart_num, cfg.train.warmup_ratio,
        cfg.train.warmup_lr_init, cfg.train.clip_grad)
    schedule = scheduler.lr_lambdas[0]
    ckpt_dir = os.path.join(args.output_dir, "ckpt")
    start_epoch, _ = auto_resume(
        ckpt_dir, {"model": model, "optimizer": optimizer, "scheduler": scheduler})
    if start_epoch > 0:
        print(f"resumed from epoch {start_epoch}")
    # the step trains the data-parallel wrapper; checkpoints hold the model
    trained = replicate_train_state(mesh, model, optimizer) if mesh is not None else model
    tf_sched = None
    if windowed:
        from .models.windowed import TeacherForcingScheduler
        from .training import build_windowed_train_step

        train_step = build_windowed_train_step(trained, cfg, optimizer, scheduler, cfg.seqlen)
        if args.tf_start > 0:
            tf_sched = TeacherForcingScheduler(args.tf_start, args.tf_end, args.tf_epochs)
        print(f"windowed training: T={train_seq_len} frames in windows of {cfg.seqlen}, teacher "
              f"forcing " + (f"{args.tf_start} -> {args.tf_end} over {args.tf_epochs} epochs"
                             if tf_sched else "off"))
    else:
        train_step = build_train_step(trained, cfg, optimizer, scheduler)

    # the training CSV adds loss columns ahead of the reference's metric
    # tuple; eval CSVs keep the reference's fieldnames
    logger = CsvLogger(os.path.join(args.output_dir, "train_results.csv"),
                       fieldnames=("loss", "loss_rot", "loss_trans", "tf_ratio", *TO_PLOT_METRICS))
    if lead:
        try:
            from .training.stats import write_live_dashboard

            dash = write_live_dashboard(logger.path)
            print(f"live dashboard: {dash} (open in a browser; auto-refreshes)")
        except OSError as exc:  # pragma: no cover - fs dependent
            print(f"warning: dashboard write failed ({exc!r})")
    monitor = TrainingMonitor(os.path.join(args.output_dir, "anomaly_checkpoints"))
    rng = np.random.default_rng(cfg.train.seed)
    global_step = start_epoch * steps_per_epoch

    def seed_fn(sample):
        frame0 = sample.images[0]
        if not isinstance(frame0, np.ndarray):
            frame0 = frame0.cpu().numpy()
        return seed_query_points(frame0, sample.first_mask, cfg.track_num, cfg.min_track_num,
                                 backend=args.keypoints, rng=rng, device=device)

    for epoch in range(start_epoch, cfg.train.epochs):
        stats = RunningStats()
        order = process_local_order(rng, len(train_ds))

        def on_metrics(step_i, rows, _epoch=epoch):
            nonlocal global_step
            for row in rows:
                if lead:
                    monitor.check(row["loss"], global_step, {"epoch": _epoch})
                row["lr"] = float(schedule(global_step))
                stats.update(row)
            global_step += 1
            if step_i % cfg.train.print_interval == 0:
                print(stats.status_string(step_i, steps_per_epoch, "train"))

        if windowed:
            # long sequences, batch 1 per rank: one windowed chain per
            # sequence, the ranks' gradients averaged step by step
            from .training import make_gt_cameras, metric_block

            if mesh is not None:
                order = order[:agreed_steps(mesh, len(order))]
            tf_ratio = tf_sched.ratio(epoch) if tf_sched else 0.0
            for step_i, seq_idx in enumerate(order):
                sample = train_ds[int(seq_idx)]
                queries = seed_fn(sample)
                gt_cams = make_gt_cameras(sample)
                use_tf = bool(tf_sched and tf_sched.use_teacher_forcing(epoch, rng))
                aux = train_step(_as_tensor(sample.images, device)[None],
                                 _as_tensor(queries, device)[None], gt_cams, teacher_force=use_tf)
                row = metric_block(aux, gt_cams)
                row["tf_ratio"] = tf_ratio
                on_metrics(step_i, [row])
        else:
            fit_epoch(train_step, train_ds, seed_fn, local_batch, order, device=device, mesh=mesh,
                      on_metrics=on_metrics)

        # the epoch's row: the averages over every rank's rows
        row = _merge_process_averages(stats, mesh) if mesh is not None else stats.averages()
        if lead:
            logger.log(epoch, row)
            if epoch > 0:
                # chart failures (no matplotlib, a headless backend) never stop training
                try:
                    from .training.stats import plot_metrics_png

                    plot_metrics_png(logger.path)
                except Exception as exc:  # pragma: no cover - env dependent
                    print(f"warning: metric plot failed ({exc!r})")
        if lead and (epoch + 1) % cfg.train.ckpt_interval == 0:
            save_checkpoint(ckpt_dir, epoch, {"model": model, "optimizer": optimizer,
                                              "scheduler": scheduler})
        if (epoch + 1) % cfg.train.eval_interval == 0:
            eval_metrics = evaluate(model, eval_ds, cfg, keypoint_backend=args.keypoints,
                                    max_sequences=args.max_sequences, mesh=mesh, device=device)
            print("eval:", {k: round(v, 4) for k, v in eval_metrics.items()
                            if not k.startswith("Auc_scene")})
            if lead:
                _maybe_save_best(ckpt_dir, model, eval_metrics, epoch, key=args.best_key)
    if args.coordinator:
        dist.destroy_process_group()


# the command a local rank of ``train --n-devices N`` runs, before its arguments
RANK_COMMAND = ("-m", "comet_tpu_torch.cli")


def _spawn_local_ranks(args, n: int, global_batch: int) -> None:
    """``train --n-devices n`` in one launch: n processes on this machine,
    one per device (cards 0 .. n-1, or the CPU), joined over localhost with
    the same arguments and ``--global-batch``; returns when all have ended,
    and raises if one fails."""
    import torch

    from .parallel.launch import free_port, run_local_ranks

    device = _device(args)
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"train --n-devices {n}: one rank per card, and this machine has "
                           f"{torch.cuda.device_count()} CUDA card(s)")
    coordinator = f"localhost:{free_port()}"
    print(f"data-parallel: starting {n} local ranks ({device.type}), rendezvous at {coordinator}")
    run_local_ranks([[sys.executable, *RANK_COMMAND, *args.argv, "--global-batch", str(global_batch),
                      "--coordinator", coordinator, "--num-processes", str(n),
                      "--process-id", str(i)] for i in range(n)])


def _maybe_save_best(ckpt_dir, model, eval_metrics, epoch, key="Auc_30"):
    """Weights-only best checkpoint ``best.pt``, tracked by an eval metric
    (the reference's ckpt/best.bin, selected like gluefactory
    train.py:547-556 by train.best_key). Higher is better for the
    Auc_*/*acc keys; *_err/R_avg/T_avg/loss are minimized. The running best
    survives auto-resume through the ``best.json`` sidecar."""
    from .utils.serialization import save_params

    if key not in eval_metrics:
        print(f"warning: best-key {key!r} not in eval metrics; skipping best")
        return
    minimize = key.endswith("_err") or key in ("R_avg", "T_avg", "loss")
    value = float(eval_metrics[key])
    os.makedirs(ckpt_dir, exist_ok=True)
    sidecar = os.path.join(ckpt_dir, "best.json")
    prev = None
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            prev = json.load(f)
        if prev.get("key") != key:
            prev = None  # the metric changed: tracking restarts
    better = prev is None or (value < prev["value"] if minimize else value > prev["value"])
    if better:
        save_params(os.path.join(ckpt_dir, "best.pt"), model)
        with open(sidecar, "w") as f:
            json.dump({"key": key, "value": value, "epoch": epoch}, f)
        print(f"new best {key}={value:.5f} (epoch {epoch}) -> best.pt")


def cmd_demo(args):
    """DCA_SpaceNet demo: per sequence the results JSON (parity with
    test_e2epose2.py and train_eval_func_new_cp5.py:679-767), the GLB and
    HTML scenes, the reprojection video and the COLMAP text model."""
    import numpy as np
    import torch

    from .data import DCADataset, seed_query_points
    from .geometry.quaternions import quat_to_matrix
    from .models.comet import decode_predictions, encode_gt
    from .models.windowed import windowed_forward_scan
    from .training import eval_step, make_gt_cameras, metric_block
    from .training.loop import cameras_to
    from .twoview.triangulation import projection_matrices, triangulate_tracks
    from .utils.colmap_io import batch_to_colmap, write_model_text
    from .utils.export import export_sequence_json
    from .utils.scene_export import export_glb_scene, export_scene_html

    cfg = _build(args).replace(dataset="AMD_test")
    device = _device(args)
    model = _init_model(cfg, args.seed, args.checkpoint, device=device)
    demo_seq_len = args.demo_seq_len or cfg.seqlen
    dataset = DCADataset(cfg.data_root, crop_size=cfg.img_size, seq_len=demo_seq_len,
                         use_augs=False)
    dataset = _maybe_device_preprocess(dataset, args, device)
    rng = np.random.default_rng(cfg.train.seed)
    n = min(len(dataset), args.max_sequences or len(dataset))
    for i in range(n):
        sample = dataset[i]
        frames = np.asarray(sample.images) if not isinstance(sample.images, torch.Tensor) \
            else sample.images.cpu().numpy()
        queries = seed_query_points(frames[0], sample.first_mask, cfg.track_num,
                                    cfg.min_track_num, backend=args.keypoints, rng=rng,
                                    device=device)
        gt_cams = make_gt_cameras(sample)
        images = _as_tensor(frames, device)[None]
        q_in = _as_tensor(queries, device)[None]
        if frames.shape[0] > cfg.seqlen:
            # a long sequence: windows of seqlen with pose chaining (the
            # reference's intended forward_window); frames > seqlen rules
            # out the repeated frames that only the host loop serves
            with torch.inference_mode():
                cams = cameras_to(gt_cams, device)
                enc, tracks = windowed_forward_scan(model, images, q_in, cfg.seqlen, cams.ratio)
                q_abs, t_abs = decode_predictions(cfg, enc, cams)
                gt_enc = encode_gt(cfg, cams)
            out = {"pred_pose_enc": enc, "gt_pose_enc": gt_enc, "pred_q": q_abs,
                   "pred_t": t_abs, "pred_track": tracks, "track_score": None}
        else:
            out = eval_step(model, cfg, images, q_in, gt_cams)
        metrics = metric_block(out, gt_cams, sample.seq_name)
        json_path = export_sequence_json(args.output_dir, sample.seq_name, out, gt_cams, metrics)

        # 3-D scene (GLB point cloud and camera frusta; gradio.py:50-231):
        # the predicted tracks triangulated with the predicted cameras in
        # crop space (fx * ratio, centre crop / 2: the uv codec's convention)
        q = out["pred_q"][0].float()  # [S, 4] wxyz
        t = out["pred_t"][0].float()  # [S, 3]
        tracks = out["pred_track"][0].float()  # [S, N, 2] crop px
        ratio = float(np.asarray(sample.ratio))
        fx = float(gt_cams.focal[0, 0]) * ratio
        fy = float(gt_cams.focal[0, 1]) * ratio
        c0 = cfg.img_size / 2.0
        k_mat = torch.tensor([[fx, 0.0, c0], [0.0, fy, c0], [0.0, 0.0, 1.0]],
                             dtype=torch.float32, device=q.device)
        proj = projection_matrices(q, t, k_mat)
        # observations weighted by the model's own track confidence (the
        # normalized inverse heatmap std, E2Epose2.py:232-239)
        if out.get("track_score") is not None:
            mask = out["track_score"][0].float()
        else:
            mask = torch.ones(tracks.shape[:2], dtype=torch.float32, device=q.device)
        pts3d = triangulate_tracks(proj, tracks, mask).cpu().numpy()
        q_np, t_np, tracks_np = q.cpu().numpy(), t.cpu().numpy(), tracks.cpu().numpy()
        mask_np, k_np = mask.cpu().numpy(), k_mat.cpu().numpy()
        r_rows = quat_to_matrix(q).cpu().numpy()
        # per-point colour from the (denormalized) first frame
        mean = np.array([0.485, 0.456, 0.406])
        std = np.array([0.229, 0.224, 0.225])
        xy = np.clip(tracks_np[0].round().astype(int), 0, cfg.img_size - 1)
        cols = np.clip(frames[0][xy[:, 1], xy[:, 0]] * std + mean, 0, 1)
        # row-convention R (x_cam = x_world @ R + T) -> the column
        # convention's world-to-camera rotation R^T
        rs = np.swapaxes(r_rows, -1, -2)
        base = os.path.join(args.output_dir, f"{sample.seq_name.replace('/', '_')}_scene")
        export_glb_scene(base + ".glb", pts3d, cols, list(rs), list(t_np))
        export_scene_html(base + ".html", pts3d, cols, q_np, t_np)
        written = [".glb", ".html"]
        try:
            from .utils.visualize import save_reprojection_video

            save_reprojection_video(base + "_reproj.mp4", frames, pts3d, r_rows, t_np, k_np,
                                    valid=mask_np.sum(0) > 0)
            written.append("_reproj.mp4")
        except Exception as exc:  # pragma: no cover - cv2 codec dependent
            print(f"warning: reprojection video failed ({exc!r})")

        # COLMAP text model (tensor_to_pycolmap.py:16): the same cameras and
        # points in the standard sparse-model format
        s = tracks_np.shape[0]
        ext = np.concatenate([rs, t_np[..., None]], axis=-1)
        write_model_text(
            batch_to_colmap(pts3d, ext, np.broadcast_to(k_np, (s, 3, 3)), tracks_np,
                            mask_np > 0.5, (cfg.img_size, cfg.img_size), shared_camera=True,
                            rgb=np.clip(cols * 255.0, 0, 255).astype(np.uint8)),
            base + "_colmap")
        written.append("_colmap/")
        print(f"saved {json_path} + {os.path.basename(base)} ({', '.join(written)})  "
              f"R_avg={metrics['R_avg']:.3f}")


def cmd_bench(args):
    from .bench_lib import run_benchmark, run_eval_data_benchmark, run_train_benchmark

    cfg = _build(args)
    device = _device(args)
    which = args.suite
    if which in ("infer", "all"):
        print(json.dumps(_finite_json(run_benchmark(cfg, warmup=3, reps=10, device=device))))
    if which in ("train", "all"):
        print(json.dumps(_finite_json(run_train_benchmark(cfg, warmup=2, reps=6, device=device))))
    if which in ("data", "all"):
        print(json.dumps(_finite_json(run_eval_data_benchmark(
            cfg, data_root=args.data_root, max_sequences=args.max_sequences or 16,
            device=device))))


def cmd_export(args):
    """Serving export: the forward (or, with ``--seq-frames``, the windowed
    chain for that many frames) traced by ``torch.export`` with the
    weights as a runtime input, written to ``<output-dir>/comet_<preset>_
    forward.pt2`` (or ``..._windowed<T>.pt2``) with a JSON manifest beside
    it; prints the artifact's path and the manifest. JAX's ``--platforms``
    names the device here: ``cuda`` (the default) or ``cpu``."""
    from .utils import serving

    if args.platforms is not None:
        if args.platforms not in EXPORT_DEVICES:
            raise ValueError(f"export: --platforms {args.platforms!r}: this port exports for one "
                             f"of {EXPORT_DEVICES}")
        if args.device is not None and args.device != args.platforms:
            raise ValueError(f"export: --platforms {args.platforms} and --device {args.device} "
                             "disagree")
        args.device = args.platforms
    cfg = _build(args)
    device = _device(args)
    # random weights: the artifact takes its weights as an input
    model = _init_model(cfg, seed=args.seed, inference=True, device=device)
    extra = {"preset": args.preset, "batch": args.batch}
    if args.seq_frames:
        exported = serving.export_windowed(model, cfg, args.seq_frames, device=device,
                                           params_dtype=cfg.dtype)
        stem = f"comet_{args.preset}_windowed{args.seq_frames}"
        extra.update(batch=1, total_frames=args.seq_frames)
    else:
        exported = serving.export_forward(model, cfg, batch=args.batch, device=device,
                                          params_dtype=cfg.dtype)
        stem = f"comet_{args.preset}_forward"
    out = args.output or os.path.join(args.output_dir, stem + ".pt2")
    manifest = serving.save_exported(exported, out, cfg=cfg, extra_manifest=extra)
    print(json.dumps({"artifact": out, **manifest}, sort_keys=True))


def cmd_match(args):
    """Run a named matching experiment on the synthetic homography
    benchmark (pairs, extractor, matcher and estimator on the command's
    device) and print one JSON row of matching and robust-estimation
    metrics, as ``comet_tpu/cli.py``'s ``match`` prints it."""
    from .matching.benchmarks import make_synthetic_pairs, run_homography_benchmark
    from .matching.configs import build_pipeline, list_experiments

    if args.list:
        for name in list_experiments():
            print(name)
        return
    device = _device(args)
    if args.train:
        if args.exp_dir:
            # tee the training output to <exp-dir>/log.txt, as glue-factory does
            from .matching.capture import capture_outputs

            with capture_outputs(os.path.join(args.exp_dir, "log.txt")):
                _match_train(args, device)
        else:
            _match_train(args, device)
        return
    if args.pipeline:
        _match_pipeline(args, device)
        return
    if args.export_features:
        _match_export(args, device)
        return
    size = args.image_size
    pipeline = build_pipeline(args.experiment, image_hw=(size, size))
    if args.load_experiment:
        from .matching.experiments import load_experiment_into_pipeline

        meta = load_experiment_into_pipeline(pipeline, args.load_experiment)
        print(f"loaded checkpoint (step {meta.get('step')}, loss {meta.get('loss')})")
    pairs = make_synthetic_pairs(args.n_pairs, hw=(size, size), seed=args.seed, device=device)
    row = run_homography_benchmark(pipeline, pairs)
    print(json.dumps(_finite_json({"experiment": args.experiment, **row})))


def _match_pipeline(args, device):
    """Run a cached-prediction evaluation pipeline on ``device``: export the
    predictions to <exp-dir>/predictions.h5 (reused on a rerun), evaluate,
    and print the summaries as one JSON row (the JAX package's)."""
    from .matching.eval_pipeline import HomographyEvalPipeline, RelativePoseEvalPipeline

    cls = {"hpatches": HomographyEvalPipeline, "relpose": RelativePoseEvalPipeline}[args.pipeline]
    conf = {"data": {"n_pairs": args.n_pairs, "seed": args.seed}}
    if args.pipeline == "hpatches":
        conf["data"]["image_size"] = args.image_size
        if args.image_dir:
            conf["data"]["image_dir"] = args.image_dir
            conf["data"]["pairs_file"] = args.pairs_file
    elif args.image_dir:
        conf["data"]["amd_dir"] = args.image_dir
        conf["data"]["max_pairs"] = args.n_pairs
    pipe = cls(conf, device=device)
    exp_dir = args.exp_dir or os.path.join("outputs", f"match_{args.pipeline}")
    summaries, _ = pipe.run(exp_dir, overwrite=args.overwrite, overwrite_eval=args.overwrite)
    if args.inspect:
        paths = pipe.inspect(exp_dir, k=args.inspect)
        print(f"inspect: wrote {len(paths)} renders under {os.path.join(exp_dir, 'inspect')}")
    print(json.dumps(_finite_json({"pipeline": args.pipeline, "exp_dir": exp_dir,
                                   **{k: (round(v, 5) if isinstance(v, float) else v)
                                      for k, v in summaries.items()}})))


def _match_export(args, device):
    """The experiment's extractor features (keypoints, descriptors and the
    scores) of every image under --export-features, resized to
    --image-size, into <exp-dir>/features.h5; prints one JSON row."""
    import numpy as np
    from PIL import Image

    from .matching.configs import build_pipeline
    from .matching.eval_pipeline import export_predictions

    size = args.image_size
    pipeline = build_pipeline(args.experiment, image_hw=(size, size), extractor={"device": device})
    exts = (".png", ".jpg", ".jpeg", ".bmp")
    names = sorted(f for f in os.listdir(args.export_features) if f.lower().endswith(exts))
    if not names:
        raise SystemExit(f"no images found under {args.export_features}")

    def loader():
        for name in names:
            img = Image.open(os.path.join(args.export_features, name)).convert("L").resize(
                (size, size), Image.BILINEAR)
            yield {"name": os.path.splitext(name)[0],
                   "image": np.asarray(img, np.float32) / 255.0}

    out = os.path.join(args.exp_dir or os.path.join("outputs", "match_features"), "features.h5")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    export_predictions(loader(), lambda data: pipeline.extractor(data["image"]), out,
                       keys=["keypoints", "descriptors"],
                       optional_keys=["keypoint_scores", "scores"])
    print(json.dumps({"exported": len(names), "experiment": args.experiment, "path": out}))


def _init_matcher(matcher, in_dim: int, seed: int):
    """The experiment's matcher module for descriptors of width ``in_dim``,
    on the CPU, with random weights from ``torch.Generator().manual_seed(seed)``
    (the JAX package initializes from ``PRNGKey(seed)``)."""
    import torch

    from .models.blocks import init_params

    module = type(matcher)(**matcher.conf, in_dim=in_dim)
    init_params(module, torch.Generator().manual_seed(seed))
    return module


def _match_train(args, device):
    """Train a named experiment's matcher on generated homography pairs on
    ``device``, checkpointing into the experiment directory; prints the
    JAX package's progress lines and final JSON row."""
    import numpy as np

    from .matching.configs import get_experiment
    from .matching.experiments import (
        adam_state_from_jax,
        adam_state_to_jax,
        load_checkpoint,
        save_experiment,
    )
    from .matching.registry import get_model
    from .matching.train import (
        build_matcher_train_step,
        build_superglue_train_step,
        make_adam,
        make_homography_training_batch,
    )
    from .weights import module_params_from_jax, module_params_to_jax

    conf = get_experiment(args.experiment)
    tb = conf.get("train")
    if not tb:
        raise SystemExit(f"experiment '{args.experiment}' has no train block (eval-only pairing); "
                         "pick a *_homography/superglue experiment")
    ext_conf = dict(conf["extractor"])
    ext_conf.setdefault("max_keypoints", 128)
    extractor = get_model(ext_conf.pop("name"), **ext_conf)
    mat_conf = dict(conf["matcher"])
    mat_name = mat_conf.pop("name")
    matcher = get_model(mat_name, **mat_conf)

    size = args.image_size

    def next_batch():
        return make_homography_training_batch(
            extractor, rng, batch_size=args.batch_size or 4, image_hw=(size, size),
            difficulty=tb["homography"]["difficulty"], max_angle=tb["homography"]["max_angle"],
            th_positive=conf["ground_truth"]["th_positive"],
            th_negative=conf["ground_truth"]["th_negative"], device=device)

    rng = np.random.default_rng(tb["seed"] + args.seed)
    batch = next_batch()
    module = _init_matcher(matcher, batch["desc0"].shape[-1], tb["seed"]).to(device).train()
    optimizer = make_adam(module, float(tb["lr"]))

    exp_dir = args.exp_dir or os.path.join(
        "outputs", f"match_train_{args.experiment.replace('+', '_')}")
    start_step = 0
    if args.resume:
        tree, meta = load_checkpoint(exp_dir, get_last=True)
        module.load_state_dict(module_params_from_jax(tree["params"], module))
        adam_state_from_jax(tree["opt"], optimizer, module)
        start_step = int(meta.get("step", 0))
        print(f"resumed {exp_dir} at step {start_step}")
    ckpt_every = args.ckpt_every or max(args.steps // 4, 1)
    best = None

    # held-out validation: the current weights benchmarked on fresh pairs,
    # "best" keyed on the homography error instead of the train loss
    val_pipeline = None
    if args.val_pairs:
        from .matching.benchmarks import make_synthetic_pairs, run_homography_benchmark
        from .matching.configs import build_pipeline

        val_pipeline = build_pipeline(args.experiment, image_hw=(size, size))
        val_pairs = make_synthetic_pairs(args.val_pairs, hw=(size, size), seed=args.seed + 10_000,
                                         device=device)

    def val_metric():
        if val_pipeline is None:
            return None
        val_pipeline.matcher.holder["params"] = module_params_to_jax(module)
        row = run_homography_benchmark(val_pipeline, val_pairs)
        print(f"  val: H_err {row['H_error_ransac']:.3f} prec {row['prec@3px']:.3f}")
        return float(row["H_error_ransac"])

    step = (build_superglue_train_step() if mat_name == "matcher_superglue"
            else build_matcher_train_step())
    first = last = None
    for i in range(args.steps):
        if i % max(args.steps // 8, 1) == 0:
            batch = next_batch()
        last = float(step(module, optimizer, batch))
        if first is None:
            first = last
        if i % max(args.steps // 10, 1) == 0:
            print(f"step {i}: loss {last:.4f}")
        if (i + 1) % ckpt_every == 0 or i == args.steps - 1:
            ev = val_metric()
            _, best = save_experiment(
                exp_dir, start_step + i + 1, module_params_to_jax(module),
                adam_state_to_jax(optimizer, module), conf={"experiment": args.experiment},
                loss=last, eval_metric=last if ev is None else ev, best_eval=best)
    print(json.dumps(_finite_json({
        "experiment": args.experiment, "steps": args.steps,
        "loss_first": round(first, 4), "loss_last": round(last, 4),
        "exp_dir": exp_dir, "best_eval": round(best, 4),
    })))


def _match_parser(sub):
    """``match`` with the JAX package's 19 options and ``--device``."""
    pm = sub.add_parser("match", help="run a named matching experiment")
    pm.add_argument("--experiment", default="superpoint+nn")
    pm.add_argument("--list", action="store_true", help="list experiment names and exit")
    pm.add_argument("--n-pairs", type=int, default=8)
    pm.add_argument("--image-size", type=int, default=120)
    pm.add_argument("--seed", type=int, default=0)
    pm.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    pm.add_argument("--pipeline", default=None, choices=["hpatches", "relpose"],
                    help="run a cached-prediction eval pipeline instead of the direct benchmark")
    pm.add_argument("--exp-dir", default=None)
    pm.add_argument("--image-dir", default=None, metavar="DIR",
                    help="--pipeline on on-disk data: hpatches takes a folder of images (each "
                         "warped with exact GT unless --pairs-file gives pairs and H rows); "
                         "relpose an AMD-layout sequence root")
    pm.add_argument("--pairs-file", default=None, metavar="FILE",
                    help="with --image-dir: 'name0 name1 h00..h22' per line")
    pm.add_argument("--overwrite", action="store_true")
    pm.add_argument("--inspect", type=int, default=0, metavar="K",
                    help="after a --pipeline run, render the K worst pairs of the prediction "
                         "cache to <exp-dir>/inspect/*.png")
    pm.add_argument("--train", action="store_true",
                    help="train the experiment's matcher on generated homography pairs instead "
                         "of benchmarking")
    pm.add_argument("--steps", type=int, default=100)
    pm.add_argument("--batch-size", type=int, default=None)
    pm.add_argument("--resume", action="store_true",
                    help="--train: continue from the last checkpoint in --exp-dir")
    pm.add_argument("--ckpt-every", type=int, default=None,
                    help="--train: checkpoint interval in steps (default steps//4); the best "
                         "by loss is copied to checkpoint_best.msgpack")
    pm.add_argument("--val-pairs", type=int, default=0,
                    help="--train: validate each checkpoint on this many held-out synthetic "
                         "pairs and key the best checkpoint on their homography error")
    pm.add_argument("--load-experiment", default=None, metavar="DIR|FILE",
                    help="load a trained matcher checkpoint (the best of an experiment dir, or "
                         "a checkpoint_*.msgpack file) before benchmarking")
    pm.add_argument("--export-features", default=None, metavar="DIR",
                    help="export the extractor's features of every image in DIR to "
                         "<exp-dir>/features.h5")
    pm.set_defaults(fn=cmd_match)


def main(argv=None):
    parser = argparse.ArgumentParser("comet_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, fn in [("eval", cmd_eval), ("train", cmd_train), ("demo", cmd_demo),
                     ("bench", cmd_bench), ("export", cmd_export)]:
        p = sub.add_parser(name)
        _common(p)
        if name == "export":
            p.add_argument("--output", default=None,
                           help="artifact path (default <output-dir>/comet_<preset>_forward.pt2); "
                                "a JSON manifest is written next to it")
            p.add_argument("--batch", type=int, default=1,
                           help="serving batch size fixed in the artifact")
            p.add_argument("--platforms", default=None,
                           help="the device the artifact is for: cuda (default) or cpu")
            p.add_argument("--seq-frames", type=int, default=None,
                           help="export the windowed chain for sequences of this many frames "
                                "instead of the seqlen forward")
        if name == "bench":
            p.add_argument("--suite", default="infer", choices=["infer", "train", "data", "all"],
                           help="infer: pure-tensor forward; train: the train step; data: eval "
                                "with data through the input pipeline")
        if name == "train":
            p.add_argument("--epochs", type=int, default=None)
            p.add_argument("--n-devices", type=int, default=None,
                           help="data-parallel devices on this machine: more than 1 starts one "
                                "process per device (cards 0..N-1, or the CPU with --device cpu)")
            p.add_argument("--global-batch", type=int, default=None,
                           help="sequences per step over every device (default: one per device)")
            p.add_argument("--best-key", default="Auc_30",
                           help="eval metric selecting ckpt/best.pt (*_err/R_avg/T_avg "
                                "minimize, everything else maximizes)")
            p.add_argument("--ckpt-interval", type=int, default=None,
                           help="epochs between full-state checkpoints")
            p.add_argument("--eval-interval", type=int, default=None,
                           help="epochs between eval passes")
            p.add_argument("--windowed", action="store_true",
                           help="teacher-forced windowed training: each sequence is "
                                "--train-seq-len frames, run in sliding windows of seqlen, the "
                                "pose loss over the stitched trajectory")
            p.add_argument("--train-seq-len", type=int, default=None,
                           help="windowed: frames per training sequence (default 2 * seqlen)")
            p.add_argument("--tf-start", type=float, default=1.0,
                           help="windowed: initial teacher-forcing ratio")
            p.add_argument("--tf-end", type=float, default=0.2,
                           help="windowed: final teacher-forcing ratio")
            p.add_argument("--tf-epochs", type=int, default=300,
                           help="windowed: epochs over which the ratio anneals")
            p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                           help="multi-process training: every process joins the group at "
                                "tcp://HOST:PORT (one process per device; on several machines "
                                "give each process its card with --device cuda:K)")
            p.add_argument("--num-processes", type=int, default=None,
                           help="multi-process training: the processes in the group")
            p.add_argument("--process-id", type=int, default=None,
                           help="multi-process training: this process's rank")
        p.set_defaults(fn=fn)
    _match_parser(sub)
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    args.argv = argv
    args.fn(args)


if __name__ == "__main__":
    main()
