"""The port's distributed layer against the JAX package's, on the CPU over gloo.

``comet_tpu_torch.parallel`` (the mesh, sharding, replication, the
tensor-parallel rules), the mesh paths of ``training`` (``fit_epoch``,
``evaluate``, ``replicate_train_state``), the Megatron forward of the
models, the CLI's multi-process ``train`` and ``entry.dryrun_multichip``.

Ranks are processes, and this file is also their program (``python
tests/test_torch_port_distributed.py --worker TASK ...``): it imports
neither JAX nor the other test files at the top, so a rank starts with
torch alone. Each group of ranks runs once per module (a fixture) and saves
what it computed; each test reads its part. Every wait has its own timeout
and every rendezvous a free port, so a hung group fails its tests instead of
running the suite into its limit.

The model is the tiny configuration of tests/test_torch_port_models.py
(``entry.dryrun_config`` is the same), in f32, with one set of weights for
both packages: a flax tree of random numpy values through
``weights.params_from_jax``, the trackers' coordinate updates held at 0 as
in tests/test_torch_port_cli.py, so that the other reduction orders of a
sharded run do not turn into pixels in the random trackers.

Tolerances: the data-parallel step as tests/test_parallel.py holds JAX's
mesh step (loss within 1e-5 relative, every updated parameter within 1e-5
absolute and relative), and against JAX's step on the global batch as
tests/test_torch_port_train.py holds the train steps (losses within 1e-4
relative, camera parameters within 1e-2 x the steps' summed learning
rates); ``fit_epoch`` over 2 processes as tests/test_multiprocess.py (5e-5);
the tensor-parallel forward as tests/test_parallel.py (2e-4 + 1e-4
relative) against the replicated forward and against JAX; a module with a
column product and no row partner within 1e-5 of the replicated module
(f32, another summation order); the mesh eval's merged averages within
1e-5 relative + 1e-4 of one process's ``evaluate(eval_batch=2)``; sharded
correlation sampling within 1e-5 of the unsharded one and of JAX's.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

_TESTS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_TESTS)
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from comet_tpu_torch import cli as tcli  # noqa: E402
from comet_tpu_torch import parallel  # noqa: E402
from comet_tpu_torch.entry import dryrun_config, dryrun_multichip  # noqa: E402
from comet_tpu_torch.parallel.launch import free_port  # noqa: E402

# seconds: a group of ranks, and a rendezvous or collective inside it
GROUP_TIMEOUT_S = 300
RANK_TIMEOUT_S = 120
# the train steps: lr 1e-3 from the first step (no warmup) over a 10-step period
_OPT = dict(base_lr=1e-3, steps_per_epoch=10, restart_epochs=1, warmup_ratio=0.0)
STEPS = 2
EPOCHS = 2
# the CLI's fixture: sequences as long as seqlen, so the dataset draws no
# frame selection that would depend on the order its ranks read it in
_CLI_CFG = dict(seqlen=4, min_track_num=4)
_GRID = ["--keypoints", "grid"]


# ------------------------------------------------------------- the ranks
# (the ranks and the tests run torch on one thread: a reduction split over
# threads adds in another order, which would part the bitwise comparisons)


def _init(rank, world, port):
    torch.set_num_threads(1)
    return parallel.init_distributed(f"localhost:{port}", world, rank, device="cpu",
                                     timeout_s=RANK_TIMEOUT_S)


def _model(cfg, weights, route=None):
    from comet_tpu_torch.config import KernelRoute
    from comet_tpu_torch.models import build_comet

    model = build_comet(cfg, device="cpu", route=route or KernelRoute())
    model.load_state_dict(weights)
    return model


def _train_batch(cfg, b=2, seed=3):
    """A global batch of b rows (numpy), from a seed."""
    rng = np.random.default_rng(seed)
    s, hw, n = cfg.seqlen, cfg.img_size, cfg.track_num
    images = rng.normal(size=(b, s, hw, hw, 3)).astype(np.float32)
    queries = (rng.random((b, n, 2)) * (hw - 20) + 10).astype(np.float32)
    q = rng.normal(size=(b, s, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t_uvz = (rng.normal(size=(b, s, 3)) * 50).astype(np.float32)
    t_uvz[..., 2] = np.abs(t_uvz[..., 2]) + 2.0
    cams = dict(q=q, t_xyz=rng.normal(size=(b, s, 3)).astype(np.float32), t_uvz=t_uvz,
                focal=np.full((b, s, 2), 1745.0, np.float32), pp=np.zeros((b, s, 2), np.float32),
                ratio=np.full((b,), 0.8, np.float32))
    return images, queries, cams


def _torch_rows(batch, rows):
    from comet_tpu_torch.geometry.cameras import CameraSet

    images, queries, cams = batch
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[rows]))  # noqa: E731
    return t(images), t(queries), CameraSet(*(t(cams[f]) for f in CameraSet._fields))


def _track_inputs():
    rng = np.random.default_rng(1)
    fmaps = rng.normal(size=(1, 2, 16, 16, 8)).astype(np.float32)
    coords = (rng.random((1, 2, 16, 2)) * 14).astype(np.float32)
    feats = rng.normal(size=(1, 2, 16, 8)).astype(np.float32)
    return fmaps, coords, feats


def _seed_grid(cfg):
    from comet_tpu_torch.data import seed_query_points

    def seed(sample):
        frame0 = sample.images[0]
        return seed_query_points(np.asarray(frame0), sample.first_mask, cfg.track_num,
                                 cfg.min_track_num, backend="grid",
                                 rng=np.random.default_rng(1234))

    return seed


def _dataset(root, cfg):
    from comet_tpu_torch.data import AMDDataset

    return AMDDataset(os.path.join(root, "AMD_train"), crop_size=cfg.img_size, seq_len=cfg.seqlen,
                      use_augs=False)


def _dp_steps(model, cfg, batch, rows, mesh=None):
    """STEPS train steps on ``rows`` of ``batch``: (losses, the trained
    parameters after, their gradients in the first step, as the optimizer
    got them, and each step's global norm of the gradient)."""
    from comet_tpu_torch.training import build_optimizer, build_train_step, camera_only_mask
    from comet_tpu_torch.training.data_parallel import replicate_train_state

    optimizer, scheduler = build_optimizer(model, **_OPT)
    trained = replicate_train_state(mesh, model, optimizer) if mesh is not None else model
    step = build_train_step(trained, cfg, optimizer, scheduler)
    mask = camera_only_mask(model)
    grads, norms = {}, []

    def mark(part):
        if part == "backward" and not grads:
            grads.update({n: p.grad.clone() for n, p in model.named_parameters() if mask[n]})
        if part == "optimizer":
            norms.append(float(optimizer.last_norm))

    losses = [float(step(*_torch_rows(batch, rows), mark=mark)["loss"]) for _ in range(STEPS)]
    params = {n: p.detach().clone() for n, p in model.named_parameters() if mask[n]}
    return losses, params, grads, norms


def _tp_steps(cfg, weights, mesh, batch):
    """:func:`_dp_steps` of a model that ``shard_params_tp`` sharded over
    ``mesh``'s model axis: each data rank trains on its rows of the global
    batch (all of it at data size 1), DDP over the data group. Its record,
    with the frozen tensors that moved."""
    model = _model(cfg, weights)
    parallel.shard_params_tp(mesh, model)
    laid_out = all(torch.equal(parallel.shard_of(model, n, weights[n].to(p.dtype)), p)
                   for n, p in model.named_parameters())
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()}
    n_data, d = mesh.size(0), mesh.get_local_rank(parallel.DATA)
    rows = slice(0, len(batch[0])) if n_data == 1 else slice(d, d + 1)
    losses, params, grads, norms = _dp_steps(model, cfg, batch, rows, mesh)
    moved = [n for n, p in model.named_parameters() if n not in params
             and not torch.equal(p, frozen[n])]
    return dict(losses=losses, params=params, grads=grads, norms=norms, frozen_moved=moved,
                shard_of_matches=laid_out, saving=_save_sharded(model))


def _range_gaps(got, want):
    """Each tensor's largest |got - want| over its range (largest |want|),
    the range floored at 1e-4 of the largest tensor's, leaving out the noise
    entries of :func:`_noise_entries` (and the tensors that are all noise)."""
    keep = {n: ~_noise_entries(n, w.shape) for n, w in want.items()}
    want = {n: w[keep[n]] for n, w in want.items() if keep[n].any()}
    floor = 1e-4 * max(w.abs().max().item() for w in want.values())
    return {n: (got[n][keep[n]] - w).abs().max().item() / max(w.abs().max().item(), floor)
            for n, w in want.items()}


def _tp_rounding(cfg, weights, mesh, batch):
    """The first-step camera gradients in bf16, replicated and sharded over
    ``mesh``'s model axis, against the replicated step in f32, each on this
    rank's part of every tensor (:func:`_range_gaps`): (replicated bf16
    from f32, TP bf16 from f32)."""
    bf16 = cfg.replace(compute_dtype="bfloat16")
    rows = slice(0, len(batch[0]))
    want = _dp_steps(_model(cfg, weights), cfg, batch, rows)[2]
    rep = _dp_steps(_model(bf16, weights), bf16, batch, rows)[2]
    model = parallel.shard_params_tp(mesh, _model(bf16, weights))
    got = _dp_steps(model, bf16, batch, rows, mesh)[2]
    want, rep = ({n: parallel.shard_of(model, n, g) for n, g in d.items()} for d in (want, rep))
    return _range_gaps(rep, want), _range_gaps(got, want)


def _save_sharded(model):
    """What saving a sharded model gives: each way's error message (or
    "saved"), and the files it left."""
    import tempfile

    from comet_tpu_torch.training import save_checkpoint
    from comet_tpu_torch.utils.serialization import save_params

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, save in (("save_params", lambda: save_params(os.path.join(tmp, "w.pt"), model)),
                           ("save_checkpoint", lambda: save_checkpoint(tmp, 0, {"model": model}))):
            try:
                save()
                out[name] = "saved"
            except ValueError as exc:
                out[name] = str(exc)
        out["files"] = sorted(os.listdir(tmp))
    return out


def _halves_steps(model, cfg, batch):
    """The 2-rank step in one process: rows 0 and 1 each through the
    forward and backward on their own, their gradients averaged as DDP
    averages them, then the optimizer: (each row's losses, the trained
    parameters after)."""
    from comet_tpu_torch.models.comet import encode_gt, pose_loss
    from comet_tpu_torch.training import build_optimizer, camera_only_mask
    from comet_tpu_torch.training.loop import cameras_to

    optimizer, scheduler = build_optimizer(model, **_OPT)
    mask = camera_only_mask(model)
    trained = [(n, p) for n, p in model.named_parameters() if mask[n]]
    losses = []
    for _ in range(STEPS):
        grads, row_losses = [], []
        for r in range(2):
            optimizer.zero_grad(set_to_none=True)
            images, queries, cams = _torch_rows(batch, slice(r, r + 1))
            out = model(images, queries)
            loss = pose_loss(cfg, out["pred_pose_enc"], encode_gt(cfg, cameras_to(cams, "cpu")))
            loss["loss"].backward()
            row_losses.append(loss["loss"].item())
            grads.append([p.grad.clone() for _, p in trained])
        for (_, p), g0, g1 in zip(trained, *grads):
            p.grad = (g0 + g1) / 2
        optimizer.step()
        scheduler.step()
        losses.append(row_losses)
    return losses, {n: p.detach().clone() for n, p in trained}


def _noise_entries(name, shape):
    """The entries whose gradient is zero or below f32 rounding: the key
    part of every in-projection bias (softmax is invariant to a shift of
    all of a query's logits) and the confidence MLP (the context
    LayerNorm undoes its per-track scale; ~1e-8). Two summation orders give
    them unrelated rounding noise, and Adam scales it into steps of up to lr,
    so they are held bit for bit only where the order is the same (the
    ranks against each other, the 2-rank step against its two halves)."""
    noise = torch.zeros(shape, dtype=torch.bool)
    if name.endswith("in_proj_bias"):
        e = shape[0] // 3
        noise[e:2 * e] = True
    if ".confidence_attention." in name:
        noise[...] = True
    return noise


def _fit(model, cfg, root, batch_size, mesh=None):
    """EPOCHS epochs of ``fit_epoch`` on the fixture; the parameters after."""
    from comet_tpu_torch.training import (
        build_optimizer, build_train_step, fit_epoch, process_local_order,
    )
    from comet_tpu_torch.training.data_parallel import replicate_train_state

    ds = _dataset(root, cfg)
    optimizer, scheduler = build_optimizer(model, 1e-3, 2, cfg.train.restart_num, 0.0)
    trained = replicate_train_state(mesh, model, optimizer) if mesh is not None else model
    step = build_train_step(trained, cfg, optimizer, scheduler)
    rng = np.random.default_rng(7)
    steps = []
    for _ in range(EPOCHS):
        order = process_local_order(rng, len(ds), mesh=mesh)
        steps.append(fit_epoch(step, ds, _seed_grid(cfg), batch_size, order,
                               device=None if mesh is not None else "cpu", mesh=mesh))
    return steps, {n: p.detach().clone() for n, p in model.named_parameters()}


def _evaluate(model, cfg, root, mesh=None, eval_batch=1):
    from comet_tpu_torch.training import evaluate

    return evaluate(model, _dataset(root, cfg), cfg, keypoint_backend=_seed_grid(cfg),
                    print_fn=lambda *a: None, mesh=mesh, eval_batch=eval_batch,
                    device=None if mesh is not None else "cpu")


def worker_dp(rank, world, port, out):
    """Two data ranks: the helpers, the train steps, fit_epoch, evaluate;
    then tensor-parallel train steps on a (data 1, model 2) mesh, in f32
    and in bf16."""
    from comet_tpu_torch.ops.corr import build_fmap_pyramid, corr_pyramid_sample
    from comet_tpu_torch.training import RunningStats, process_local_order
    from comet_tpu_torch.training.loop import _merge_process_averages

    _init(rank, world, port)
    mesh = parallel.make_mesh(n_data=world, device="cpu")
    cfg, weights = dryrun_config(), torch.load(os.path.join(out, "weights.pt"))
    res = {"order": torch.from_numpy(process_local_order(np.random.default_rng(0), 10))}
    x = np.random.default_rng(4).normal(size=(world, 4)).astype(np.float32)
    mine = parallel.host_local_put({"x": x}, parallel.data_sharding(mesh))
    res["whole"] = parallel.host_local_put({"x": x}, parallel.replicated(mesh))["x"]
    res["mean"] = parallel.cross_replica_mean(mine, mesh)["x"]
    fmaps, coords, feats = _track_inputs()
    shard = parallel.track_sharding(mesh, dim=2)
    local = corr_pyramid_sample(build_fmap_pyramid(torch.from_numpy(fmaps), 2),
                                shard.local(coords), shard.local(feats), 1)
    res["track"] = shard.gather(local)
    res["losses"], res["params"], res["grads"], _ = _dp_steps(
        _model(cfg, weights), cfg, _train_batch(cfg, world), slice(rank, rank + 1), mesh)
    tp_mesh = parallel.make_mesh(n_data=1, n_model=2, device="cpu")
    res["tp_train"] = {(1, 2): _tp_steps(cfg, weights, tp_mesh, _train_batch(cfg, 2))}
    res["tp_rounding"] = _tp_rounding(cfg, weights, tp_mesh, _train_batch(cfg, 2))
    res["fit_steps"], res["fit_params"] = _fit(_model(cfg, weights), cfg, out, 1, mesh)
    res["eval"] = _evaluate(_model(cfg, weights), cfg, out, mesh)
    stats = RunningStats()
    stats.update({"loss": rank + 1.0, "R_avg": 2.0 * rank, f"Auc_scene_s{rank}": 0.5 + rank})
    if rank == 0:
        stats.update({"loss": 3.0, "R_avg": 0.0})
    res["merged"] = _merge_process_averages(stats, mesh)
    torch.save(res, os.path.join(out, f"dp{rank}.pt"))
    torch.distributed.destroy_process_group()


def _tp_module_inputs(cfg):
    rng = np.random.default_rng(8)
    vit = cfg.camera.backbone_dim
    return {
        "vit attention": torch.from_numpy(rng.normal(size=(3, 5, vit)).astype(np.float32)),
        "trajectory encoder": torch.from_numpy((rng.random((2, 3, 6, 2)) * 60).astype(np.float32)),
        "confidence attention": torch.from_numpy(rng.random((2, 3, 6, 1)).astype(np.float32)),
    }


TP_MODULES = {
    "vit attention": "camera_predictor.backbone.blocks.0.attn",
    "trajectory encoder": "camera_predictor.traj_encoder",
    "confidence attention": "camera_predictor.confidence_attention",
}
TP_ROUTES = ("default", "fused")


def worker_tp(rank, world, port, out):
    """A (data 2, model 2) mesh: the forward of each route, and the modules
    with a column product and no row partner, replicated and sharded; then
    tensor-parallel train steps on (data 1, model 4) and (data 2, model 2)
    meshes."""
    from comet_tpu_torch.config import FUSED_ROUTE, KernelRoute

    _init(rank, world, port)
    mesh = parallel.make_mesh(n_data=2, n_model=2, device="cpu")
    cfg, weights = dryrun_config(), torch.load(os.path.join(out, "weights.pt"))
    images, queries, _ = _train_batch(cfg, 2, seed=9)
    rows = parallel.data_sharding(mesh)
    inputs = _tp_module_inputs(cfg)
    res = {}
    for route_name, route in zip(TP_ROUTES, (KernelRoute(), FUSED_ROUTE)):
        model = _model(cfg, weights, route)
        before = {n: tuple(p.shape) for n, p in model.named_parameters()}
        with torch.no_grad():
            ref = model(torch.from_numpy(images), torch.from_numpy(queries))["pred_pose_enc"]
            mods = {k: model.get_submodule(p)(inputs[k]) for k, p in TP_MODULES.items()}
            parallel.shard_params_tp(mesh, model)
            got = rows.gather(model(*parallel.host_local_put((images, queries), rows))
                              ["pred_pose_enc"])
            mods_tp = {k: model.get_submodule(p)(inputs[k]) for k, p in TP_MODULES.items()}
        res[route_name] = dict(ref=ref, tp=got, modules=mods, modules_tp=mods_tp)
        res["sharded"] = {n: (before[n], tuple(p.shape)) for n, p in model.named_parameters()
                          if tuple(p.shape) != before[n]}
        res["shards"] = {n: p.detach().clone() for n, p in model.named_parameters()
                         if n.endswith("in_proj_weight")}
    meshes = {shape: parallel.make_mesh(n_data=shape[0], n_model=shape[1], device="cpu")
              for shape in ((1, 4), (2, 2))}
    res["tp_train"] = {shape: _tp_steps(cfg, weights, mesh, _train_batch(cfg, 2))
                       for shape, mesh in meshes.items()}
    res["tp_fit"] = _fit(parallel.shard_params_tp(meshes[2, 2], _model(cfg, weights)), cfg, out,
                         1, meshes[2, 2])
    torch.save(res, os.path.join(out, f"tp{rank}.pt"))
    torch.distributed.destroy_process_group()


def worker_cli(argv):
    """A rank of the CLI's ``train --n-devices 2``: the tiny configuration
    and the shared weights patched in (a spawned process does not see the
    test's monkeypatch), and its writes counted."""
    import comet_tpu_torch.config as tcfg
    from comet_tpu_torch import training
    from comet_tpu_torch.training import stats

    weights_path, argv = argv[0], argv[1:]
    torch.set_num_threads(1)
    cfg = dryrun_config().replace(**_CLI_CFG)
    tcfg.get_config = lambda name="ours": cfg
    tcli._init_model = _init_with(torch.load(weights_path))
    counts = {"save_checkpoint": 0, "csv_rows": 0}
    save, log = training.save_checkpoint, stats.CsvLogger.log

    def counted_save(*a, **k):
        counts["save_checkpoint"] += 1
        return save(*a, **k)

    def counted_log(self, *a, **k):
        counts["csv_rows"] += 1
        return log(self, *a, **k)

    rank = argv[argv.index("--process-id") + 1]
    out = argv[argv.index("--output-dir") + 1]
    evaluate = training.evaluate

    def evaluate_and_keep(model, *a, **k):
        # every rank evaluates after each epoch: keep its trained parameters
        mask = training.camera_only_mask(model)
        torch.save({n: p.detach().clone() for n, p in model.named_parameters() if mask[n]},
                   os.path.join(out, f"params_rank{rank}.pt"))
        return evaluate(model, *a, **k)

    training.save_checkpoint = counted_save
    training.evaluate = evaluate_and_keep
    stats.CsvLogger.log = counted_log
    tcli.main(argv)
    with open(os.path.join(out, f"writes_rank{rank}.json"), "w") as f:
        json.dump(counts, f)


def _init_with(weights):
    """The CLI's ``_init_model`` with ``weights`` in place of the seed's."""
    port_init = tcli._init_model

    def init(cfg, seed=0, checkpoint=None, inference=True, device=None):
        model = port_init(cfg, seed, checkpoint, inference=False, device=device)
        if checkpoint is None:
            model.load_state_dict(weights)
        return model

    return init


WORKERS = {"dp": worker_dp, "tp": worker_tp}


# ------------------------------------------------------------- the tests


def _run_group(task, world, out):
    """``world`` ranks of ``task`` over a fresh port; raises with the ranks'
    output if one fails or the group runs past GROUP_TIMEOUT_S."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", task,
                               str(r), str(world), str(port), out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=_REPO)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GROUP_TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{task} rank {r}: exit code {p.returncode}\n{log[-4000:]}"


def _still_tracks(params):
    for tracker in ("coarse_tracker", "fine_tracker"):
        head = params[tracker]["updateformer"]["flow_head"]
        head["kernel"] = np.asarray(head["kernel"]).copy()
        head["bias"] = np.asarray(head["bias"]).copy()
        head["kernel"][..., :2] = 0.0
        head["bias"][:2] = 0.0
    return params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hold_grads(got, want, rel, err):
    """Each gradient within ``rel`` of its tensor's largest |g| (and ``rel``
    relative), leaving out the noise entries of :func:`_noise_entries`."""
    for name, g in want.items():
        keep = ~_noise_entries(name, g.shape)
        w, h = g[keep].to(got[name].dtype), got[name][keep]
        scale = max(w.abs().max().item(), 1e-12) if w.numel() else 0.0
        np.testing.assert_allclose(h.numpy(), w.numpy(), atol=rel * scale, rtol=rel,
                                   err_msg=f"{err} {name}")


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """The weights (a flax tree and the port's state_dict, saved for the
    ranks), the JAX config and an AMD fixture of 4 sequences."""
    import comet_tpu.config as jcfg
    from comet_tpu_torch.data import fixtures
    from comet_tpu_torch.weights import params_from_jax
    from test_torch_port_models import _jax_params, _tiny

    out = str(tmp_path_factory.mktemp("dist"))
    jc, cfg = _tiny(jcfg), dryrun_config()
    s, hw, n = cfg.seqlen, cfg.img_size, cfg.track_num
    params = _still_tracks(_jax_params(jc, np.zeros((1, s, hw, hw, 3), np.float32),
                                       np.full((1, n, 2), hw / 2.0, np.float32), seed=17))
    weights = params_from_jax({"params": params}, cfg)
    torch.save(weights, os.path.join(out, "weights.pt"))
    fixtures.generate_amd_fixture(os.path.join(out, "AMD_train"), n_models=1, n_seqs=4,
                                  n_frames=6, img_hw=(96, 96))
    return dict(out=out, jc=jc, cfg=cfg, params=params, weights=weights)


@pytest.fixture(scope="module")
def dp(shared):
    _run_group("dp", 2, shared["out"])
    return [torch.load(os.path.join(shared["out"], f"dp{r}.pt")) for r in range(2)]


@pytest.fixture(scope="module")
def tp(shared):
    _run_group("tp", 4, shared["out"])
    return [torch.load(os.path.join(shared["out"], f"tp{r}.pt")) for r in range(4)]


def test_worker_config_is_the_parity_config():
    import comet_tpu_torch.config as tcfg
    from test_torch_port_models import _tiny

    assert dryrun_config() == _tiny(tcfg)


@pytest.mark.parametrize("name, ndim, want", [
    ("a.mlp.fc1.weight", 2, ("model", None)),
    ("a.mlp.fc2.weight", 2, (None, "model")),
    ("attn.in_proj_weight", 2, ("model", None)),
    ("attn.out_proj.weight", 2, (None, "model")),
    ("attn.in_proj_bias", 1, ()),
    ("conv1.weight", 4, ()),
], ids=["fc1", "fc2", "in_proj", "out_proj", "bias", "conv"])
def test_spec_rules(name, ndim, want):
    """JAX's cases (tests/test_parallel.py) on the port's names, in the torch
    layout: [out, in], so column-parallel splits dim 0."""
    assert parallel.tensor_parallel_spec(name, ndim) == want


def _jax_sharded(shared, n_model):
    """JAX's shard_params_tp on the shared tree over a (data 2, model
    n_model) mesh of the virtual CPU devices: the port's name of each sharded
    leaf -> its split dimension in the port's layout."""
    import jax

    from comet_tpu.parallel import make_mesh, shard_params_tp
    from comet_tpu_torch.weights import convert_leaf

    mesh = make_mesh(n_data=2, n_model=n_model, devices=jax.devices()[: 2 * n_model])
    placed = shard_params_tp(mesh, shared["params"])
    out = {}
    for path, x in jax.tree_util.tree_leaves_with_path(placed):
        spec = x.sharding.spec
        if "model" not in tuple(spec):
            continue
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        name, _ = convert_leaf(keys, np.zeros(x.shape, np.float32))
        jdim = list(spec).index("model")
        # flax [in, out] -> torch [out, in]: the split dimension flips
        out[name] = x.ndim - 1 - jdim
    return out


def _port_sharded(shared, n_model):
    """The port's rule applied to the same weights: name -> split dimension,
    and the in-projections left replicated by the head-count rule."""
    from comet_tpu_torch.models.blocks import MultiHeadAttention

    model = _model(shared["cfg"], shared["weights"])
    out, by_heads = {}, set()
    for mod_name, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}"
            spec = parallel.tensor_parallel_spec(name, p.dim())
            if "model" not in spec or p.shape[spec.index("model")] % n_model:
                continue
            if isinstance(module, MultiHeadAttention) and module.num_heads % n_model:
                by_heads.add(name)
                continue
            out[name] = spec.index("model")
    return out, by_heads


@pytest.mark.parametrize("n_model", [2, 4])
def test_shard_set_matches_jax(shared, n_model):
    """The parameters the port shards, and their split dimensions, are JAX's
    through the weight bridge's names, except in-projections whose head
    count does not divide by the model axis (the port's head-aligned layout
    keeps them whole)."""
    want = _jax_sharded(shared, n_model)
    got, by_heads = _port_sharded(shared, n_model)
    assert len(got) >= 10
    assert set(got) == set(want) - by_heads
    assert all(got[k] == want[k] for k in got)
    assert all(k.endswith("in_proj_weight") for k in by_heads)


def test_shard_layout(tp, shared):
    """Each sharded weight is its split dimension / 2 on each model rank, and
    an in-projection's shard is the q, k and v rows of the rank's heads."""
    sharded = tp[0]["sharded"]
    assert len(sharded) >= 10
    for name, (whole, mine) in sharded.items():
        dim = parallel.tensor_parallel_spec(name, len(whole)).index("model")
        assert whole[dim] % 2 == 0 and mine[dim] == whole[dim] // 2, name
    for rank in range(4):
        for name, shard in tp[rank]["shards"].items():
            if name not in sharded:
                continue
            w, e = shared["weights"][name].to(shard.dtype), sharded[name][0][1]
            h = rank % 2  # the model rank: ranks 0, 1 and 2, 3 are model groups
            want = torch.cat([part[h * e // 2:(h + 1) * e // 2] for part in w.chunk(3)])
            assert torch.equal(shard, want), (rank, name)


def test_process_local_order_strides(dp):
    """Rank r of 2 takes order[r::2] of one permutation, equal on both."""
    full = np.random.default_rng(0).permutation(10)
    for r in range(2):
        np.testing.assert_array_equal(dp[r]["order"].numpy(), full[r::2])


def test_cross_replica_mean(dp):
    """Each rank's row (host_local_put with the data sharding), averaged over
    the data axis; a replicated put keeps the whole value."""
    x = np.random.default_rng(4).normal(size=(2, 4)).astype(np.float32)
    for r in range(2):
        np.testing.assert_allclose(dp[r]["mean"].numpy(), x.mean(0)[None], atol=1e-6)
        np.testing.assert_array_equal(dp[r]["whole"].numpy(), x)


def test_track_sharding_matches_unsharded_and_jax(dp):
    import jax.numpy as jnp

    from comet_tpu.ops import build_fmap_pyramid as jpyr
    from comet_tpu.ops import corr_pyramid_sample as jsample
    from comet_tpu_torch.ops.corr import build_fmap_pyramid, corr_pyramid_sample

    fmaps, coords, feats = _track_inputs()
    whole = corr_pyramid_sample(build_fmap_pyramid(torch.from_numpy(fmaps), 2),
                                torch.from_numpy(coords), torch.from_numpy(feats), 1)
    want = np.asarray(jsample(jpyr(jnp.asarray(fmaps), 2), jnp.asarray(coords),
                              jnp.asarray(feats), 1))
    for r in range(2):
        np.testing.assert_allclose(dp[r]["track"].numpy(), whole.numpy(), atol=1e-5)
        np.testing.assert_allclose(dp[r]["track"].numpy(), want, atol=1e-5)


@pytest.fixture(scope="module")
def one_process_steps(shared):
    """The same steps in one process on the global batch of 2."""
    cfg = shared["cfg"]
    return _dp_steps(_model(cfg, shared["weights"]), cfg, _train_batch(cfg, 2), slice(0, 2))


def test_dp_step_matches_one_process(dp, one_process_steps):
    """The ranks' mean loss is the batch's, and the gradient DDP averaged is
    the batch's gradient, for every trainable tensor."""
    losses, _, grads, _ = one_process_steps
    np.testing.assert_allclose(np.mean([dp[0]["losses"], dp[1]["losses"]], axis=0), losses,
                               rtol=1e-5)
    for r in range(2):
        assert dp[r]["grads"].keys() == grads.keys()
        _hold_grads(dp[r]["grads"], grads, 1e-5, f"rank {r}")


def test_dp_step_equals_the_two_halves_in_one_process(shared, dp):
    """Against one process that runs the same two batch-1 halves and averages
    their gradients, (g0 + g1) / 2: every loss and every updated parameter
    bit for bit."""
    cfg = shared["cfg"]
    losses, params = _halves_steps(_model(cfg, shared["weights"]), cfg, _train_batch(cfg, 2))
    for r in range(2):
        assert dp[r]["losses"] == [step[r] for step in losses]
        assert dp[r]["params"].keys() == params.keys()
        for name, p in params.items():
            assert torch.equal(dp[r]["params"][name], p), (r, name)
    assert sum(not torch.equal(p, shared["weights"][n]) for n, p in params.items()) > 10


def test_dp_ranks_stay_replicated(dp):
    for name, p in dp[0]["params"].items():
        assert torch.equal(p, dp[1]["params"][name]), name


def _jax_grads(shared, mesh=None):
    """JAX's loss and gradient (build_train_step's loss_fn) on the global
    batch, the batch sharded over ``mesh`` when given, in the port's names."""
    import jax
    import jax.numpy as jnp

    from comet_tpu.geometry import cameras as jcam
    from comet_tpu.models import COMET as JaxCOMET
    from comet_tpu.models.comet import encode_gt, pose_loss
    from comet_tpu_torch.weights import params_from_jax

    jc, cfg = shared["jc"], shared["cfg"]
    images, queries, cams = _train_batch(cfg, 2)
    model = JaxCOMET(jc)
    gt = jcam.CameraSet(**{f: jnp.asarray(cams[f]) for f in jcam.CameraSet._fields})
    images, queries = jnp.asarray(images), jnp.asarray(queries)
    params = {"params": jax.tree_util.tree_map(jnp.asarray, shared["params"])}
    if mesh is not None:
        from comet_tpu.training.data_parallel import shard_train_inputs

        params = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec())), params)
        images, queries, gt = shard_train_inputs(mesh, images, queries, gt)

    @jax.jit
    def loss_and_grad(p, images, queries, gt):
        def loss_fn(p):
            out = model.apply(p, images, queries)
            return pose_loss(jc, out["pred_pose_enc"], encode_gt(jc, gt))["loss"]

        return jax.value_and_grad(loss_fn)(p)

    loss, grads = loss_and_grad(params, images, queries, gt)
    return float(loss), params_from_jax(jax.tree_util.tree_map(np.asarray, grads), cfg)


def _hold_grads_to_jax(dp, loss, grads):
    """The first step's mean loss within 1e-4 relative, and each averaged
    gradient within 1e-4 of its tensor's largest |g| (test_torch_port_train's
    gradient tolerance)."""
    np.testing.assert_allclose(np.mean([dp[0]["losses"][0], dp[1]["losses"][0]]), loss,
                               rtol=1e-4)
    _hold_grads(dp[0]["grads"], {n: grads[n] for n in dp[0]["grads"]}, 1e-4, "JAX")


@pytest.fixture(scope="module")
def jax_grads(shared):
    """comet_tpu's loss and gradient on the global batch (one compile)."""
    return _jax_grads(shared)


def test_dp_step_matches_jax(dp, jax_grads):
    """2 ranks x batch 1 against comet_tpu's loss and gradient on the
    global batch with the same weights."""
    _hold_grads_to_jax(dp, *jax_grads)


@pytest.fixture(scope="module")
def one_process_fit(shared):
    cfg = shared["cfg"]
    return _fit(_model(cfg, shared["weights"]), cfg, shared["out"], 2)


def test_fit_epoch_two_processes_match_one(shared, dp, one_process_fit):
    """2 processes x batch 1 against 1 process with global batch 2, 2 epochs,
    on the AMD fixture (tests/test_multiprocess.py's proof)."""
    steps, params = one_process_fit
    assert steps == [2, 2] and dp[0]["fit_steps"] == dp[1]["fit_steps"] == steps
    moved = 0
    for name, p in params.items():
        assert torch.equal(dp[0]["fit_params"][name], dp[1]["fit_params"][name]), name
        keep = ~_noise_entries(name, p.shape)
        np.testing.assert_allclose(dp[0]["fit_params"][name][keep].numpy(), p[keep].numpy(),
                                   atol=5e-5, err_msg=name)
        moved += not torch.equal(p, shared["weights"][name].to(p.dtype))
    assert moved > 10


def test_fit_epoch_tensor_parallel_matches_one_process(shared, tp, one_process_fit):
    """``fit_epoch(mesh=)`` of a model sharded over a (data 2, model 2) mesh,
    each data rank a batch of one in ``process_local_order(mesh=)``'s order
    (the same on its model ranks), against one process with global batch 2:
    the epochs' steps, and every parameter, reassembled from the model
    ranks' shards, within the data-parallel test's 5e-5."""
    steps, params = one_process_fit
    for r in range(4):
        assert tp[r]["tp_fit"][0] == steps
    for d in range(2):
        group = [2 * d, 2 * d + 1]
        for name, p in params.items():
            got = _whole(name, [tp[r]["tp_fit"][1][name] for r in group], p.shape)
            keep = ~_noise_entries(name, p.shape)
            np.testing.assert_allclose(got[keep].numpy(), p[keep].numpy(), atol=5e-5,
                                       err_msg=f"data rank {d} {name}")


def test_evaluate_mesh_merges_to_one_process(shared, dp):
    cfg = shared["cfg"]
    want = _evaluate(_model(cfg, shared["weights"]), cfg, shared["out"], eval_batch=2)
    for r in range(2):
        got = dp[r]["eval"]
        scenes = {k for k in got if k.startswith("Auc_scene_")}
        # each rank keeps the scenes of its own rows: 0, 2 or 1, 3
        assert len(scenes) == 2
        for k in set(want) - {"sec/it"} - {k for k in want if k.startswith("Auc_scene_")}:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4, err_msg=k)
        for k in scenes:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4, err_msg=k)
    assert {k for k in dp[0]["eval"] if k.startswith("Auc_scene_")}.isdisjoint(
        {k for k in dp[1]["eval"] if k.startswith("Auc_scene_")})


def test_merge_process_averages(dp):
    """Hand-built (sum, count) pairs: rank 0 holds loss 1 and 3 and R_avg 0
    twice, rank 1 loss 2 and R_avg 2; the per-scene keys stay local."""
    for r in range(2):
        got = dp[r]["merged"]
        assert got["loss"] == pytest.approx(2.0) and got["R_avg"] == pytest.approx(2.0 / 3.0)
        assert {k for k in got if k.startswith("Auc_scene")} == {f"Auc_scene_s{r}"}
        assert got[f"Auc_scene_s{r}"] == 0.5 + r


@pytest.mark.parametrize("route", TP_ROUTES)
def test_tp_forward_matches_replicated(tp, route):
    """A (data 2, model 2) mesh: each data rank's rows through the sharded
    model, gathered, against the replicated forward of the whole batch."""
    for r in range(4):
        got, want = tp[r][route]["tp"], tp[r][route]["ref"]
        assert got.shape == want.shape == (2, dryrun_config().seqlen, 7)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=1e-4)


def test_tp_forward_matches_jax(shared, tp):
    import jax
    import jax.numpy as jnp

    from comet_tpu.models import COMET as JaxCOMET

    images, queries, _ = _train_batch(shared["cfg"], 2, seed=9)
    out = jax.jit(JaxCOMET(shared["jc"]).apply)({"params": shared["params"]},
                                                jnp.asarray(images), jnp.asarray(queries))
    want = np.asarray(out["pred_pose_enc"])
    for r in range(4):
        np.testing.assert_allclose(tp[r]["default"]["tp"].numpy(), want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("module", list(TP_MODULES))
@pytest.mark.parametrize("route", TP_ROUTES)
def test_tp_module_without_row_partner(tp, module, route):
    for r in range(4):
        got, want = tp[r][route]["modules_tp"][module], tp[r][route]["modules"][module]
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


# the tensor-parallel train steps: (data, model) mesh -> the group that ran it
TP_TRAIN = {(1, 2): "dp", (1, 4): "tp", (2, 2): "tp"}


def _tp_train(dp, tp, mesh_shape):
    """Each rank's record of the train steps on ``mesh_shape``, and the
    ranks of each model group (rank = data index * n_model + model index)."""
    ranks = dp if TP_TRAIN[mesh_shape] == "dp" else tp
    n_data, n_model = mesh_shape
    groups = [list(range(d * n_model, (d + 1) * n_model)) for d in range(n_data)]
    return [r["tp_train"][mesh_shape] for r in ranks], groups


def _whole(name, parts, shape):
    """A parameter (or its gradient) from its model ranks' shards: an
    in-projection's shards are the q, k and v rows of each rank's heads."""
    if tuple(parts[0].shape) == tuple(shape):
        return parts[0]
    if name.endswith("in_proj_weight"):
        return torch.cat([torch.cat([p.chunk(3)[i] for p in parts]) for i in range(3)])
    return torch.cat(parts, parallel.tensor_parallel_spec(name, len(shape)).index("model"))


def _tp_grads(recs, group, shared):
    return {name: _whole(name, [recs[r]["grads"][name] for r in group],
                         shared["weights"][name].shape) for name in recs[group[0]]["grads"]}


@pytest.mark.parametrize("mesh_shape", list(TP_TRAIN), ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_tp_train_matches_replicated(shared, dp, tp, one_process_steps, mesh_shape):
    """Two steps of a model sharded over the model axis against the same
    steps replicated in one process on the global batch: each data rank's
    loss (their mean at data size 2) within 1e-5 relative, the first step's
    gradient of every camera tensor, reassembled from the model ranks'
    shards, within 1e-5 of its tensor's largest |g|, and the first step's
    global norm within 1e-6 relative. The second step starts from
    parameters that Adam moved apart in the noise entries of
    :func:`_noise_entries` (up to lr each), so its norm is held within 1e-4
    (measured: 1.0e-5 at (data 1, model 2))."""
    losses, _, grads, norms = one_process_steps
    recs, groups = _tp_train(dp, tp, mesh_shape)
    got = np.mean([[recs[g[0]]["losses"]] for g in groups], axis=0)[0]
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    for group in groups:
        whole = _tp_grads(recs, group, shared)
        assert whole.keys() == grads.keys()
        _hold_grads(whole, grads, 1e-5, f"{mesh_shape} ranks {group}")
        for r in group:
            np.testing.assert_allclose(recs[r]["norms"][0], norms[0], rtol=1e-6)
            np.testing.assert_allclose(recs[r]["norms"], norms, rtol=1e-4)
    assert sum(recs[0]["grads"][n].shape != grads[n].shape for n in grads) >= 10


@pytest.mark.parametrize("mesh_shape", list(TP_TRAIN), ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_tp_train_keeps_replicated_params_equal(shared, dp, tp, mesh_shape):
    """After the steps every parameter that is not a shard is bit for bit
    the same on every rank (the clip's norm and the gradients are the same
    on the model ranks, DDP's average on the data ranks), every shard the
    same across the data ranks, the camera parameters moved and no frozen
    tensor; before the steps ``parallel.shard_of`` gave each rank's shard of
    the whole weights."""
    recs, groups = _tp_train(dp, tp, mesh_shape)
    for name, p in recs[0]["params"].items():
        shard = tuple(p.shape) != tuple(shared["weights"][name].shape)
        for group in groups:
            for i, r in enumerate(group):
                want = recs[groups[0][i] if shard else 0]["params"][name]
                assert torch.equal(recs[r]["params"][name], want), (name, r)
    assert not any(rec["frozen_moved"] for rec in recs)
    assert all(rec["shard_of_matches"] for rec in recs)
    moved = sum(not torch.equal(_whole(n, [recs[r]["params"][n] for r in groups[0]],
                                       shared["weights"][n].shape), shared["weights"][n])
                for n in recs[0]["params"])
    assert moved > 10


def test_tp_bf16_adds_no_rounding_of_its_own(dp):
    """In bf16 the (data 1, model 2) step's first-step camera gradients are
    no further from the f32 step than the replicated bf16 step's: the
    median over the tensors of the ratio of the two distances (largest
    |difference| over the range, :func:`_range_gaps`) at most 1. The
    collectives reduce in f32 (``ModelAxis.column``, ``Linear.row``); a copy
    of the code whose row-parallel partial sums and column-parallel input
    gradients are rounded to bf16 before the all-reduce reads 1.09-1.18."""
    for rank, rec in enumerate(dp):
        rep32, tp32 = rec["tp_rounding"]
        ratio = float(np.median([tp32[n] / rep32[n] for n in rep32 if rep32[n] > 0]))
        assert ratio <= 1.0, (rank, ratio)


def test_saving_a_sharded_model_raises(dp):
    """Checkpoints of a tensor-parallel model are out of scope: saving its
    weights or a checkpoint raises, saying to gather first, and writes
    nothing."""
    saving = dp[0]["tp_train"][(1, 2)]["saving"]
    assert saving.pop("files") == []
    for name, message in saving.items():
        assert "gather" in message, name


@pytest.mark.parametrize("mesh_shape", list(TP_TRAIN), ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_tp_train_matches_jax(shared, dp, tp, jax_grads, mesh_shape):
    """The reassembled first-step gradients against comet_tpu's loss and
    gradient on the global batch (build_train_step's loss_fn), within the
    1e-4 rule of the data-parallel step."""
    loss, grads = jax_grads
    recs, groups = _tp_train(dp, tp, mesh_shape)
    np.testing.assert_allclose(np.mean([recs[g[0]]["losses"][0] for g in groups]), loss,
                               rtol=1e-4)
    whole = _tp_grads(recs, groups[0], shared)
    _hold_grads(whole, {n: grads[n] for n in whole}, 1e-4, f"JAX {mesh_shape}")


@pytest.fixture(scope="module")
def cli_runs(shared, tmp_path_factory):
    """``train`` on one process with global batch 2, and as 2 local ranks
    (``--n-devices 2``, which runs 2 ``--coordinator`` processes of this
    file's CLI worker)."""
    import comet_tpu_torch.config as tcfg
    from comet_tpu_torch.data import fixtures

    root = str(tmp_path_factory.mktemp("cli"))
    kw = dict(n_models=1, n_frames=_CLI_CFG["seqlen"], img_hw=(96, 96))
    fixtures.generate_amd_fixture(os.path.join(root, "AMD_train"), n_seqs=4, seed=1, **kw)
    fixtures.generate_amd_fixture(os.path.join(root, "AMD_eval"), n_seqs=2, seed=2, **kw)
    cfg = shared["cfg"].replace(**_CLI_CFG)
    weights = os.path.join(shared["out"], "weights.pt")
    common = ["train", "--data-root", root, *_GRID, "--device", "cpu", "--epochs", str(EPOCHS),
              "--global-batch", "2", "--ckpt-interval", "1", "--eval-interval", "1"]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tcfg, "get_config", lambda name="ours": cfg)
        mp.setattr(tcli, "_init_model", _init_with(shared["weights"]))
        mp.setattr(tcli, "RANK_COMMAND", (os.path.abspath(__file__), "--worker", "cli", weights))
        one, two = os.path.join(root, "one"), os.path.join(root, "two")
        tcli.main(common + ["--output-dir", one])
        tcli.main(common + ["--output-dir", two, "--n-devices", "2"])
        # windowed: sequences of 6 frames in windows of 4, one per rank
        win_root, win = os.path.join(root, "long"), os.path.join(root, "windowed")
        kw["n_frames"] = 6
        fixtures.generate_amd_fixture(os.path.join(win_root, "AMD_train"), n_seqs=2, seed=3, **kw)
        fixtures.generate_amd_fixture(os.path.join(win_root, "AMD_eval"), n_seqs=2, seed=4, **kw)
        tcli.main(["train", "--data-root", win_root, *_GRID, "--device", "cpu", "--epochs", "1",
                   "--windowed", "--train-seq-len", "6", "--ckpt-interval", "1",
                   "--eval-interval", "1", "--n-devices", "2", "--output-dir", win])
    finally:
        mp.undo()
    return dict(one=one, two=two, windowed=win, cfg=cfg)


def _final_weights(out):
    state = torch.load(os.path.join(out, "ckpt", f"ckpt_{EPOCHS - 1:06d}", "state.pt"))
    return state["model"]


def test_cli_two_ranks_match_one_process(cli_runs):
    a, b = _final_weights(cli_runs["one"]), _final_weights(cli_runs["two"])
    assert a.keys() == b.keys()
    for name in a:
        np.testing.assert_allclose(b[name].numpy(), a[name].numpy(), atol=5e-5, err_msg=name)


def test_cli_rank0_writes_once(cli_runs):
    import csv

    two = cli_runs["two"]
    with open(os.path.join(two, "writes_rank0.json")) as f:
        assert json.load(f) == {"save_checkpoint": EPOCHS, "csv_rows": EPOCHS}
    with open(os.path.join(two, "writes_rank1.json")) as f:
        assert json.load(f) == {"save_checkpoint": 0, "csv_rows": 0}
    assert sorted(os.listdir(os.path.join(two, "ckpt"))) == sorted(
        os.listdir(os.path.join(cli_runs["one"], "ckpt")))
    with open(os.path.join(two, "train_results.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == [str(e) for e in range(EPOCHS)]
    assert all(np.isfinite(float(r["loss"])) and np.isfinite(float(r["R_avg"])) for r in rows)
    _hold_ranks_equal(two)


def test_cli_windowed_two_ranks(cli_runs):
    """``train --windowed --n-devices 2``: each rank chains its own sequence,
    DDP averages the two chains' gradients (the model is called once per
    window before one backward), rank 0 writes."""
    import csv

    win = cli_runs["windowed"]
    with open(os.path.join(win, "writes_rank0.json")) as f:
        assert json.load(f) == {"save_checkpoint": 1, "csv_rows": 1}
    with open(os.path.join(win, "writes_rank1.json")) as f:
        assert json.load(f) == {"save_checkpoint": 0, "csv_rows": 0}
    with open(os.path.join(win, "train_results.csv")) as f:
        (row,) = list(csv.DictReader(f))
    assert np.isfinite(float(row["loss"])) and float(row["tf_ratio"]) == 1.0
    assert os.path.exists(os.path.join(win, "ckpt", "best.pt"))
    _hold_ranks_equal(win)


def _hold_ranks_equal(out):
    """The two ranks' camera parameters after training, bit for bit (JAX's
    windowed multi-process training lets them part: ROADMAP Queue 3)."""
    a, b = (torch.load(os.path.join(out, f"params_rank{r}.pt")) for r in range(2))
    assert a.keys() == b.keys() and len(a) > 10
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("world, batch, n_seqs, message", [
    (2, 3, 4, "must be divisible by the process count 2"),
    (2, 4, 2, r"dataset shard \(1 sequences/process\) smaller than the per-process batch 2"),
], ids=["indivisible batch", "shard smaller than batch"])
def test_cli_system_exit(tmp_path, world, batch, n_seqs, message):
    """JAX's SystemExit cases of multi-process training, raised before the
    model is built (one process of a world of 2, whose rendezvous is
    stubbed)."""
    from comet_tpu_torch.data import fixtures

    fixtures.generate_amd_fixture(str(tmp_path / "AMD_train"), n_models=1, n_seqs=n_seqs,
                                  n_frames=4, img_hw=(96, 96))
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(parallel, "init_distributed", lambda *a, **k: torch.device("cpu"))
        mp.setattr(torch.distributed, "get_world_size", lambda *a: world)
        mp.setattr(torch.distributed, "get_rank", lambda *a: 0)
        with pytest.raises(SystemExit, match=message):
            tcli.main(["train", "--data-root", str(tmp_path), "--device", "cpu",
                       "--global-batch", str(batch), "--coordinator", "localhost:1",
                       "--num-processes", str(world), "--process-id", "0"])
    finally:
        mp.undo()


def test_dryrun_multichip_matches_one_process(capsys):
    loss = dryrun_multichip(2, device="cpu", timeout_s=GROUP_TIMEOUT_S)
    assert np.isfinite(loss)
    assert "dryrun_multichip(2): OK" in capsys.readouterr().out


def test_a_cuda_mesh_without_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh(n_data=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh(n_data=1, device="cuda")


def test_nccl_for_more_ranks_than_cards_raises(monkeypatch):
    """Rank 1 of 2 on a machine of one card: both counts named, nothing
    joined."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"rank 1 needs CUDA card 1, and this machine has 1"):
        parallel.init_distributed("localhost:1", 2, 1, device="cuda", backend="nccl")
    with pytest.raises(RuntimeError, match=r"--n-devices 2: one rank per card, and this machine "
                                           r"has 1 CUDA card"):
        tcli._spawn_local_ranks(argparse.Namespace(device="cuda", command="train", argv=[]), 2, 2)
    with pytest.raises(RuntimeError, match=r"dryrun_multichip\(2\): one rank per card, and "
                                           r"this machine has 1"):
        dryrun_multichip(2, device="cuda")


@pytest.mark.slow
def test_dp_step_matches_jax_mesh_step(shared, dp):
    """The port's 2-rank step against comet_tpu's loss and gradient on a
    make_mesh(n_data=2) mesh of the conftest's virtual CPU devices."""
    import jax

    from comet_tpu.parallel import make_mesh

    _hold_grads_to_jax(dp, *_jax_grads(shared, make_mesh(n_data=2, devices=jax.devices()[:2])))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"] and sys.argv[2] == "cli":
        worker_cli(sys.argv[3:])
    elif sys.argv[1:2] == ["--worker"]:
        task, rank, world, port, out = sys.argv[2:7]
        WORKERS[task](int(rank), int(world), int(port), out)
    else:
        sys.exit("usage: test_torch_port_distributed.py --worker dp|tp RANK WORLD PORT DIR | "
                 "--worker cli WEIGHTS ARGV...")
