"""Entry points: the full model as a function of its parameters, and the
multi-device train-step dry run.

Counterpart of ``__graft_entry__.py``. ``entry``: ``fn(params, images,
queries)`` is ``torch.func.functional_call`` of the model, and ``params``
holds zeros of every parameter's and buffer's shape, as the JAX entry
builds them; the model itself is built on the meta device and holds no
memory. ``dryrun_multichip``: one data-parallel train step at a tiny
configuration over several ranks, held against one process's step on the
same global batch. ``python -m comet_tpu_torch.entry --dryrun-rank ...``
is the rank's side of it.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .config import CometConfig, KernelRoute, get_config
from .device import resolve_device
from .models import build_comet


def entry(
    cfg: Optional[CometConfig] = None, device=None, route: KernelRoute = KernelRoute(),
) -> Tuple[Callable, Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]]:
    """(fn, (params, images, queries)) for the forward of ``cfg`` (default:
    the full ``ours`` configuration) on ``device`` (the card by default):
    images [1, S, H, W, 3] ~ N(0, 1) and queries [1, N, 2] uniform in the
    image's inner part, from seed 0."""
    device = resolve_device(device, "entry")
    cfg = cfg or get_config("ours")
    model = build_comet(cfg, device="meta", route=route)
    params = {name: torch.zeros(t.shape, dtype=t.dtype, device=device)
              for name, t in (*model.named_parameters(), *model.named_buffers())}
    gen = torch.Generator(device=device).manual_seed(0)
    images = torch.randn(1, cfg.seqlen, cfg.img_size, cfg.img_size, 3, generator=gen,
                         device=device)
    queries = torch.rand(1, cfg.track_num, 2, generator=gen, device=device) * (
        cfg.img_size - 64) + 32

    def fn(params, images, queries):
        return torch.func.functional_call(model, params, (images, queries))

    return fn, (params, images, queries)


# the dry run's tolerance between the sharded and the single-process step:
# the ranks' mean of per-rank gradients and one batch's gradient add in
# other orders (JAX's tests/test_parallel.py holds its mesh step to the same)
DRYRUN_RTOL = DRYRUN_ATOL = 1e-5


def dryrun_config() -> CometConfig:
    """The dry run's tiny configuration (``__graft_entry__``'s): the real
    architecture at small shapes, in f32."""
    from .config import CameraConfig, TrackerConfig

    return get_config("ours").replace(
        seqlen=2, img_size=64, track_num=8, compute_dtype="float32",
        tracker=TrackerConfig(
            coarse_stride=4, coarse_down_ratio=2, coarse_corr_levels=2, coarse_corr_radius=2,
            coarse_latent_dim=16, coarse_hidden_size=32, coarse_depth=2, coarse_iters=2,
            fine_corr_levels=3, fine_corr_radius=2, fine_latent_dim=8, fine_hidden_size=16,
            fine_depth=2, fine_iters=2, fine_pradius=7, fine_sradius=2,
        ),
        camera=CameraConfig(
            hidden_size=32, num_heads=2, att_depth=1, trunk_depth=1, down_size=28,
            backbone_depth=2, backbone_dim=32, backbone_heads=2,
        ),
    )


def _dryrun_batch(cfg: CometConfig, b: int, device):
    """The global batch of b rows, from numpy's generator of seed 0."""
    from .geometry.cameras import CameraSet

    rng = np.random.default_rng(0)
    s, hw, n = cfg.seqlen, cfg.img_size, cfg.track_num
    images = rng.normal(size=(b, s, hw, hw, 3)).astype(np.float32)
    queries = (rng.random((b, n, 2)) * (hw - 20) + 10).astype(np.float32)
    q = rng.normal(size=(b, s, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t_uvz = rng.normal(size=(b, s, 3)).astype(np.float32)
    t_uvz[..., 2] = np.abs(t_uvz[..., 2]) + 2.0
    cams = CameraSet(q=q, t_xyz=rng.normal(size=(b, s, 3)).astype(np.float32), t_uvz=t_uvz,
                     focal=np.ones((b, s, 2), np.float32), pp=np.zeros((b, s, 2), np.float32),
                     ratio=np.full((b,), 0.5, np.float32))
    as_t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return as_t(images), as_t(queries), CameraSet(*(as_t(f) for f in cams))


def _dryrun_step(cfg: CometConfig, device, rows: slice, n_rows: int, mesh=None):
    """One train step of the seed-0 model on ``rows`` of the global batch
    of ``n_rows``: (loss, the trained parameters after the step)."""
    from .training import build_optimizer, build_train_step
    from .training.data_parallel import replicate_train_state

    model = build_comet(cfg, device=device, seed=0)
    optimizer, scheduler = build_optimizer(model, steps_per_epoch=1)
    trained = replicate_train_state(mesh, model, optimizer) if mesh is not None else model
    step = build_train_step(trained, cfg, optimizer, scheduler)
    images, queries, cams = _dryrun_batch(cfg, n_rows, device)
    aux = step(images[rows], queries[rows], type(cams)(*(f[rows] for f in cams)))
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    params = {n: p.detach().cpu() for n, p in model.named_parameters() if id(p) in held}
    return aux["loss"].detach(), params


def dryrun_multichip(n_devices: int, device=None, timeout_s: float = 900.0) -> float:
    """One data-parallel train step at :func:`dryrun_config` over
    ``n_devices`` ranks, one process each (NCCL over cards 0 .. n-1 by
    default; gloo with ``device="cpu"``), each on its row of a global batch
    of ``n_devices``; then the same step in this process on the whole batch.
    The loss (the ranks' mean) and every updated parameter must agree within
    ``DRYRUN_RTOL`` / ``DRYRUN_ATOL``, not only be finite. Returns the
    loss."""
    from .parallel.launch import free_port, run_local_ranks

    device = resolve_device(device, "dryrun_multichip")
    if device.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"dryrun_multichip({n_devices}): one rank per card, and this machine "
                           f"has {torch.cuda.device_count()} CUDA card(s)")
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        # run from the directory that holds this package, which ``-m`` puts
        # on the ranks' path
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        run_local_ranks([[sys.executable, "-m", "comet_tpu_torch.entry", "--dryrun-rank", str(r),
                          str(n_devices), str(port), device.type, tmp]
                         for r in range(n_devices)], timeout_s=timeout_s, cwd=root)
        sharded = torch.load(os.path.join(tmp, "rank0.pt"))
    cfg = dryrun_config()
    loss, params = _dryrun_step(cfg, device, slice(None), n_devices)
    loss = float(loss)
    worst = 0.0
    if not np.isclose(sharded["loss"], loss, rtol=DRYRUN_RTOL, atol=0):
        raise AssertionError(f"dryrun_multichip({n_devices}): loss {sharded['loss']} over the "
                             f"ranks, {loss} in one process")
    for name, p in params.items():
        q = sharded["params"][name]
        worst = max(worst, (q - p).abs().max().item())
        if not torch.allclose(q, p, rtol=DRYRUN_RTOL, atol=DRYRUN_ATOL):
            raise AssertionError(f"dryrun_multichip({n_devices}): {name} differs from one "
                                 f"process's step by {(q - p).abs().max().item():.3e}")
    print(f"dryrun_multichip({n_devices}): OK, loss={loss:.4f}, {len(params)} updated tensors "
          f"equal one process's step (max |diff| {worst:.2e})")
    return loss


def _dryrun_rank(rank: int, world: int, port: int, device_type: str, out_dir: str) -> None:
    """One rank of :func:`dryrun_multichip`: its step on its row, averaged
    over the ranks; rank 0 saves the mean loss and the updated parameters."""
    from .parallel import cross_replica_mean, init_distributed, make_mesh

    torch.set_num_threads(1)
    device = init_distributed(f"localhost:{port}", world, rank, device=device_type)
    mesh = make_mesh(n_data=world, device=device_type)
    loss, params = _dryrun_step(dryrun_config(), device, slice(rank, rank + 1), world, mesh)
    loss = float(cross_replica_mean(loss, mesh))
    if rank == 0:
        torch.save({"loss": loss, "params": params}, os.path.join(out_dir, "rank0.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    parser = argparse.ArgumentParser("comet_tpu_torch.entry")
    parser.add_argument("--dryrun-rank", nargs=5, required=True,
                        metavar=("RANK", "WORLD", "PORT", "DEVICE", "DIR"))
    a = parser.parse_args()
    r, w, port, dev, out = a.dryrun_rank
    _dryrun_rank(int(r), int(w), int(port), dev, out)
