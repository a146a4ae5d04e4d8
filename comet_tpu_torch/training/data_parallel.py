"""Batched and data-parallel training: stacking samples, the train epoch,
the replicated train state, and the asynchronous metric fetch.

Counterpart of ``comet_tpu/training/data_parallel.py``
(``stack_camera_sets``, ``build_batch``, ``replicate_train_state``,
``shard_train_inputs``, ``start_metric_fetch``, ``batch_metrics``,
``fit_epoch``, ``process_local_order``). JAX replicates the state over a
mesh and lets XLA insert the gradient psum; here each rank of the mesh's
data axis is one process with its own rows of the batch, the state is
broadcast from data-rank 0, and ``DistributedDataParallel`` averages the
gradients during ``backward()``, so the optimizer's global-norm clip sees
the averaged gradients, as JAX's clip does after its psum.

The metric fetch is asynchronous: :func:`start_metric_fetch` queues the
copies of the few tensors the metric block reads into pinned host buffers
and records a CUDA event, so a caller that dispatches the next step before
reading them hides the copies behind the card's work; :meth:`MetricFetch.wait`
waits on that event only, not on the whole device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.datasets import SequenceSample
from ..data.device_pipeline import wait_ready
from ..device import resolve_device
from ..geometry.cameras import CameraSet
from ..parallel.mesh import DATA, broadcast_tensors, mesh_device, replicate_params, shard_batch
from .loop import METRIC_FETCH_KEYS, make_gt_cameras, metric_block
from .optim import camera_only_mask


def stack_camera_sets(cams: Sequence[CameraSet], device=None) -> CameraSet:
    """[CameraSet([S, ...])] * B -> CameraSet([B, S, ...]) of tensors on
    ``device`` (ratio -> [B])."""
    return CameraSet(*(torch.as_tensor(np.stack([np.asarray(f) for f in fields]), device=device)
                       for fields in zip(*cams)))


def build_batch(
    samples: Sequence[SequenceSample],
    queries: Sequence[np.ndarray],
    device,
) -> Tuple[torch.Tensor, torch.Tensor, CameraSet, List[CameraSet]]:
    """Stack host samples into one batch on ``device``.

    Returns (images [B,S,H,W,3], queries [B,N,2], batched gt CameraSet,
    per-sample gt CameraSets with numpy leaves for the host metric block).
    Images already on the card (``DevicePreprocessDataset`` with
    ``keep_on_device``) stack there, after their stream's event, and never
    pass through the host."""
    for s in samples:
        wait_ready(s)
    if all(isinstance(s.images, torch.Tensor) for s in samples):
        images = torch.stack([s.images.to(device) for s in samples])
    else:
        images = torch.as_tensor(np.stack([np.asarray(s.images) for s in samples]), device=device)
    q = torch.as_tensor(np.stack(queries), device=device)
    gt_list = [make_gt_cameras(s) for s in samples]
    return images, q, stack_camera_sets(gt_list, device), gt_list


def replicate_train_state(mesh, model: torch.nn.Module,
                          optimizer: Optional[torch.optim.Optimizer] = None):
    """Make every data rank's parameters, buffers and optimizer state data-rank
    0's (a broadcast) and return ``model`` wrapped in
    ``DistributedDataParallel`` over the data group; ``build_train_step``
    then closes over the wrapped model, which averages the gradients over
    the ranks during ``backward()``.

    The parameters the optimizer does not train (the frozen tracker and ViT,
    which keep ``requires_grad`` but run under no_grad) are left out of
    DDP's reduction, so it neither moves them nor waits for their gradients;
    ``requires_grad`` itself is left as it is, since it changes how
    ``aten.matmul`` folds a one-column product. Every trained parameter
    then gets a gradient each step in every preset (the loss reaches the
    whole camera predictor); one that did not would make DDP raise at the
    next step, not wait."""
    from torch.nn.parallel import DistributedDataParallel

    replicate_params(mesh, model)
    trained = camera_only_mask(model)
    if optimizer is not None:
        held = [p for group in optimizer.param_groups for p in group["params"]]
        held_ids = {id(p) for p in held}
        trained = {n: id(p) in held_ids for n, p in model.named_parameters()}
        # in parameter order, the same on every rank
        broadcast_tensors([v for p in held for v in optimizer.state.get(p, {}).values()
                           if isinstance(v, torch.Tensor)], mesh)
    ignored = [n for n, p in model.named_parameters() if not (trained[n] and p.requires_grad)]
    DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(model, ignored)
    return DistributedDataParallel(model, process_group=mesh.get_group(DATA))


def shard_train_inputs(mesh, images, queries, gt_cams: CameraSet):
    """This rank's rows of every train-step input, on its device (each rank
    passes its own rows, as in multi-process JAX)."""
    return shard_batch(mesh, (images, queries, gt_cams))


def _host_local_view(x):
    """The rows of a step output that live on this rank: a DTensor's local
    shard; every other tensor of the port is process-local already."""
    to_local = getattr(x, "to_local", None)
    return to_local() if to_local is not None else x


class MetricFetch:
    """The metric keys of one step on their way to the host: ``host`` holds
    the tensors (pinned buffers being filled on the card's stream, or the
    step's own CPU tensors), ``ready`` the CUDA event after the copies
    (None on the CPU)."""

    def __init__(self, host: Dict[str, torch.Tensor], ready: Optional[torch.cuda.Event]):
        self.host = host
        self.ready = ready

    def wait(self) -> Dict[str, np.ndarray]:
        """The keys as numpy arrays, once their copies are done."""
        if self.ready is not None:
            self.ready.synchronize()
        return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                for k, v in self.host.items()}


def start_metric_fetch(aux: Dict[str, torch.Tensor]) -> MetricFetch:
    """Begin the device-to-host copy of the ``METRIC_FETCH_KEYS`` of a step's
    output without blocking: each copies ``non_blocking`` into a pinned host
    buffer on the current stream, then one event is recorded."""
    out = {k: _host_local_view(aux[k]).detach() for k in METRIC_FETCH_KEYS if k in aux}
    on_card = [v for v in out.values() if v.device.type == "cuda"]
    if not on_card:
        return MetricFetch(out, None)
    host = {}
    for k, v in out.items():
        if v.device.type == "cuda":
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
        else:
            host[k] = v
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(on_card[0].device))
    return MetricFetch(host, ready)


def batch_metrics(
    fetch: MetricFetch, gt_list: Sequence[CameraSet],
    seq_names: Optional[Sequence[str]] = None,
) -> List[Dict[str, float]]:
    """Per-sample host metric rows from a batched step's fetched metrics.

    Pairwise metrics must not mix frames across sequences, so the batch is
    sliced per sample before the float64 metric block. ``seq_names`` adds
    the per-scene AUC keys."""
    aux = fetch.wait()
    rows = []
    for b, gt in enumerate(gt_list):
        sample_out = {k: (v[b] if v.ndim >= 2 else v) for k, v in aux.items()}
        name = seq_names[b] if seq_names else ""
        rows.append(metric_block(sample_out, gt, name))
    return rows


def fit_epoch(
    train_step: Callable,
    dataset,
    seed_fn: Callable[[SequenceSample], np.ndarray],
    batch_size: int,
    order: np.ndarray,
    device=None,
    mesh=None,
    on_metrics: Optional[Callable[[int, List[Dict[str, float]]], None]] = None,
) -> int:
    """One epoch of ``train_step`` (:func:`~.loop.build_train_step`'s) over
    full batches of ``order`` (this process's sample order; the remainder
    is dropped); returns the number of steps. The model and optimizer hold
    the state. Samples are loaded and seeded on a prefetch thread; step i's
    metrics are copied to the host as it is issued and handed to
    ``on_metrics(i, rows)`` after step i + 1 has been issued, so the copies
    and the float64 metric block hide behind the card's work.

    With a ``mesh``, ``train_step`` is built on :func:`replicate_train_state`'s
    model, ``batch_size`` is this rank's share of the global batch, and the
    batches go to the rank's device. The data ranks agree on the number of
    steps (the least of theirs), as every step's gradient reduction needs
    all of them; ``process_local_order``'s strides differ by one where the
    data does not divide."""
    from ..data.prefetch import prefetch

    if mesh is not None:
        mine = mesh_device(mesh)
        if device is not None and torch.device(device) != mine:
            raise ValueError(f"fit_epoch: device {device}, and this rank's mesh device is {mine}")
        device = mine
    device = resolve_device(device, "fit_epoch")
    n_steps = len(order) // batch_size
    if mesh is not None:
        n_steps = agreed_steps(mesh, n_steps)

    def produce(i: int):
        samples = [dataset[int(j)] for j in order[i * batch_size:(i + 1) * batch_size]]
        return samples, [seed_fn(s) for s in samples]

    pending = None  # (step, metric fetch, gt) awaiting the metric block
    for i, (samples, queries) in enumerate(prefetch(produce, n_steps)):
        images, q, gt_b, gt_list = build_batch(samples, queries, device)
        if mesh is not None:
            images, q, gt_b = shard_train_inputs(mesh, images, q, gt_b)
        aux = train_step(images, q, gt_b)
        if on_metrics is None:
            continue
        fetch = start_metric_fetch(aux)
        if pending is not None:
            on_metrics(pending[0], batch_metrics(*pending[1:]))
        pending = (i, fetch, gt_list)
    if pending is not None:
        on_metrics(pending[0], batch_metrics(*pending[1:]))
    return n_steps


def agreed_steps(mesh, n_steps: int) -> int:
    """The least of every data rank's ``n_steps`` (an all-reduce)."""
    t = torch.tensor([n_steps], device=mesh_device(mesh))
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MIN, group=mesh.get_group(DATA))
    return int(t.item())


def process_local_order(rng: np.random.Generator, n: int, shuffle: bool = True) -> np.ndarray:
    """This process's stride over a shuffled epoch order (the deterministic
    DistributedSampler): process r of w sees ``order[r::w]``, from the
    ``torch.distributed`` group when one is initialized (else 0 of 1).
    Every process draws from an identically seeded ``rng``, so the global
    permutation agrees."""
    order = rng.permutation(n) if shuffle else np.arange(n)
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return order[torch.distributed.get_rank()::torch.distributed.get_world_size()]
    return order
