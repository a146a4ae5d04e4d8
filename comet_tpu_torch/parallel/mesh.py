"""The (data, model) mesh over ``torch.distributed``: process groups, batch
and track sharding, replication, and the tensor-parallel rules.

Counterpart of ``comet_tpu/parallel/mesh.py``. JAX builds one mesh over the
devices of one process and lets GSPMD insert the collectives. PyTorch runs
one process per device, so here the mesh is a ``DeviceMesh`` over the ranks
of a ``torch.distributed`` group, with the dimensions ``("data", "model")``
(rank = data index * n_model + model index, JAX's device order), and the
collectives are explicit:

- "data": batch sharding. Each rank passes its own rows (multi-process JAX's
  ``make_array_from_process_local_data``); parameters are broadcast from
  data-rank 0, and DDP averages the gradients (``training.data_parallel``).
- "model": Megatron tensor parallelism for the transformer weights.
  :func:`shard_params_tp` keeps each rank's slice of the weights the rules
  name, and the modules compute on it (``models/blocks.py``): a
  column-parallel product gives this rank's output features, a row-parallel
  one takes its input features and sums over the model group. The
  collectives differentiate (``ModelAxis``), so a sharded model trains:
  DDP over the data group averages each shard's gradient, and the
  optimizer's global-norm clip sums the shards' squares over the model
  group (``training.optim``).
- the track axis: :func:`track_sharding` splits it over the data ranks, the
  sequence-parallel analog for one long sequence.

The backend follows the device, NCCL on the card and gloo on the CPU, unless
the caller names one (two ranks sharing one card need gloo: NCCL refuses
them). Nothing falls back by itself: a card that is not there, or a rank
without a card of its own, raises.

One storage layout differs from JAX's on purpose. JAX splits
``in_proj_kernel`` [E, 3E] contiguously over its 3E columns, across the
q|k|v boundaries, which is harmless under GSPMD, which only stores it so.
A Megatron compute needs each rank's q, k and v rows of the same heads, so
the port's ``in_proj_weight`` [3E, E] shard is the q, k and v rows of this
rank's heads, stacked, and the module stays replicated unless its head
count divides by the model axis as well as its width does.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device

DATA, MODEL = "data", "model"
# seconds a rendezvous or a collective may wait before it raises
DEFAULT_TIMEOUT_S = 300


def default_backend(device: torch.device) -> str:
    """NCCL on the card, gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def _cuda_device(device: torch.device, rank: int, what: str) -> torch.device:
    """``device`` with its index: as given, else the card of ``rank``, which
    must exist."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = rank if device.index is None else device.index
    if index >= n:
        raise RuntimeError(f"{what}: rank {rank} needs CUDA card {index}, and this machine has "
                           f"{n} card(s); run at most {n} rank(s) per machine, one per card")
    return torch.device("cuda", index)


def init_distributed(coordinator: str, num_processes: int, process_id: int, device=None,
                     backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group of ``num_processes`` processes at
    ``tcp://coordinator`` as rank ``process_id`` (``jax.distributed.initialize``'s
    counterpart). Returns this rank's device: on the card (the default),
    card ``process_id`` unless ``device`` names one (``cuda:K``, as each
    process of a group over several machines names its own), made current.
    ``backend`` defaults to the device's; a failed rendezvous raises after
    ``timeout_s``."""
    device = resolve_device(device, "init_distributed")
    backend = backend or default_backend(device)
    if device.type == "cuda":
        device = _cuda_device(device, process_id, "init_distributed")
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError(f"init_distributed: the nccl backend needs a CUDA device, not {device}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return device


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None):
    """A (data, model) ``DeviceMesh`` over every rank of the process group
    (``init_device_mesh``); ``n_data`` defaults to world size / n_model, and
    the mesh must hold every rank. ``device``: the ranks' device type (the
    card by default)."""
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device, "make_mesh")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: a CUDA mesh was asked for, and there is no CUDA device")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call init_distributed first")
    world = dist.get_world_size()
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"make_mesh: a {n_data} x {n_model} mesh does not hold the {world} ranks")
    return init_device_mesh(device.type, (n_data, n_model), mesh_dim_names=(DATA, MODEL))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _first_rank(group) -> int:
    return dist.get_process_group_ranks(group)[0]


def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists, tuples and named tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(x, device=device)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a value lies over the mesh: dimension ``dim`` split evenly over
    the data axis, rank i of the data group holding chunk i, or (``dim``
    None) replicated, every rank holding all of it. JAX's ``NamedSharding``
    over the data axis."""

    mesh: Any
    dim: Optional[int] = None

    @property
    def device(self) -> torch.device:
        return mesh_device(self.mesh)

    def local(self, x) -> torch.Tensor:
        """This rank's part of the whole value ``x``, on its device."""
        x = _as_tensor(x, self.device)
        if self.dim is None:
            return x
        n = self.mesh.size(0)
        if x.shape[self.dim] % n:
            raise ValueError(f"Sharding: dimension {self.dim} of {tuple(x.shape)} does not split "
                             f"over {n} data ranks")
        return x.chunk(n, self.dim)[self.mesh.get_local_rank(DATA)].contiguous()

    def gather(self, x_local: torch.Tensor) -> torch.Tensor:
        """The whole value from every rank's part (an all-gather over the data
        group); a replicated value is its own whole."""
        if self.dim is None:
            return x_local
        group = self.mesh.get_group(DATA)
        parts = [torch.empty_like(x_local) for _ in range(self.mesh.size(0))]
        dist.all_gather(parts, x_local.contiguous(), group=group)
        return torch.cat(parts, self.dim)


def data_sharding(mesh) -> Sharding:
    """The leading (batch) dimension split over the data axis."""
    return Sharding(mesh, 0)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, None)


def track_sharding(mesh, dim: int = 1) -> Sharding:
    """The track axis (dim 1 of queries [B, N, 2]; ``dim`` 2 for [B, S, N, ...])
    split over the data axis: the sequence-parallel analog for one long
    sequence. ``Sharding.gather`` reassembles it."""
    return Sharding(mesh, dim)


def host_local_put(x: Any, sharding: Sharding) -> Any:
    """This rank's part of a value every rank holds whole (a tree of
    tensors or arrays): the whole value for a replicated sharding, this
    rank's chunk for a split one, on the rank's device."""
    return _tree_map(sharding.local, x)


def shard_batch(mesh, batch: Any) -> Any:
    """This rank's rows of the global batch on its device: as multi-process
    JAX, each rank passes its LOCAL batch (its ``process_local_order``
    slice), and the global batch is the concatenation over the data ranks
    (the DistributedSampler semantics of the reference)."""
    device = mesh_device(mesh)
    return _tree_map(lambda x: _as_tensor(x, device), batch)


def _tensors(obj) -> list:
    if isinstance(obj, nn.Module):
        return [*obj.parameters(), *obj.buffers()]
    out = []
    _tree_map(lambda x: out.append(x) if isinstance(x, torch.Tensor) else None, obj)
    return out


@torch.no_grad()
def broadcast_tensors(tensors, mesh, axis: str = DATA) -> None:
    """Overwrite every tensor with its value on rank 0 of this rank's group
    of ``axis``, in place. Tensors off the mesh's device (AdamW's step
    counts on the CPU under NCCL) travel through it."""
    group, device = mesh.get_group(axis), mesh_device(mesh)
    src = _first_rank(group)
    for t in tensors:
        if t.device == device:
            dist.broadcast(t.data, src=src, group=group)
        else:
            moved = t.detach().to(device)
            dist.broadcast(moved, src=src, group=group)
            t.data.copy_(moved)


def replicate_params(mesh, params):
    """Make every rank's parameters (and buffers, for a module) data-rank
    0's: a broadcast over the data group, in place. Returns ``params``."""
    broadcast_tensors(_tensors(params), mesh)
    return params


def cross_replica_mean(tree: Any, mesh, axis_name: str = DATA) -> Any:
    """The mean over the ranks of ``axis_name`` of every tensor of a tree
    (JAX's ``pmean``): an all-reduce of the sum, divided by the group's
    size (gloo has no average)."""
    group, n = mesh.get_group(axis_name), mesh[axis_name].size()

    def mean(x):
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y / n

    return _tree_map(mean, tree)


# ---------------------------------------------------------------------------
# Tensor parallelism over the "model" axis: JAX's segment rules on the port's
# state-dict names. Column-parallel splits the output features (torch dim 0
# of [out, in]), row-parallel the input features (dim 1), so the activation
# between a pair stays split and one all-reduce per pair sums it. Exact
# segment match (not substring), so a "seq" module never aliases "q".
# ---------------------------------------------------------------------------

_COL_PARALLEL = frozenset({"fc1", "in_proj_weight", "qkv", "q", "k", "v"})
_ROW_PARALLEL = frozenset({"fc2", "out_proj", "merge2"})


def tensor_parallel_spec(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The placement of one parameter by its state-dict name, in JAX's
    PartitionSpec style over the torch layout [out, in, ...]: ("model",
    None, ...) column-parallel, (None, "model", ...) row-parallel, ()
    replicated (biases, norms and every other weight)."""
    if ndim < 2:
        return ()
    segs = set(name.split("."))
    if segs & _ROW_PARALLEL:
        return (None, MODEL) + (None,) * (ndim - 2)
    if segs & _COL_PARALLEL:
        return (MODEL,) + (None,) * (ndim - 1)
    return ()


class _ColumnProduct(torch.autograd.Function):
    """``F.linear(x, w, b)`` on this rank's output features, forward as the
    unsharded product; backward, the input's gradient (this rank's share of
    it) is taken and summed over the model group in f32 and rounded to the
    input's dtype once, as the unsharded product rounds its f32 accumulator
    once (Megatron's copy-to-region, with the product it guards)."""

    @staticmethod
    def forward(ctx, x, w, b, axis):
        ctx.save_for_backward(x, w)
        ctx.axis, ctx.has_bias = axis, b is not None
        return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        gx = gw = gb = None
        if need_x:
            gx = ctx.axis._all_reduce(g.float() @ w.float()).to(x.dtype)
        rows = g.reshape(-1, g.shape[-1])
        if need_w:
            gw = rows.t() @ x.reshape(-1, x.shape[-1])
        if need_b and ctx.has_bias:
            gb = rows.sum(0)
        return gx, gw, gb, None


class _ReduceFromRegion(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums of a
    row-parallel product; every rank then holds the whole output and the
    same gradient of it."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis._all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    """This rank's slice forward, all-gather backward: a replicated value
    (an activation, a bias) that the rank uses only its part of."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return x.chunk(axis.size, dim)[axis.rank]

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._all_gather(g, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """All-gather forward, this rank's slice backward: every rank computes
    the same thing from the gathered value, so each holds the whole
    gradient of it and keeps its own part (a reduce-scatter would add the
    model ranks' identical copies)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis._all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.axis.size, ctx.dim)[ctx.axis.rank].contiguous(), None, None


class ModelAxis:
    """This rank's place on the model axis, as the tensor-parallel modules
    use it: ``size`` ranks in ``group``, this one ``rank``. The collectives
    carry the compute dtype and differentiate as Megatron's conjugate pairs
    (every model rank holds the same batch and, after each collective,
    computes the same thing): :meth:`column` (a column-parallel product;
    all-reduce of its input's gradient), :meth:`all_reduce` (sum, identity gradient), :meth:`chunk`
    (slice, all-gather of the gradient) and :meth:`all_gather` (gather,
    slice of the gradient)."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        y = x.contiguous().clone()  # the reduction is in place
        dist.all_reduce(y, group=self.group)
        return y

    def _all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim)

    def column(self, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A column-parallel product, ``F.linear(x, w, b)`` with this rank's
        rows of the weight; ``x``'s gradient summed over the model group."""
        return _ColumnProduct.apply(x, w, b, self)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the model group (a new tensor)."""
        return _ReduceFromRegion.apply(x, self)

    def chunk(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of ``t`` along ``dim``."""
        return _Scatter.apply(t, self, dim)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim``, in rank order."""
        return _Gather.apply(x, self, dim)


def tp_axis(param: torch.Tensor) -> Optional["ModelAxis"]:
    """The model axis a parameter is a shard over (``shard_params_tp`` marks
    each shard), or None for a whole parameter."""
    return getattr(param, "tp_axis", None)


def _head_rows(w: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """This rank's q, k and v rows of a packed [3E, E] in-projection (or
    entries of a [3E] bias), stacked: the features of its heads in each."""
    return torch.cat([axis.chunk(part, 0) for part in w.chunk(3, 0)], 0)


def _local_part(whole: torch.Tensor, pname: str, dim: Optional[int],
                axis: ModelAxis) -> torch.Tensor:
    """This rank's part of parameter ``pname`` split along ``dim``: an
    in-projection by head, any other weight in contiguous slices."""
    if pname == "in_proj_weight":
        return _head_rows(whole, axis)
    return axis.chunk(whole, dim)


@torch.no_grad()
def shard_of(model: nn.Module, name: str, whole: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``whole``, a tensor shaped as parameter ``name`` of
    the unsharded model (a weight, its gradient), in the layout
    :func:`shard_params_tp` gave ``model``'s parameter: ``whole`` itself
    where that parameter is not a shard."""
    mod_name, _, pname = name.rpartition(".")
    module = model.get_submodule(mod_name)
    axis = tp_axis(getattr(module, pname))
    if axis is None:
        return whole
    return _local_part(whole, pname, getattr(module, "tp_dim", None), axis)


@torch.no_grad()
def shard_params_tp(mesh, model: nn.Module) -> nn.Module:
    """Keep, on each rank, its model-axis slice of every weight
    :func:`tensor_parallel_spec` splits, in place, and hand the modules that
    hold them the axis (``module.tp``; ``Linear.tp_dim`` the split
    dimension) so that they compute tensor-parallel; data-parallel ranks
    stay replicated. A weight whose split dimension does not divide by the
    model-axis size stays replicated, as in JAX; so does an in-projection
    whose head count does not. Returns ``model``."""
    n = mesh[MODEL].size()
    if n == 1:
        return model
    axis = ModelAxis(mesh.get_group(MODEL), mesh.get_local_rank(MODEL), n)
    for mod_name, module in model.named_modules():
        for pname, p in list(module.named_parameters(recurse=False)):
            name = f"{mod_name}.{pname}" if mod_name else pname
            spec = tensor_parallel_spec(name, p.dim())
            if MODEL not in spec:
                continue
            dim = spec.index(MODEL)
            if p.shape[dim] % n:
                continue
            if not hasattr(module, "tp"):
                raise TypeError(f"shard_params_tp: {name} matches the rules, and "
                                f"{type(module).__name__} has no tensor-parallel compute")
            if pname == "in_proj_weight":
                if module.num_heads % n:
                    continue
            else:
                module.tp_dim = dim
            shard = _local_part(p, pname, dim, axis)
            shard = nn.Parameter(shard.clone(memory_format=torch.contiguous_format),
                                 requires_grad=p.requires_grad)
            shard.tp_axis = axis
            setattr(module, pname, shard)
            module.tp = axis
    return model
