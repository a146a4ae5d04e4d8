"""Checkpoints: the epoch-directory convention, auto-resume, the JAX
package's checkpoints and tensor-parallel models.

Counterpart of ``comet_tpu/training/checkpoints.py``, itself the reference's
scheme (train_util.py:165-309, 1852-1862; train_e2epose2.py:92-113,
157-163): the whole training state is saved to ``ckpt_{epoch:06d}``
directories, and auto-resume finds the newest by its name.

The port writes one ``state.pt`` per directory (``torch.save``): a dict of
the state's entries, each an object's state dict (model, optimizer,
scheduler, ``RunningStats``) or a plain value (epoch).

It also resumes a run of the JAX package. That package saves
``{"params", "opt"}`` with orbax's ``StandardCheckpointer``, whose defaults
write an OCDBT key-value store (``manifest.ocdbt``, ``ocdbt.process_0/``)
in which the B-tree nodes and the data files alike are zstd-compressed.
The card's machine has no zstd decoder, and one in Python would take
minutes over a full-width state (three f32 copies of the camera's
parameters), so the port does not read that store itself:
``tools/orbax_to_msgpack.py``, run where orbax is installed, writes the
same tree beside orbax's files as ``state.msgpack``, in flax's msgpack
layout, which ``utils.serialization`` reads without JAX. A directory that
holds only orbax's files raises with the tool's command line. The optax
state (``multi_transform`` -> ``masked`` -> ``chain(clip_by_global_norm,
adamw(schedule))``, ``comet_tpu/training/optim.py``) maps onto
:class:`training.optim.ClippedAdamW` (``mu`` -> ``exp_avg``, ``nu`` ->
``exp_avg_sq``, ``count`` -> ``step``) and the schedule's count onto the
``LambdaLR``'s ``last_epoch``; the epoch is the directory's, as JAX's
:func:`find_last_checkpoint` reads it.

A model that tensor parallelism sharded (``parallel.shard_params_tp``) is
saved whole, as orbax saves sharded arrays whole: every rank calls
:func:`save_checkpoint` (each model group gathers its shards, the weights'
and the Adam moments', along each shard's layout), rank 0 writes, and every
rank returns once the file is there. Any checkpoint restores into any mesh
shape: each rank keeps its part of each whole tensor
(``parallel.local_part``).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..parallel.mesh import local_part, tp_axis, whole_of

_CKPT_RE = re.compile(r"^ckpt_(\d{6})$")
STATE_FILE = "state.pt"
JAX_STATE_FILE = "state.msgpack"
ORBAX_FILES = ("_METADATA", "manifest.ocdbt")
CONVERTER = "tools/orbax_to_msgpack.py"


def _optimizer_params(optimizer: torch.optim.Optimizer) -> list:
    """The parameters in the order of the optimizer's state dict."""
    return [p for group in optimizer.param_groups for p in group["params"]]


def _params_of(obj) -> list:
    if isinstance(obj, nn.Module):
        return list(obj.parameters())
    if isinstance(obj, torch.optim.Optimizer):
        return _optimizer_params(obj)
    return []


def _moments(state: dict, fn) -> dict:
    """``fn`` of each per-element entry of one parameter's optimizer state
    (the moments; not the 0-d step)."""
    return {k: fn(v) if torch.is_tensor(v) and v.dim() > 0 else v for k, v in state.items()}


def _whole_state(obj) -> Any:
    """``obj``'s state dict, each tensor-parallel shard of a model or of an
    optimizer's moments gathered whole; a plain value as it is."""
    if isinstance(obj, nn.Module):
        sd = obj.state_dict()
        for name, p in obj.named_parameters():
            if tp_axis(p) is not None:
                sd[name] = whole_of(p, p.detach())
        return sd
    if isinstance(obj, torch.optim.Optimizer):
        sd = obj.state_dict()
        for i, p in enumerate(_optimizer_params(obj)):
            if i in sd["state"] and tp_axis(p) is not None:
                sd["state"][i] = _moments(sd["state"][i], lambda v, p=p: whole_of(p, v))
        return sd
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def save_checkpoint(ckpt_dir: str, epoch: int, state: Dict[str, Any]) -> str:
    """Save ``state`` (name -> an object with ``state_dict()``, or a plain
    value) to ``ckpt_dir/ckpt_{epoch:06d}/state.pt``, replacing what is
    there; the file appears whole or not at all. Returns the directory.

    Where a model or optimizer of ``state`` holds tensor-parallel shards,
    every rank calls this: the shards are gathered whole over each model
    group, rank 0 writes, and every rank returns after the write."""
    sharded = any(tp_axis(p) is not None for v in state.values() for p in _params_of(v))
    payload = {k: _whole_state(v) for k, v in state.items()}
    path = os.path.join(ckpt_dir, f"ckpt_{epoch:06d}")
    if not sharded or dist.get_rank() == 0:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
    if sharded:
        dist.barrier()
    return path


def find_last_checkpoint(ckpt_dir: str) -> Optional[Tuple[int, str]]:
    """The newest ckpt_NNNNNN directory as (epoch, path) (train_util.py:1852-1862)."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m:
            epoch = int(m.group(1))
            if best is None or epoch > best[0]:
                best = (epoch, os.path.join(ckpt_dir, name))
    return best


def _whole_shape(p: torch.Tensor) -> Tuple[int, ...]:
    """The shape of the whole parameter of which ``p`` may be a shard."""
    axis = tp_axis(p)
    shape = list(p.shape)
    if axis is not None:
        shape[p.tp_dim or 0] *= axis.size
    return tuple(shape)


def _lr_at(scheduler, count: int) -> list:
    """A ``LambdaLR``'s rates after ``count`` steps."""
    return [base * fn(count) for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)]


def _from_jax(tree: Dict[str, Any], target: Dict[str, Any], epoch: int) -> Dict[str, Any]:
    """The saved state :func:`restore_checkpoint` loads, from the JAX
    package's ``{"params", "opt"}`` tree: the model's whole state dict, the
    optimizer's and the scheduler's, and the epoch."""
    from ..weights import state_dict_from_flax

    models = [v for v in target.values() if isinstance(v, nn.Module)]
    if len(models) != 1:
        raise ValueError("restoring a JAX checkpoint needs the one model in the target")
    model = models[0]
    params = dict(model.named_parameters())
    names = {id(p): n for n, p in params.items()}
    model_sd = state_dict_from_flax(tree["params"], {
        n: _whole_shape(params[n]) if n in params else tuple(t.shape)
        for n, t in model.state_dict().items()})
    opt = tree["opt"]["inner_states"]["train"]["inner_state"]["1"]
    adam, count = opt["0"], int(np.asarray(opt["2"]["count"]))
    if int(np.asarray(adam["count"])) != count:
        raise ValueError(f"the JAX checkpoint's Adam count {adam['count']} is not its "
                         f"schedule's {count}")
    scheduler = next((v for v in target.values()
                      if isinstance(v, torch.optim.lr_scheduler.LambdaLR)), None)
    saved: Dict[str, Any] = {}
    for k, v in target.items():
        if isinstance(v, nn.Module):
            saved[k] = model_sd
        elif isinstance(v, torch.optim.Optimizer):
            held = _optimizer_params(v)
            if any(id(p) not in names for p in held):
                raise ValueError("the optimizer holds parameters that are not the model's")
            shapes = {names[id(p)]: _whole_shape(p) for p in held}
            mu, nu = (state_dict_from_flax(adam[m], shapes) for m in ("mu", "nu"))
            sd = v.state_dict()
            sd["state"] = {} if count == 0 else {
                i: {"step": torch.tensor(float(count)), "exp_avg": mu[names[id(p)]],
                    "exp_avg_sq": nu[names[id(p)]]} for i, p in enumerate(held)}
            if scheduler is not None:
                for group, lr in zip(sd["param_groups"], _lr_at(scheduler, count)):
                    group["lr"] = lr
            saved[k] = sd
        elif isinstance(v, torch.optim.lr_scheduler.LambdaLR):
            sd = v.state_dict()
            sd.update(last_epoch=count, _step_count=count + 1, _last_lr=_lr_at(v, count))
            saved[k] = sd
        elif k == "epoch":
            saved[k] = epoch
    return saved


def _read(path: str, target: Dict[str, Any]) -> Dict[str, Any]:
    """The saved state in ``path``: the port's ``state.pt``, or the JAX
    package's tree converted to ``state.msgpack``."""
    if os.path.exists(os.path.join(path, STATE_FILE)):
        return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    if os.path.exists(os.path.join(path, JAX_STATE_FILE)):
        from ..utils.serialization import read_msgpack

        m = _CKPT_RE.match(os.path.basename(os.path.normpath(path)))
        return _from_jax(read_msgpack(os.path.join(path, JAX_STATE_FILE)), target,
                         int(m.group(1)) if m else None)
    if any(os.path.exists(os.path.join(path, f)) for f in ORBAX_FILES):
        raise ValueError(f"{path} is the JAX package's orbax checkpoint, which the port does not "
                         f"read; convert it where orbax is installed: python {CONVERTER} {path}")
    raise FileNotFoundError(f"{path}: no {STATE_FILE} or {JAX_STATE_FILE}")


def _load_module(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    params = dict(model.named_parameters())
    model.load_state_dict({n: local_part(params[n], t) if n in params else t
                           for n, t in sd.items()})


def _load_optimizer(optimizer: torch.optim.Optimizer, sd: Dict[str, Any]) -> None:
    state = dict(sd["state"])
    for i, p in enumerate(_optimizer_params(optimizer)):
        if i in state and tp_axis(p) is not None:
            state[i] = _moments(state[i], lambda v, p=p: local_part(p, v))
    optimizer.load_state_dict({**sd, "state": state})


def restore_checkpoint(path: str, target: Dict[str, Any]) -> Dict[str, Any]:
    """Restore the state in ``path`` into ``target`` (the same names): a
    checkpoint of :func:`save_checkpoint`, or one of the JAX package
    converted by ``tools/orbax_to_msgpack.py`` (``target`` then holds the
    model, and may hold its optimizer, scheduler and "epoch"). An object
    with ``load_state_dict`` is loaded in place (a model or optimizer keeps
    its device; a tensor-parallel one takes this rank's part of each whole
    tensor), a plain value is replaced. Returns ``target`` with the plain
    values restored."""
    saved = _read(path, target)
    missing = sorted(set(target) - set(saved))
    if missing:
        raise KeyError(f"restore_checkpoint: {path} holds no {missing}")
    out = dict(target)
    for k, v in target.items():
        if isinstance(v, nn.Module):
            _load_module(v, saved[k])
        elif isinstance(v, torch.optim.Optimizer):
            _load_optimizer(v, saved[k])
        elif hasattr(v, "load_state_dict"):
            v.load_state_dict(saved[k])
        else:
            out[k] = saved[k]
    return out


def auto_resume(ckpt_dir: str, target: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
    """Resume from the newest checkpoint if there is one: (the epoch after
    it, the restored state); else (0, ``target`` unchanged)."""
    found = find_last_checkpoint(ckpt_dir)
    if found is None:
        return 0, target
    epoch, path = found
    return epoch + 1, restore_checkpoint(path, target)
