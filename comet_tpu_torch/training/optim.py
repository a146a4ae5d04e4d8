"""Optimizer and learning-rate schedule.

Counterpart of ``comet_tpu/training/optim.py`` (optax), itself the
reference's build_optimizer (comet/models/train_util.py:311-333), AdamW over
the camera predictor's parameters only, and WarmupCosineRestarts
(train_util.py:2099-2128): cosine restarts of a period of
``restart_epochs`` epochs, with a linear warmup over the first
``warmup_ratio`` of each period.

optax's transform is ``multi_transform({"train": chain(clip_by_global_norm,
adamw(schedule)), "freeze": set_to_zero()})``. Here the frozen parameters
are not given to the optimizer at all, :class:`ClippedAdamW` clips the
trainable gradients by their global norm (optax's rule, not
``clip_grad_norm_``'s, which adds 1e-6 to the norm) before AdamW with
optax's defaults (weight decay 1e-4, not torch's 1e-2), and a ``LambdaLR``
over a base rate of 1 gives each step the schedule's value at the count of
steps before it, as optax reads its schedule.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn

from ..parallel.mesh import tp_axis

# optax.adamw's defaults
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


def warmup_cosine_restarts(
    base_lr: float,
    period_steps: int,
    warmup_ratio: float = 0.1,
    warmup_lr_init: float = 1e-7,
    eta_min: float = 0.0,
) -> Callable[[int], float]:
    """WarmupCosineRestarts (train_util.py:2099-2128) with T_mult 1: step ->
    learning rate."""
    warmup_steps = int(period_steps * warmup_ratio)

    def schedule(step: int) -> float:
        t_cur = step % period_steps
        if t_cur < warmup_steps:
            return warmup_lr_init + (base_lr - warmup_lr_init) * (t_cur / max(warmup_steps, 1))
        t_i = max(period_steps - warmup_steps, 1)
        return eta_min + (base_lr - eta_min) * (
            1.0 + math.cos(math.pi * (t_cur - warmup_steps) / t_i)) / 2.0

    return schedule


def _names(params: Union[nn.Module, Mapping, Iterable[str]]) -> Iterable[str]:
    if isinstance(params, nn.Module):
        return (name for name, _ in params.named_parameters())
    return params  # a state_dict or the names themselves


def camera_only_mask(params: Union[nn.Module, Mapping, Iterable[str]]) -> Dict[str, bool]:
    """Parameter name -> trainable: only the camera predictor, without its
    frozen ViT backbone, is trained, as the reference optimizer sees
    model.camera_predictor.parameters() with the backbone's requires_grad
    False (train_util.py:313, camera_predictor10.py:121-124). ``params``: a
    model, a state_dict or parameter names."""
    return {name: name.startswith("camera_predictor.") and ".backbone." not in f".{name}"
            for name in _names(params)}


def trainable_labels(params: Union[nn.Module, Mapping, Iterable[str]]) -> Dict[str, str]:
    """Parameter name -> "train" or "freeze" (optax.multi_transform's labels)."""
    return {name: "train" if m else "freeze" for name, m in camera_only_mask(params).items()}


def clip_by_global_norm_(grads: list, max_norm: float, axes: Optional[list] = None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: each gradient times max_norm /
    norm where the global norm is at least max_norm. The scale stays on the
    gradients' device (no host synchronization). Returns the norm.

    Under tensor parallelism ``axes[i]`` is the model axis gradient i is a
    shard over (``parallel.mesh.tp_axis``), else None: the norm is then the
    whole model's, the sum of the shards' squares over the model group plus
    the replicated gradients' counted once, the same on every model rank."""
    axes = axes or [None] * len(grads)

    def square_sum(sharded):
        part = [g for g, a in zip(grads, axes) if (a is not None) == sharded]
        return torch.stack(torch._foreach_norm(part)).float().square().sum() if part else 0.0

    sq = square_sum(False)
    axis = next((a for a in axes if a is not None), None)
    if axis is not None:
        sq = sq + axis.all_reduce(square_sum(True))
    norm = sq.sqrt()
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class ClippedAdamW(torch.optim.AdamW):
    """AdamW after ``clip_by_global_norm(clip_grad)`` of the gradients of
    every parameter it holds (``clip_grad`` 0: no clip), the norm of the
    whole model's gradient also where tensor parallelism shards it; the last
    norm is kept as ``last_norm`` (a tensor on the gradients' device). A
    parameter the loss did not reach gets a zero gradient, as in JAX, where
    every leaf has one: weight decay and the moments still move it."""

    last_norm = None

    def __init__(self, params, lr: float = 1.0, clip_grad: float = 1.0):
        super().__init__(params, lr=lr, betas=ADAMW_BETAS, eps=ADAMW_EPS,
                         weight_decay=ADAMW_WEIGHT_DECAY)
        self.clip_grad = clip_grad

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for group in self.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_grad > 0:
            self.last_norm = clip_by_global_norm_([p.grad for p in params], self.clip_grad,
                                                  [tp_axis(p) for p in params])
        return super().step(closure)


def build_optimizer(
    model: nn.Module,
    base_lr: float = 1e-5,
    steps_per_epoch: int = 1,
    restart_epochs: int = 80,
    warmup_ratio: float = 0.1,
    warmup_lr_init: float = 1e-7,
    clip_grad: float = 1.0,
) -> Tuple[ClippedAdamW, torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, scheduler): :class:`ClippedAdamW` over the parameters
    :func:`camera_only_mask` selects, and the warmup-cosine-restarts
    schedule as a ``LambdaLR``. Call ``scheduler.step()`` after each
    ``optimizer.step()``."""
    schedule = warmup_cosine_restarts(
        base_lr, restart_epochs * steps_per_epoch, warmup_ratio, warmup_lr_init)
    mask = camera_only_mask(model)
    trainable = [p for name, p in model.named_parameters() if mask[name]]
    optimizer = ClippedAdamW(trainable, lr=1.0, clip_grad=clip_grad)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)
