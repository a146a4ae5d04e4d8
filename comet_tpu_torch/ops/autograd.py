"""The gradient of every kernel wrapper: the plain version's, recomputed.

Counterpart of the ``jax.custom_vjp`` around each Pallas kernel of the JAX
package (``pallas_attn.py::_fused_attention``, ``pallas_block.py::
_fused_block`` and ``_cross_block``, ``pallas_norm.py::_ln``): the forward
is the kernel, and the backward is the VJP of the plain version at the saved
inputs, computed by the framework's own ops outside any kernel. The same
Function serves the CPU, where the forward is the plain version itself, so
the CPU tests run the backward code that the card runs.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


class PlainBackward(torch.autograd.Function):
    """``run(*tensors)`` forward; backward through ``plain(*tensors)``,
    recomputed from the saved inputs under ``torch.enable_grad()``. A
    tensor argument may be None (an absent scale and bias)."""

    @staticmethod
    def forward(ctx, run: Callable, plain: Callable, *tensors: Optional[torch.Tensor]):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return run(*tensors)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*inputs)
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(inputs, needs) if n], grad))
        return (None, None, *(next(grads) if n else None for n in needs))


def plain_backward(launch: Callable, plain: Callable,
                   *tensors: Optional[torch.Tensor]) -> torch.Tensor:
    """A kernel wrapper's result: ``launch(*tensors)`` (the kernel) for
    tensors on the card, ``plain(*tensors)`` for tensors on the CPU;
    differentiable through :class:`PlainBackward` when a gradient is being
    recorded for one of the tensors, else with no autograd bookkeeping on
    the launch path."""
    run = plain if tensors[0].device.type == "cpu" else launch
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return PlainBackward.apply(run, plain, *tensors)
    return run(*tensors)
