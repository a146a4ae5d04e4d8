"""The port's kernels as registered operators, namespace ``comet::``.

One operator per kernel entry point, each with three implementations picked
by the dispatcher's key, never by a device test in Python:

- **CUDA**: the hand-written kernel (the ``*_launch`` functions of
  ``ops/attn.py``, ``ops/block.py`` and ``ops/norm.py``, which compute the
  launch plan from the shapes and the card's SM count and count the launch).
  It launches or raises; it never gives way to the plain version.
- **CPU**: the plain PyTorch version of the same function.
- **Fake** (meta): the output's shape and dtype only, so that
  ``torch.export`` traces the model with the operators as graph nodes. It
  touches no kernel library.

The gradient is the plain version's, recomputed from the saved inputs
(:func:`plain_vjp`), the counterpart of the JAX package's
``custom_vjp`` backward around each Pallas kernel (``pallas_attn.py::
_fa_bwd``, ``pallas_block.py::_fb_bwd`` and ``_cb_bwd``, ``pallas_norm.py::
_ln_bwd``), so on the card the gradients equal the plain version's autograd
bit for bit.

A process that serves an exported artifact imports this module, which
registers the operators, before it loads the artifact
(``utils/serving.py``). Registration is the lower-level
``torch.library.Library("comet", "DEF")`` with one Python kernel per
dispatch key: the decorator form (``torch.library.custom_op``) wraps each
call in more Python, and the forward makes ~360 kernel calls.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from . import attn, block, norm

_LIB = torch.library.Library("comet", "DEF")

_BLOCK_WEIGHTS = "Tensor wout, Tensor bout, Tensor w1, Tensor b1, Tensor w2, Tensor b2"
SCHEMAS = {
    # K1, csrc/attn.cu; softmax: "base" (K1) or an A/B form, "nomax" or "bf16e"
    "attention": "attention(Tensor q, Tensor k, Tensor v, int num_heads, float scale, "
                 "str softmax) -> Tensor",
    # K3, csrc/short_attn.cu
    "short_attention": "short_attention(Tensor q, Tensor k, Tensor v, int num_heads, "
                       "float scale) -> Tensor",
    # K2, csrc/block.cu
    "attn_block": f"attn_block(Tensor x, Tensor wqkv, Tensor bqkv, {_BLOCK_WEIGHTS}, "
                  "int num_heads) -> Tensor",
    # K4, csrc/cross_block.cu
    "cross_block": "cross_block(Tensor x, Tensor ctx, Tensor gamma, Tensor beta, Tensor wq, "
                   f"Tensor bq, Tensor wkv, Tensor bkv, {_BLOCK_WEIGHTS}, int num_heads) -> Tensor",
    # K5, csrc/norm.cu
    "layer_norm": "layer_norm(Tensor x, Tensor? scale, Tensor? bias, float eps) -> Tensor",
}

# the plain versions, with the operators' arguments
PLAIN: Dict[str, Callable] = {
    "attention": attn.attention_form_reference,
    "short_attention": attn.attention_reference,
    "attn_block": block.block_reference,
    "cross_block": block.cross_block_reference,
    "layer_norm": norm.layer_norm_reference,
}

# the kernels, with the operators' arguments
_CUDA: Dict[str, Callable] = {
    "attention": attn.k1_launch,
    "short_attention": attn.short_launch,
    "attn_block": block.block_launch,
    "cross_block": block.cross_launch,
    "layer_norm": norm.launch,
}


def _fake(x: torch.Tensor, *_) -> torch.Tensor:
    """Every operator's result has the shape and dtype of its first input
    (q's for attention: [B, Lq, C]), contiguous."""
    return x.new_empty(x.shape)


def plain_vjp(name: str, inputs: tuple, needs: tuple, grad: torch.Tensor) -> tuple:
    """The gradients of operator ``name``'s plain version at ``inputs``
    (None for an input that needs none), for the cotangent ``grad``: the
    plain version recomputed on detached inputs under
    ``torch.enable_grad()`` and ``torch.autograd.grad`` (a third of the host
    time of ``torch.func.vjp`` per call, the same numbers)."""
    args = list(inputs)
    at = [i for i, (t, n) in enumerate(zip(inputs, needs)) if n and isinstance(t, torch.Tensor)]
    with torch.enable_grad():
        for i in at:
            args[i] = inputs[i].detach().requires_grad_()
        grads = torch.autograd.grad(PLAIN[name](*args), [args[i] for i in at], grad)
    out = [None] * len(inputs)
    for i, g in zip(at, grads):
        out[i] = g
    return tuple(out)


def _register(name: str) -> None:
    _LIB.define(SCHEMAS[name])
    _LIB.impl(name, PLAIN[name], "CPU")
    _LIB.impl(name, _CUDA[name], "CUDA")
    torch.library.register_fake(f"comet::{name}", _fake, lib=_LIB)

    def setup_context(ctx, inputs, output):
        tensors = [i for i, t in enumerate(inputs) if isinstance(t, torch.Tensor)]
        ctx.tensor_at = tensors
        ctx.others = list(inputs)
        for i in tensors:
            ctx.others[i] = None
        ctx.save_for_backward(*(inputs[i] for i in tensors))

    def backward(ctx, grad):
        inputs = list(ctx.others)
        for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
            inputs[i] = t
        # plain_vjp is looked up at call time, so that a check may count the backwards
        return plain_vjp(name, tuple(inputs), ctx.needs_input_grad, grad)

    torch.library.register_autograd(f"comet::{name}", backward, setup_context=setup_context,
                                    lib=_LIB)


for _name in SCHEMAS:
    _register(_name)
