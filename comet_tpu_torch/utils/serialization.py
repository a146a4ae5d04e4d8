"""Weight files and the one-time inference cast.

Counterpart of ``comet_tpu/utils/serialization.py``. The port's weight file
is a ``torch.save``d state dict (``.pt``), the counterpart of the JAX
package's flax ``.msgpack``; a ``.msgpack`` is JAX's format and is read
through ``weights.params_from_jax`` instead.
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn


def cast_params_for_inference(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating parameter and buffer of ``model`` to ``dtype``
    once, in place; returns the model.

    The modules keep f32 masters and cast each weight at every use; for
    inference and its benchmarks the cast is done once here, with the same
    numbers (a cast of a cast is the cast), so each use's cast is a no-op.
    Training keeps the f32 masters."""
    for t in list(model.parameters()) + list(model.buffers()):
        if t.is_floating_point() and t.dtype != dtype:
            t.data = t.data.to(dtype)
    return model


def _check_format(path: str) -> None:
    if path.endswith(".msgpack"):
        raise ValueError(
            f"{path}: a flax .msgpack is the JAX package's weight format; convert its tree "
            "with comet_tpu_torch.weights.params_from_jax and save the state dict with "
            "save_params")


def save_params(path: str, model: nn.Module) -> str:
    """Save ``model``'s state dict to ``path`` (a ``.pt`` file), whole or not
    at all; returns the path."""
    _check_format(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(model.state_dict(), tmp)
    os.replace(tmp, path)
    return path


def load_params(path: str, model: nn.Module) -> nn.Module:
    """Load a state dict saved by :func:`save_params` into ``model`` in place
    (each tensor keeps the model's device and dtype); returns the model."""
    _check_format(path)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return model
