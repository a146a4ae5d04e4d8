"""Weight bridge: the JAX package's flax parameter tree -> a state_dict.

The port's parameter names mirror the flax paths, so the mapping is
mechanical:

- a path component ``name_<i>`` becomes ``name.<i>`` (a ModuleList index);
- a Dense ``kernel`` [in, out] becomes ``weight`` [out, in];
- a Conv ``kernel`` (HWIO) becomes ``weight`` (OIHW);
- ``in_proj_kernel`` [E, 3E] becomes ``in_proj_weight`` [3E, E];
- a LayerNorm / GroupNorm ``scale`` becomes ``weight``;
- every other leaf keeps its name and shape.

The tree is a nested dict of numpy arrays (a ``bfloat16`` leaf, which
numpy has no dtype for, may be a torch tensor: ``utils.serialization``'s
msgpack reader gives one); no JAX is needed here.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Iterator, Mapping, Tuple, Union

import numpy as np
import torch

from .config import CometConfig

_INDEXED = re.compile(r"^(.+)_(\d+)$")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def convert_leaf(path: Tuple[str, ...], value,
                 verbatim: Iterable[str] = ()) -> Tuple[str, Union[np.ndarray, torch.Tensor]]:
    """One flax leaf -> (state_dict name, array in the port's layout); a
    path component in ``verbatim`` keeps its ``_<i>`` suffix (a flax module
    named ``input_proj_1`` beside ``input_proj``, not a list entry)."""
    parts = []
    for comp in path[:-1]:
        m = None if comp in verbatim else _INDEXED.match(comp)
        parts.extend(m.groups() if m else (comp,))
    leaf = path[-1]
    arr = value if isinstance(value, torch.Tensor) else np.asarray(value)
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.permute(3, 2, 0, 1) if isinstance(arr, torch.Tensor) else arr.transpose(
                3, 2, 0, 1)
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
        leaf = "weight"
    elif leaf == "in_proj_kernel":
        arr, leaf = arr.T, "in_proj_weight"
    elif leaf == "scale":
        leaf = "weight"
    return ".".join(parts + [leaf]), arr


def state_dict_from_flax(tree: Mapping, expected: Mapping,
                         verbatim: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """Convert a flax tree against the names and shapes a module expects
    (``expected`` maps names to shapes or to tensors, e.g. a state_dict).

    Raises if a leaf maps to no parameter, two leaves map to one, a shape
    differs, or a parameter is left unfilled. The tensors share memory with
    the given arrays where those are writable.
    """
    if set(tree) == {"params"}:
        tree = tree["params"]
    expected = {k: tuple(getattr(v, "shape", v)) for k, v in expected.items()}
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(tree):
        name, arr = convert_leaf(path, value, verbatim)
        if name not in expected:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {name}: no such port parameter")
        if name in out:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {name}: filled twice")
        if tuple(arr.shape) != expected[name]:
            raise ValueError(
                f"flax leaf {'/'.join(path)} -> {name}: shape {arr.shape}, port {expected[name]}"
            )
        if isinstance(arr, torch.Tensor):
            out[name] = arr
            continue
        if not arr.flags.writeable:
            arr = arr.copy()
        out[name] = torch.from_numpy(arr)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port parameters not filled: {missing[:8]}{' ...' if len(missing) > 8 else ''}")
    return out


def params_from_jax(flax_params: Mapping, cfg: CometConfig) -> Dict[str, torch.Tensor]:
    """The JAX COMET's parameter tree (numpy leaves) -> the port's
    state_dict for ``cfg``; every leaf is consumed exactly once and every
    parameter filled, or it raises."""
    from .models.comet import build_comet

    return state_dict_from_flax(flax_params, build_comet(cfg, device="meta").state_dict())


def module_params_from_jax(flax_params: Mapping, module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The flax tree of one of the JAX package's modules (SuperPoint,
    LightGlue, SuperGlue, PoseEmbedding, ...) -> the state_dict of its port
    ``module``, whose parameter names mirror the flax paths; the module's
    ``FLAX_VERBATIM`` names the flax components that keep their ``_<i>``.
    Raises like :func:`state_dict_from_flax`."""
    return state_dict_from_flax(flax_params, module.state_dict(),
                                getattr(module, "FLAX_VERBATIM", ()))
