"""Weight bridge: the JAX package's flax parameter tree -> a state_dict.

The port's parameter names mirror the flax paths, so the mapping is
mechanical:

- a path component ``name_<i>`` becomes ``name.<i>`` (a ModuleList index);
- a Dense ``kernel`` [in, out] becomes ``weight`` [out, in];
- a Conv ``kernel`` (HWIO) becomes ``weight`` (OIHW);
- ``in_proj_kernel`` [E, 3E] becomes ``in_proj_weight`` [3E, E];
- a LayerNorm / GroupNorm / BatchNorm ``scale`` becomes ``weight``;
- a BatchNorm's statistics, in the ``batch_stats`` collection beside
  ``params``, become its buffers: ``mean`` ``running_mean`` and ``var``
  ``running_var`` (flax keeps no ``num_batches_tracked``: it is filled with 0);
- every other leaf keeps its name and shape (a module whose parameter
  keeps a flax layout says so, as ALIKED's deformable ``weight`` does).

The tree is a nested dict of numpy arrays (a ``bfloat16`` leaf, which
numpy has no dtype for, may be a torch tensor: ``utils.serialization``'s
msgpack reader gives one); no JAX is needed here. :func:`module_params_to_jax`
is the way back, a module's state dict as the flax variables
(``{"params": ..., "batch_stats": ...}``) with numpy leaves.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from .config import CometConfig

_INDEXED = re.compile(r"^(.+)_(\d+)$")
# a BatchNorm's statistics: flax's batch_stats leaf -> the port's buffer
_STATS = {"mean": "running_mean", "var": "running_var"}


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
    stats: Mapping = {}
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        tree, stats = tree["params"], tree.get("batch_stats", {})
    expected = {k: tuple(getattr(v, "shape", v)) for k, v in expected.items()}
    out: Dict[str, torch.Tensor] = {}
    leaves = [(path, convert_leaf(path, value, verbatim)) for path, value in _leaves(tree)]
    for path, value in _leaves(stats):
        if path[-1] not in _STATS:
            raise KeyError(f"batch_stats leaf {'/'.join(path)}: not a BatchNorm statistic")
        name, arr = convert_leaf(path[:-1] + ("x",), value, verbatim)
        leaves.append((("batch_stats",) + path, (name[:-1] + _STATS[path[-1]], arr)))
    for path, (name, arr) in leaves:
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
    for name in expected:
        if name.endswith(".num_batches_tracked") and name not in out:
            out[name] = torch.zeros((), dtype=torch.long)
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


def module_params_to_jax(module: torch.nn.Module,
                         values: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Dict]:
    """``module``'s state dict as the flax variables of its JAX counterpart,
    numpy f32 leaves: ``{"params": tree}``, with ``"batch_stats"`` where it
    holds BatchNorms. The exact inverse of :func:`module_params_from_jax`: a
    ``nn.Linear`` / ``nn.Conv2d`` ``weight`` becomes a ``kernel`` in flax's
    layout, a norm's ``weight`` its ``scale``, an attention's
    ``in_proj_weight`` its ``in_proj_kernel``, a BatchNorm's running
    statistics ``mean`` and ``var`` (its ``num_batches_tracked`` is dropped),
    a ModuleList index ``name.<i>`` the component ``name_<i>``; every other
    leaf keeps its name and layout. Every map's keys are sorted.

    ``values`` (parameter name -> tensor of its shape, such as an optimizer's
    moments) puts those tensors in the parameters' places, and leaves the
    buffers out: the tree of an optax state over the parameters."""
    leaves = list(_flax_leaves(module, values))
    out: Dict[str, Dict] = {"params": {}}
    for (section, comps, leaf, _, perm), arr in zip(
            leaves, _host_arrays([t for *_, t, _ in leaves])):
        if perm is not None:
            arr = arr.transpose(perm)
        # (ascontiguousarray makes a 0-d array 1-d)
        _put(out, section, comps, leaf, np.array(arr, order="C"))
    return _sorted(out)


def flax_template(module: torch.nn.Module) -> Dict[str, Dict]:
    """The paths, shapes and dtypes of :func:`module_params_to_jax`'s tree
    without its values: each leaf a read-only array of zeros in the
    parameter's dtype that holds no memory (``np.broadcast_to``). It reads
    only shapes, so a ``device="meta"`` module gives a full-width template
    for nothing; the checkpoint converters fill one."""
    out: Dict[str, Dict] = {"params": {}}
    for section, comps, leaf, t, perm in _flax_leaves(module, None):
        shape = tuple(t.shape[i] for i in perm) if perm is not None else tuple(t.shape)
        zero = np.zeros((), torch.empty((), dtype=t.dtype).numpy().dtype)
        _put(out, section, comps, leaf, np.broadcast_to(zero, shape))
    return _sorted(out)


def _flax_leaves(module: torch.nn.Module, values: Optional[Mapping[str, torch.Tensor]]):
    """(section, path components, leaf name, tensor, axis permutation into
    flax's layout or None) of every leaf of ``module``'s flax variables."""
    norms = (nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._BatchNorm)
    for mod_name, mod in module.named_modules():
        own = list(mod.named_parameters(recurse=False))
        if values is None:
            own += [(n, b) for n, b in mod.named_buffers(recurse=False)
                    if n not in mod._non_persistent_buffers_set and n != "num_batches_tracked"]
        for leaf, value in own:
            if values is not None:
                value = values[f"{mod_name}.{leaf}" if mod_name else leaf]
            section, perm = "params", None
            if leaf == "weight" and isinstance(mod, (nn.Linear, nn.Conv2d)):
                perm, leaf = ((1, 0) if value.dim() == 2 else (2, 3, 1, 0)), "kernel"
            elif leaf == "weight" and (isinstance(mod, norms) or _is_norm(mod)):
                leaf = "scale"
            elif leaf == "in_proj_weight":
                perm, leaf = (1, 0), "in_proj_kernel"
            elif leaf in ("running_mean", "running_var"):
                section, leaf = "batch_stats", leaf[len("running_"):]
            yield section, _flax_components(mod_name), leaf, value, perm


def _put(tree: Dict, section: str, comps, leaf: str, arr) -> None:
    node = tree.setdefault(section, {})
    for comp in comps:
        node = node.setdefault(comp, {})
    node[leaf] = arr


def _host_arrays(tensors):
    """The tensors as f32 numpy arrays, with one device-to-host copy per
    device (a copy per tensor would wait on the card once per tensor)."""
    out = [None] * len(tensors)
    by_device: Dict[torch.device, list] = {}
    for i, t in enumerate(tensors):
        by_device.setdefault(t.device, []).append(i)
    for idx in by_device.values():
        flat = torch.cat([tensors[i].detach().float().reshape(-1) for i in idx]).cpu().numpy()
        start = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[start:start + n].reshape(tensors[i].shape)
            start += n
    return out


def numpy_tree(tree):
    """A writable numpy copy of a nested dict of arrays (the upstream
    checkpoint converters fill one from a template)."""
    if isinstance(tree, Mapping):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.array(tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree)


def _sorted(tree):
    """Every map's keys in order, as JAX's tree utilities leave a tree (so
    that flax's ``to_bytes`` of the JAX tree and the port's encoder of this
    one write the same bytes)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _is_norm(mod: torch.nn.Module) -> bool:
    from .models.blocks import GroupNorm, GroupNorm1, LayerNorm

    return isinstance(mod, (LayerNorm, GroupNorm, GroupNorm1))


def _flax_components(name: str):
    """A dotted module name as flax path components: ``a.b.3.c`` ->
    ``a, b_3, c``."""
    comps = []
    for part in name.split(".") if name else ():
        if part.isdigit():
            comps[-1] = f"{comps[-1]}_{part}"
        else:
            comps.append(part)
    return comps
