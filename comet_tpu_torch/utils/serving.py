"""Serving export: the COMET forward as a ``torch.export`` artifact.

Counterpart of ``comet_tpu/utils/serving.py``. The reference deploys by
re-importing the whole torch model class; JAX serializes the jitted graph
with ``jax.export``. Here the forward is traced by ``torch.export`` into an
``ExportedProgram`` whose graph calls the hand-written kernels as the
registered operators of ``ops/library.py`` (``comet::attention``,
``comet::attn_block``, ...), so the served program launches the same
kernels as the eager model.

- **Weights are a runtime input.** The exported signature is
  ``(params, images, queries) -> {pred_pose_enc, pred_track, ...}`` with
  ``params`` a dict keyed by the port's state-dict names (which mirror the
  flax paths), so one artifact serves every checkpoint of its
  configuration, and the artifact holds the graph and a few constants, not
  the weights. :func:`params_from_file` restores a ``.pt`` weight file by
  name into that input, :func:`params_from_msgpack` the JAX package's flax
  ``.msgpack`` (read without JAX).
- **The serving side** imports this module and ``comet_tpu_torch.ops``
  (which registers the operators), never ``comet_tpu_torch.models``:
  :func:`load_exported` then :func:`serving_call`.
- **One artifact per device.** The graph holds the device of its
  constants; an artifact exported for ``cuda`` raises without a card.
- **Manifest.** :func:`save_exported` writes ``<path>.json`` beside the
  artifact: versions, device, the kernel sources' digest (the counterpart of
  JAX's recorded ``jax_version`` pin: a served graph is only as good as the
  kernels it calls), sizes and the model block. :func:`load_exported`
  refuses an artifact without its manifest, or one whose digest is not the
  kernel library's in this checkout: the graph would call kernels it was
  never exported with.

The trace is non-strict ``torch.export`` (Python runs as written, on fake
tensors): no ahead-of-time compilation, so every op but the kernels runs
the same ATen kernels as the eager model.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn as nn

from ..ops import kernels
from .serialization import is_msgpack, read_msgpack

__all__ = [
    "export_forward", "export_windowed", "save_exported", "load_exported", "serving_call",
    "params_from_file", "params_from_msgpack",
]

STRICT = False


class _Forward(nn.Module):
    """``model(images, queries)`` with the weights as an input. The model is
    held outside the module tree, so its own tensors are not lifted into
    the artifact."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.__dict__["model"] = model

    def forward(self, params, images, queries):
        return torch.func.functional_call(self.model, params, (images, queries), strict=True)


class _Windowed(_Forward):
    """The windowed chain of ``models/windowed.py::windowed_forward_scan``
    with the weights and the ratio as inputs."""

    def __init__(self, model: nn.Module, window_len: int):
        super().__init__(model)
        self.window_len = window_len

    def forward(self, params, images, queries, ratio):
        from ..models.windowed import windowed_forward_scan

        return windowed_forward_scan(lambda im, q: _Forward.forward(self, params, im, q),
                                     images, queries, self.window_len, ratio)


def _example_params(model: nn.Module, device, params_dtype) -> Dict[str, torch.Tensor]:
    out = {}
    for name, t in model.state_dict().items():
        if params_dtype is not None and t.is_floating_point():
            t = t.to(params_dtype)
        out[name] = t.to(device)
    return out


def _device(model: nn.Module, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return next(model.parameters()).device


def _drop_no_ops(graph: torch.fx.Graph) -> None:
    """Remove the dtype checks the trace inserts before each ``.to(dtype)``
    (``aten._assert_tensor_metadata``) and every ``.to(dtype)`` whose input
    already has that dtype, which returns its input as in eager mode: two
    of every five nodes of the forward, each a Python call per request on a
    host-bound forward; the numbers do not change."""
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target is torch.ops.aten.to.dtype and len(node.args) == 2
              and not node.kwargs and node.args[0].meta["val"].dtype == node.args[1]
              and all(user.op != "output" for user in node.users)):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)


def _export(module: nn.Module, args: tuple) -> torch.export.ExportedProgram:
    """Trace ``module`` at ``args`` and drop the trace's no-op nodes. The
    program keeps neither the example inputs (``torch.export.save`` would
    write the weights with them) nor the exporter's stack traces (its
    source paths)."""
    with torch.no_grad():
        exported = torch.export.export(module, args, strict=STRICT)
    exported.example_inputs = None
    for gm in exported.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            _drop_no_ops(gm.graph)
            for node in gm.graph.nodes:
                node.meta.pop("stack_trace", None)
            gm.recompile()
    return exported


def export_forward(model: nn.Module, cfg, batch: int = 1, device=None,
                   params_dtype: Optional[torch.dtype] = None) -> torch.export.ExportedProgram:
    """Trace ``model``'s forward for ``batch`` requests of ``cfg``'s shapes
    on ``device`` (default: the model's). Inputs, JAX's contract: the
    weights dict, images [B, S, H, W, 3] ImageNet-normalised f32, queries
    [B, N, 2] frame-0 pixels. ``params_dtype``: the dtype a served
    checkpoint is cast to (``cast_params_for_inference``'s one-time cast);
    None keeps the model's dtypes."""
    dev = _device(model, device)
    s, hw, n = cfg.seqlen, cfg.img_size, cfg.track_num
    args = (_example_params(model, dev, params_dtype),
            torch.zeros(batch, s, hw, hw, 3, device=dev),
            torch.zeros(batch, n, 2, device=dev))
    return _export(_Forward(model), args)


def export_windowed(model: nn.Module, cfg, total_frames: int, device=None,
                    params_dtype: Optional[torch.dtype] = None) -> torch.export.ExportedProgram:
    """The windowed chain for sequences of exactly ``total_frames`` frames
    as one artifact: ``(params, images [1, T, H, W, 3], queries [1, N, 2],
    ratio [] f32) -> (pose_enc [1, T, 7], tracks [1, T, N, 2])``, windows of
    ``cfg.seqlen`` frames with the schedule fixed at export. Raises for
    fewer frames than one window."""
    if total_frames < cfg.seqlen:
        raise ValueError(f"export_windowed: total_frames {total_frames} < seqlen {cfg.seqlen}: "
                         "export the forward for sequences of at most one window")
    dev = _device(model, device)
    hw, n = cfg.img_size, cfg.track_num
    args = (_example_params(model, dev, params_dtype),
            torch.zeros(1, total_frames, hw, hw, 3, device=dev),
            torch.zeros(1, n, 2, device=dev), torch.ones((), device=dev))
    return _export(_Windowed(model, cfg.seqlen), args)


def _inputs(exported: torch.export.ExportedProgram) -> tuple:
    """The artifact's inputs as (args, kwargs), each leaf the traced fake
    tensor (shape, dtype, device) of that input."""
    user = set(exported.graph_signature.user_inputs)
    vals = [node.meta["val"] for node in exported.graph.nodes
            if node.op == "placeholder" and node.name in user]
    return torch.utils._pytree.tree_unflatten(vals, exported.call_spec.in_spec)


def artifact_device(exported: torch.export.ExportedProgram) -> torch.device:
    """The device the artifact was exported for (its images input's)."""
    return _inputs(exported)[0][1].device


def save_exported(exported: torch.export.ExportedProgram, path: str, cfg=None,
                  extra_manifest: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Write the artifact to ``path`` (``torch.export.save``) and its
    manifest to ``<path>.json``; returns the manifest."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(exported, path)
    (params, *_), _ = _inputs(exported)
    manifest: Dict[str, Any] = {
        "format": "torch.export",
        "strict": STRICT,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": str(artifact_device(exported)),
        "kernels_digest": kernels._digest(),
        "artifact_bytes": os.path.getsize(path),
        "n_inputs": len(exported.graph_signature.user_inputs),
        "n_outputs": len(exported.graph_signature.user_outputs),
        "n_params": sum(t.numel() for t in params.values()),
    }
    if cfg is not None:
        manifest["model"] = {"seqlen": cfg.seqlen, "img_size": cfg.img_size,
                             "track_num": cfg.track_num, "compute_dtype": cfg.compute_dtype}
    if extra_manifest:
        manifest.update(extra_manifest)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return manifest


def load_exported(path: str) -> torch.export.ExportedProgram:
    """Read an artifact written by :func:`save_exported`, after checking its
    manifest ``<path>.json``: it must be there, and its ``kernels_digest``
    must be the digest of this checkout's kernel sources
    (``ops.kernels._digest()``), else this raises, naming both digests. The
    operators must be registered first: this module imports
    ``comet_tpu_torch.ops``."""
    try:
        with open(path + ".json") as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(f"{path}: no manifest {path}.json beside the artifact; without "
                                "it the kernels the graph was exported with are unknown") from None
    digest, ours = manifest.get("kernels_digest"), kernels._digest()
    if digest != ours:
        raise RuntimeError(f"{path}: exported with the kernel sources of digest {digest}, and "
                           f"this checkout's kernels have digest {ours}; export it again")
    return torch.export.load(path)


def serving_call(exported: torch.export.ExportedProgram) -> Callable:
    """The artifact as a callable, ``out = fn(params, images, queries)`` (or
    ``fn(params, images, queries, ratio)`` for a windowed artifact), run
    under ``torch.inference_mode``; ``params`` is any mapping from the
    state-dict names to tensors. An artifact exported for CUDA raises
    without a card."""
    dev = artifact_device(exported)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serving_call: the artifact was exported for cuda and there is no "
                           "CUDA device")
    names = list(_inputs(exported)[0][0])
    module = exported.module()

    def call(params, *args):
        with torch.inference_mode():
            return module({name: params[name] for name in names}, *args)

    return call


def _fill(state, exported: torch.export.ExportedProgram, path: str) -> Dict[str, torch.Tensor]:
    """``state`` (name -> tensor) as the artifact's ``params`` input: each
    tensor cast to the dtype and moved to the device the artifact takes.
    Raises, naming the keys, for a missing or an unexpected name, a shape
    that differs or a dtype that cannot be cast."""
    (want, *_), _ = _inputs(exported)
    missing, unexpected = sorted(set(want) - set(state)), sorted(set(state) - set(want))
    if missing or unexpected:
        raise KeyError(f"{path}: missing {missing}, unexpected {unexpected}")
    out = {}
    for name, spec in want.items():
        t = state[name]
        if tuple(t.shape) != tuple(spec.shape):
            raise ValueError(f"{path}: {name} has shape {tuple(t.shape)}, the artifact takes "
                             f"{tuple(spec.shape)}")
        if not torch.can_cast(t.dtype, spec.dtype):
            raise TypeError(f"{path}: {name} has dtype {t.dtype}, which does not cast to the "
                            f"artifact's {spec.dtype}")
        out[name] = t.to(device=spec.device, dtype=spec.dtype)
    return out


def params_from_file(path: str, exported: torch.export.ExportedProgram) -> Dict[str, torch.Tensor]:
    """Restore a weight file written by ``utils.serialization.save_params``
    (``.pt``) into the artifact's ``params`` input, by name (:func:`_fill`'s
    checks); a ``.msgpack`` is refused (:func:`params_from_msgpack` reads
    it)."""
    if is_msgpack(path):
        raise ValueError(f"{path}: a flax .msgpack is the JAX package's weight format; read it "
                         "with params_from_msgpack")
    return _fill(torch.load(path, map_location="cpu", weights_only=True), exported, path)


def params_from_msgpack(path: str,
                        exported: torch.export.ExportedProgram) -> Dict[str, torch.Tensor]:
    """Restore the JAX package's weight file (a flax ``.msgpack``, the
    counterpart of ``comet_tpu/utils/serving.py``'s ``params_from_msgpack``)
    into the artifact's ``params`` input: the tree mapped onto the port's
    names by ``weights.state_dict_from_flax`` (which raises on a leaf of no
    parameter and on a parameter left unfilled), then :func:`_fill`'s
    checks and casts. Needs no model: only the artifact's input shapes."""
    from ..weights import state_dict_from_flax

    (want, *_), _ = _inputs(exported)
    state = state_dict_from_flax(read_msgpack(path), {k: v.shape for k, v in want.items()})
    return _fill(state, exported, path)
