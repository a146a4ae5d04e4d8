"""The system under test, and the weights both it and the reference load.

The program is the port, ``comet_tpu_torch``: ``models.build_comet`` on the
configuration file's sizes and kernel route, the one-time cast of
``utils.serialization.cast_params_for_inference`` and ``COMET.forward``
under ``torch.inference_mode()``. The port is imported inside the functions
here, so that the reference and the tests import this module without it.

The weights are the benchmark's own: one state dict under the port's
parameter names, drawn from the seed on the device in one call and cut into
parameters (``make_state``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# keys of a configuration file that are not the port's CometConfig fields
_FILE_ONLY = ("name", "source", "reduced", "assumed", "route", "limits")


def comet_config(cfg: dict):
    """The port's CometConfig for a configuration file's dict."""
    from comet_tpu_torch.config import CameraConfig, CometConfig, TrackerConfig, TrainConfig

    top = {k: v for k, v in cfg.items() if k not in _FILE_ONLY}
    return CometConfig(
        name=cfg["name"],
        **{k: v for k, v in top.items() if k not in ("tracker", "camera", "train")},
        tracker=TrackerConfig(**cfg["tracker"]), camera=CameraConfig(**cfg["camera"]),
        train=TrainConfig(**cfg.get("train", {})),
    )


def parameter_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of the port's parameters at this configuration, from a
    model on the meta device (no memory)."""
    from comet_tpu_torch.models import build_comet

    model = build_comet(comet_config(cfg), device="meta")
    return {name: tuple(p.shape) for name, p in model.named_parameters()}


def _init_rule(name: str, shape) -> Tuple[float, float]:
    """(scale, shift) of one parameter's standard normal draw: kernels
    N(0, 1/fan_in); norm scales and LayerScale gammas 1 + N(0, 0.1^2);
    biases and tokens N(0, 0.1^2)."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) >= 2 and leaf in ("weight", "in_proj_weight"):
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if leaf in ("weight", "gamma"):
        return 0.1, 1.0
    return 0.1, 0.0


def make_state(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The benchmark's weights: one standard normal draw of every parameter
    at once on ``device`` from ``seed``, each parameter's slice scaled and
    shifted by its rule, then cast to ``dtype`` in one call. Returns views of
    one flat tensor, in name order."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    views = dict(zip(names, (v.view(shapes[n]) for n, v in zip(names, flat.split(sizes)))))
    for name, v in views.items():
        scale, shift = _init_rule(name, shapes[name])
        v.mul_(scale).add_(shift)
    flat = flat.to(dtype)
    return dict(zip(names, (v.view(shapes[n]) for n, v in zip(names, flat.split(sizes)))))


def build_training(cfg: dict, state: Dict[str, torch.Tensor], device):
    """The port's model on ``device`` with ``state`` loaded as its float32
    master parameters (it computes in the compute dtype): what
    ``training.loop.build_train_step`` trains."""
    from comet_tpu_torch.config import KernelRoute
    from comet_tpu_torch.models import build_comet

    model = build_comet(comet_config(cfg), device="meta", route=KernelRoute(**cfg["route"]))
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return model


def build_inference(cfg: dict, state: Dict[str, torch.Tensor], device):
    """The same model with its parameters cast once to the compute dtype, in
    eval mode: what ``cli.py bench`` serves."""
    from comet_tpu_torch.utils.serialization import cast_params_for_inference

    return cast_params_for_inference(build_training(cfg, state, device),
                                     comet_config(cfg).dtype).eval()
