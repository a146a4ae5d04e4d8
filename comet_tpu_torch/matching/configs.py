"""Named experiment configurations of the matching stack.

Counterpart of ``comet_tpu/matching/configs.py`` (gluefactory/configs/*.yaml:
an extractor paired with a matcher, plus ground-truth and training settings).
``EXPERIMENTS`` is the JAX package's, whole, so ``match --list`` names the
same 11 experiments, and each builds and runs.

:class:`MatcherWrapper` is the port's counterpart of ``wrap_flax_matcher``:
it adapts a matcher module to the pipeline's ``(feats0, feats1) -> matches``
contract, normalizing the pixel keypoints to [-1, 1] by the image size and
passing the validity masks and nothing else, as the JAX wrapper does (so
SuperGlue runs with detector scores of 1); a matcher that takes lines
(GlueStick) also gets the normalized segments, the line descriptors and the
line validity. The module is built at the first call, when the
descriptors' widths are known: with random weights drawn on the
CPU from ``torch.Generator().manual_seed(seed)`` (JAX draws from
``PRNGKey(seed)``), or with the flax tree put in ``holder["params"]``
(``experiments.load_experiment_into_pipeline``), then copied to the
features' device, so the card and the CPU hold the same weights.
"""

from __future__ import annotations

import copy
import inspect
from typing import Any, Dict

import torch
import torch.nn as nn

from . import (  # noqa: F401 (registers models)
    backbones,
    cache_loader,
    deeplsd,
    depth_gt,
    extractors,
    gluestick,
    lightglue,
    lines,
    matchers,
    sift,
    superglue,
)
from .registry import TwoViewPipeline, get_model

# Every experiment: {extractor: {name, ...conf}, matcher: {name, ...conf},
# ground_truth: {...}, train: {...}}; inference reads the extractor and
# matcher blocks only.
_BASE_TRAIN = {
    "seed": 0,
    "epochs": 40,
    "lr": 1e-4,
    "batch_size": 32,
    "homography": {"difficulty": 0.7, "max_angle": 45.0},
}

EXPERIMENTS: Dict[str, Dict[str, Any]] = {
    # -- point extractors + NN (evaluation baselines, *+NN.yaml) --
    "superpoint+nn": {
        "extractor": {"name": "extractor_superpoint", "max_keypoints": 512},
        "matcher": {"name": "matcher_nn", "threshold": 0.0},
        "ground_truth": {"th_positive": 3.0, "th_negative": 3.0},
        "train": None,  # eval-only pairing
    },
    "sift+nn": {
        "extractor": {"name": "extractor_sift", "max_keypoints": 512},
        "matcher": {"name": "matcher_nn", "threshold": 0.0},
        "ground_truth": {"th_positive": 3.0, "th_negative": 3.0},
        "train": None,
    },
    "aliked+nn": {
        "extractor": {"name": "extractor_aliked", "max_keypoints": 512},
        "matcher": {"name": "matcher_nn", "threshold": 0.0},
        "ground_truth": {"th_positive": 3.0, "th_negative": 3.0},
        "train": None,
    },
    "disk+nn": {
        "extractor": {"name": "extractor_disk", "max_keypoints": 512},
        "matcher": {"name": "matcher_nn", "threshold": 0.0},
        "ground_truth": {"th_positive": 3.0, "th_negative": 3.0},
        "train": None,
    },
    "keynet+nn": {
        "extractor": {"name": "extractor_keynet", "max_keypoints": 512},
        "matcher": {"name": "matcher_nn", "threshold": 0.0},
        "ground_truth": {"th_positive": 3.0, "th_negative": 3.0},
        "train": None,
    },
    # -- trainable matchers on homography GT (*_homography.yaml) --
    "superpoint+lightglue_homography": {
        "extractor": {"name": "extractor_superpoint", "max_keypoints": 512},
        "matcher": {
            "name": "matcher_lightglue", "depth": 9, "dim": 256,
            "filter_threshold": 0.1,
        },
        "ground_truth": {"th_positive": 3.0, "th_negative": 5.0},
        "train": dict(_BASE_TRAIN),
    },
    "sift+lightglue_homography": {
        "extractor": {"name": "extractor_sift", "max_keypoints": 512},
        "matcher": {
            "name": "matcher_lightglue", "depth": 9, "dim": 256,
            "filter_threshold": 0.1,
        },
        "ground_truth": {"th_positive": 3.0, "th_negative": 5.0},
        "train": dict(_BASE_TRAIN),
    },
    "aliked+lightglue_homography": {
        "extractor": {"name": "extractor_aliked", "max_keypoints": 512},
        "matcher": {
            "name": "matcher_lightglue", "depth": 9, "dim": 256,
            "filter_threshold": 0.1,
        },
        "ground_truth": {"th_positive": 3.0, "th_negative": 5.0},
        "train": dict(_BASE_TRAIN),
    },
    "superpoint+superglue": {
        "extractor": {"name": "extractor_superpoint", "max_keypoints": 512},
        "matcher": {
            "name": "matcher_superglue", "depth": 9, "dim": 256,
            "sinkhorn_iters": 50, "filter_threshold": 0.2,
        },
        "ground_truth": {"th_positive": 3.0, "th_negative": 5.0},
        "train": dict(_BASE_TRAIN),
    },
    # -- line + point wireframes (superpoint+lsd+gluestick.yaml) --
    "superpoint+lsd+gluestick": {
        "extractor": {
            "name": "extractor_wireframe",
            "point_extractor": "extractor_superpoint",
            "max_lines": 64,
        },
        "matcher": {"name": "matcher_gluestick", "depth": 6, "dim": 128},
        "ground_truth": {"th_positive": 3.0, "th_negative": 5.0},
        "train": dict(_BASE_TRAIN),
    },
    "deeplsd+gluestick": {
        "extractor": {
            "name": "extractor_wireframe",
            "point_extractor": "extractor_superpoint",
            "line_detector": "lines_deeplsd",
            "max_lines": 64,
        },
        "matcher": {"name": "matcher_gluestick", "depth": 6, "dim": 128},
        "ground_truth": {"th_positive": 3.0, "th_negative": 5.0},
        "train": dict(_BASE_TRAIN),
    },
}


def list_experiments():
    return sorted(EXPERIMENTS)


def get_experiment(name: str) -> Dict[str, Any]:
    """Deep copy of a named experiment config (safe to mutate)."""
    if name not in EXPERIMENTS:
        raise KeyError(f"unknown experiment '{name}'; have {list_experiments()}")
    return copy.deepcopy(EXPERIMENTS[name])


class MatcherWrapper:
    """``(feats0, feats1) -> matches`` over a matcher module (see the
    module docstring). ``holder["params"]`` takes a flax tree of the JAX
    package's matcher; the next call builds the module from it."""

    def __init__(self, matcher: nn.Module, image_hw, seed: int = 0):
        h, w = image_hw
        self.matcher, self.seed = matcher, seed
        self.scale = (max(w - 1.0, 1.0), max(h - 1.0, 1.0))
        self.takes_lines = "lines0" in inspect.signature(matcher.forward).parameters
        self.holder = {"params": None}
        self._built = None  # (params id, input widths, CPU module)
        self._on = {}

    def module(self, device: torch.device, **in_dims) -> nn.Module:
        """The matcher for descriptors of the widths ``in_dims`` (``in_dim``,
        and ``line_in_dim`` for a matcher that takes lines) on ``device``."""
        from ..models.blocks import init_params
        from ..weights import module_params_from_jax

        key = (id(self.holder["params"]), tuple(sorted(in_dims.items())))
        if self._built is None or self._built[:2] != key:
            m = type(self.matcher)(**self.matcher.conf, **in_dims)
            init_params(m, torch.Generator().manual_seed(self.seed))
            if self.holder["params"] is not None:
                m.load_state_dict(module_params_from_jax(self.holder["params"], m))
            self._built, self._on = (*key, m.eval()), {}
        if device not in self._on:
            self._on[device] = copy.deepcopy(self._built[2]).to(device)
        return self._on[device]

    def __call__(self, f0, f1):
        sx, sy = self.scale

        def norm(k):  # per coordinate: no constant tensor copied to the device
            k = k.float()
            return torch.stack([k[..., 0] / sx, k[..., 1] / sy], dim=-1) * 2.0 - 1.0

        args = [norm(f0["keypoints"]), f0["descriptors"], norm(f1["keypoints"]),
                f1["descriptors"]]
        kw = {"valid0": f0.get("valid"), "valid1": f1.get("valid")}
        in_dims = {"in_dim": f0["descriptors"].shape[-1]}
        if self.takes_lines:  # GlueStick: the joint point and line token set
            args += [norm(f0["lines"]), f0["line_descriptors"], norm(f1["lines"]),
                     f1["line_descriptors"]]
            kw.update(lvalid0=f0.get("line_valid"), lvalid1=f1.get("line_valid"))
            in_dims["line_in_dim"] = f0["line_descriptors"].shape[-1]
        module = self.module(f0["keypoints"].device, **in_dims)
        with torch.no_grad():
            return module(*args, **kw)


def build_pipeline(name: str, image_hw=None, **overrides) -> TwoViewPipeline:
    """The extractor and matcher of a named experiment; ``overrides`` update
    its top-level blocks (``matcher={"threshold": 0.2}``). A matcher module
    (LightGlue, SuperGlue, GlueStick) is wrapped by :class:`MatcherWrapper` when
    ``image_hw`` is given, and returned as the module otherwise."""
    conf = get_experiment(name)
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(conf.get(k), dict):
            conf[k].update(v)
        else:
            conf[k] = v
    ext_conf = dict(conf["extractor"])
    extractor = get_model(ext_conf.pop("name"), **ext_conf)
    mat_conf = dict(conf["matcher"])
    matcher = get_model(mat_conf.pop("name"), **mat_conf)
    if image_hw is not None and isinstance(matcher, nn.Module):
        matcher = MatcherWrapper(matcher, image_hw)
    return TwoViewPipeline(extractor, matcher)
