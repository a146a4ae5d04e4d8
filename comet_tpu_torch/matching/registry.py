"""Config-driven model registry (the glue-factory pattern).

Counterpart of ``comet_tpu/matching/registry.py``: models are declared by
name with a default config dict, and pipelines are assembled from nested
configs. The registry maps names to factories (an ``nn.Module`` class or a
callable) with their merged defaults.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable[..., Any]] = {}
_DEFAULTS: Dict[str, Dict[str, Any]] = {}


def register_model(name: str, default_conf: Dict[str, Any] = None):
    """Decorator: register a factory under ``name`` with default config."""

    def deco(factory):
        _REGISTRY[name] = factory
        _DEFAULTS[name] = dict(default_conf or {})
        return factory

    return deco


def get_model(name: str, **conf):
    """Instantiate a registered model with defaults merged under ``conf``."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; have {sorted(_REGISTRY)}")
    merged = {**_DEFAULTS[name], **conf}
    return _REGISTRY[name](**merged)


def list_models():
    return sorted(_REGISTRY)


class TwoViewPipeline:
    """extractor -> matcher over two images."""

    def __init__(self, extractor, matcher):
        self.extractor = extractor
        self.matcher = matcher

    def __call__(self, image0, image1):
        feats0 = self.extractor(image0)
        feats1 = self.extractor(image1)
        matches = self.matcher(feats0, feats1)
        return {"feats0": feats0, "feats1": feats1, **matches}
