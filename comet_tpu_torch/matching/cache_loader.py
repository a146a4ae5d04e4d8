"""Cached features served as a model, and the triplet pipeline.

Counterpart of ``comet_tpu/matching/cache_loader.py`` (glue-factory's
models/cache_loader.py and triplet_pipeline.py): :class:`CacheLoader`
(``cache_loader``) reads one item's group of an ``.h5`` prediction cache
(``eval_pipeline.load_predictions``; h5py is imported in the call and its
absence raises), casts the floating fields, rescales the geometric ones by
the item's ``scales`` and pads the local features to a fixed count
(:func:`pad_local_features`). It returns numpy arrays, as the JAX package's
does. :class:`TripletPipeline` runs the extractor once per view and the
matcher over the three pairs.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .eval_pipeline import load_predictions
from .registry import register_model

__all__ = ["pad_to_length", "pad_local_features", "CacheLoader", "TripletPipeline"]


def pad_to_length(
    x: np.ndarray,
    length: int,
    axis: int = -2,
    mode: str = "zeros",
    bounds=(None, None),
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """``x`` padded along ``axis`` to ``length``: "zeros", "ones", "random"
    (uniform over the array's range, or ``bounds``) or "random_c" (uniform
    over each channel's range: fake keypoints inside the real ones'
    bounding box). ``rng`` defaults to ``np.random.default_rng(0)``."""
    d = x.shape[axis]
    if d > length:
        raise ValueError(f"cannot pad axis of size {d} down to {length}")
    if d == length:
        return x
    rng = rng or np.random.default_rng(0)
    shape = list(x.shape)
    shape[axis] = length - d
    low, high = bounds
    if mode == "zeros":
        xn = np.zeros(shape, x.dtype)
    elif mode == "ones":
        xn = np.ones(shape, x.dtype)
    elif mode == "random":
        # an empty input takes the bounds, else [0, 1)
        lo = low if low is not None else (float(x.min()) if d > 0 else 0.0)
        hi = high if high is not None else (float(x.max()) if d > 0 else 1.0)
        xn = rng.uniform(lo, hi, shape).astype(x.dtype)
    elif mode == "random_c":
        cols = []
        cshape = shape[:-1] + [1]
        for i in range(shape[-1]):
            lo = float(x[..., i].min()) if d > 0 else (low or 0.0)
            hi = float(x[..., i].max()) if d > 0 else (high or 1.0)
            cols.append(rng.uniform(lo, hi, cshape))
        xn = np.concatenate(cols, -1).astype(x.dtype)
    else:
        raise ValueError(mode)
    return np.concatenate([x, xn], axis=axis)


_LOCAL_FEATURE_PAD = {
    "keypoints": (-2, "random_c"),
    "keypoint_scores": (-1, "zeros"),
    "descriptors": (-2, "random"),
    "scales": (-1, "zeros"),
    "oris": (-1, "zeros"),
    "depth_keypoints": (-1, "zeros"),
    "valid_depth_keypoints": (-1, "zeros"),
}


def pad_local_features(pred: Dict[str, np.ndarray], length: int) -> Dict:
    """Every known local-feature field padded to ``length`` keypoints."""
    out = dict(pred)
    for key, (axis, mode) in _LOCAL_FEATURE_PAD.items():
        if key in out:
            out[key] = pad_to_length(np.asarray(out[key]), length, axis, mode)
    return out


class CacheLoader:
    """Cached predictions served as a model. ``path`` may be a format string
    over the data dict's fields ("exports/{scene}/preds.h5"); the item's
    "name" selects the group. Floating arrays become ``numeric_type``;
    fields starting with a ``scale`` pattern are multiplied by the item's
    "scales"."""

    def __init__(
        self,
        path: str,
        data_keys: Optional[Sequence[str]] = None,
        scale: Sequence[str] = ("keypoints", "lines", "orig_lines"),
        padding_length: Optional[int] = None,
        padding_fn=pad_local_features,
        numeric_type: str = "float32",
    ):
        self.path = path
        self.data_keys = list(data_keys) if data_keys is not None else None
        self.scale = tuple(scale)
        self.padding_length = padding_length
        self.padding_fn = padding_fn
        self.numeric_dtype = {None: None, "none": None, "float16": np.float16,
                              "float32": np.float32, "float64": np.float64}[numeric_type]

    def __call__(self, data: Dict) -> Dict[str, np.ndarray]:
        import string

        var_names = [f[1] for f in string.Formatter().parse(self.path) if f[1]]
        pred = load_predictions(self.path.format(**{k: data[k] for k in var_names}),
                                data["name"])
        if self.data_keys is not None:
            pred = {k: pred[k] for k in self.data_keys if k in pred}
        if self.numeric_dtype is not None:
            pred = {k: v.astype(self.numeric_dtype) if np.issubdtype(v.dtype, np.floating)
                    else v for k, v in pred.items()}
        for k in list(pred):
            for pattern in self.scale:
                if k.startswith(pattern) and "scales" in data:
                    scaled = pred[k] * np.asarray(data["scales"])
                    pred[k] = scaled.astype(pred[k].dtype, copy=False)
        if self.padding_length is not None and self.padding_fn is not None:
            pred = self.padding_fn(pred, self.padding_length)
        return pred


register_model(
    "cache_loader",
    {"path": "", "data_keys": None, "padding_length": None, "numeric_type": "float32"},
)(CacheLoader)


class TripletPipeline:
    """The extractor once per view, the matcher over the pairs 0to1, 0to2
    and 1to2; two views without a third image."""

    PAIRS = (("0to1", 0, 1), ("0to2", 0, 2), ("1to2", 1, 2))

    def __init__(self, extractor, matcher):
        self.extractor = extractor
        self.matcher = matcher

    def __call__(self, image0, image1, image2=None):
        if image2 is None:
            feats0 = self.extractor(image0)
            feats1 = self.extractor(image1)
            return {"feats0": feats0, "feats1": feats1, **self.matcher(feats0, feats1)}
        feats = [self.extractor(im) for im in (image0, image1, image2)]
        out = {f"feats{i}": f for i, f in enumerate(feats)}
        for key, i, j in self.PAIRS:
            out[key] = self.matcher(feats[i], feats[j])
        return out
