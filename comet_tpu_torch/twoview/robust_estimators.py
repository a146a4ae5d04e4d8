"""The robust-estimator plugin layer (the glue-factory pattern).

Counterpart of ``comet_tpu/twoview/robust_estimators.py`` (the reference's
gluefactory/robust_estimators/base_estimator.py:1-40, load_estimator, and
the per-backend modules homography/{opencv,poselib,homography_est}.py,
relative_pose/{opencv,poselib,pycolmap}.py): every backend is one of this
package's batched RANSACs (``estimators``, ``solvers``), chosen by name
through one config-merged interface.

``get_estimator(type, name)(conf)({"m_kpts0": ...})`` -> ``{"success",
"M_0to1", "inliers"}``; relative-pose backends return ``(R, t)`` as
``M_0to1``. Inputs may be numpy arrays (floating ones become float32, as
``jnp.asarray`` makes them) or tensors: an estimator runs where its tensors
live, and numpy inputs go to the card unless it was made with
``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device


class BaseEstimator:
    """Config-merged estimator (base_estimator.py:6-33 without OmegaConf: a
    plain dict merge, read from ``self.conf``)."""

    base_default_conf: Dict[str, Any] = {"ransac_th": 3.0, "seed": 0, "num_hypotheses": 128}
    default_conf: Dict[str, Any] = {}
    required_data_keys: Tuple[str, ...] = ()

    def __init__(self, conf: Optional[Dict[str, Any]] = None, device=None):
        merged = {**self.base_default_conf, **self.default_conf, **(conf or {})}
        unknown = set(merged) - set(self.base_default_conf) - set(self.default_conf)
        if unknown:
            raise KeyError(f"unknown conf keys {sorted(unknown)} for {type(self).__name__}")
        self.conf = merged
        self.device = device

    def __call__(self, data: Dict[str, Any]) -> Dict[str, Any]:
        missing = [k for k in self.required_data_keys if k not in data]
        if missing:
            raise KeyError(f"{type(self).__name__} requires {missing}")
        return self._forward(data)

    def _device(self, data: Dict[str, Any]) -> torch.device:
        for key in self.required_data_keys:
            if isinstance(data[key], torch.Tensor):
                return data[key].device
        return resolve_device(self.device, type(self).__name__)

    def _tensor(self, x, device: torch.device, dtype=None) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x if dtype is None else x.to(dtype)
        x = np.asarray(x)
        if dtype is None and np.issubdtype(x.dtype, np.floating):
            dtype = torch.float32
        return torch.as_tensor(x, dtype=dtype, device=device)

    def _generator(self, device: torch.device) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(self.conf["seed"])


_ESTIMATORS: Dict[Tuple[str, str], type] = {}


def register_estimator(kind: str, name: str) -> Callable[[type], type]:
    def deco(cls):
        _ESTIMATORS[(kind, name)] = cls
        return cls

    return deco


def load_estimator(kind: str, name: str) -> type:
    """The reference's ``load_estimator(type, estimator)``."""
    try:
        return _ESTIMATORS[(kind, name)]
    except KeyError:
        have = sorted(n for k, n in _ESTIMATORS if k == kind)
        raise KeyError(f"no {kind} estimator '{name}'; have {have}")


def get_estimator(kind: str, name: str, conf: Optional[Dict[str, Any]] = None, device=None):
    return load_estimator(kind, name)(conf, device=device)


def list_estimators(kind: Optional[str] = None):
    return sorted((k, n) for k, n in _ESTIMATORS if kind is None or k == kind)


@register_estimator("homography", "ransac")
class RansacHomographyEstimator(BaseEstimator):
    """Batched-hypothesis DLT RANSAC and inlier refit
    (OpenCVHomographyEstimator's surface, homography/opencv.py:8-53)."""

    default_conf = {"ransac_th": 3.0}
    required_data_keys = ("m_kpts0", "m_kpts1")

    def _forward(self, data):
        from .estimators import estimate_homography_ransac

        dev = self._device(data)
        res = estimate_homography_ransac(
            self._tensor(data["m_kpts0"], dev), self._tensor(data["m_kpts1"], dev),
            generator=self._generator(dev),
            # the transfer error is in squared pixels
            threshold=float(self.conf["ransac_th"]) ** 2,
            num_hypotheses=self.conf["num_hypotheses"],
        )
        return {"success": bool(res.score >= 4), "M_0to1": res.model, "inliers": res.inliers}


@register_estimator("homography", "dlt")
class DltHomographyEstimator(BaseEstimator):
    """Plain (optionally weighted) normalized DLT: the minimal backend, for
    pre-filtered correspondences."""

    default_conf = {"ransac_th": 3.0}
    required_data_keys = ("m_kpts0", "m_kpts1")

    def _forward(self, data):
        from .estimators import homography_transfer_error, run_homography_dlt

        dev = self._device(data)
        p0 = self._tensor(data["m_kpts0"], dev)
        p1 = self._tensor(data["m_kpts1"], dev)
        weights = data.get("weights")
        h = run_homography_dlt(p0, p1, weights=None if weights is None
                               else self._tensor(weights, dev))
        # squared pixel error
        inl = homography_transfer_error(h, p0, p1) < float(self.conf["ransac_th"]) ** 2
        return {"success": bool(inl.sum() >= 4), "M_0to1": h, "inliers": inl}


def _relpose_from_essential(res, r, t, n_pts):
    ok = bool(res.score >= 5)
    return {
        "success": ok,
        "M_0to1": (r, t),
        "inliers": res.inliers if ok else torch.zeros(n_pts, dtype=torch.bool,
                                                      device=res.inliers.device),
        "E": res.model,
    }


class _EssentialEstimator(BaseEstimator):
    """Relative pose from an essential-matrix RANSAC; ``ransac_th`` is in
    pixels, normalized by the mean focal as the reference does
    (relative_pose/opencv.py:31-32), then squared: the Sampson distance is
    squared (two_view_geo/utils.py:90)."""

    default_conf = {"ransac_th": 0.5}
    required_data_keys = ("m_kpts0", "m_kpts1", "K0", "K1")

    def _forward(self, data):
        dev = self._device(data)
        k0 = self._tensor(data["K0"], dev, torch.float32)
        k1 = self._tensor(data["K1"], dev, torch.float32)
        f_mean = (k0[0, 0] + k0[1, 1] + k1[0, 0] + k1[1, 1]) / 4.0
        res, r, t = self._ransac(
            self._tensor(data["m_kpts0"], dev), self._tensor(data["m_kpts1"], dev), k0, k1,
            generator=self._generator(dev),
            threshold=float(self.conf["ransac_th"] / f_mean) ** 2,
            num_hypotheses=self.conf["num_hypotheses"],
        )
        return _relpose_from_essential(res, r, t, data["m_kpts0"].shape[0])


@register_estimator("relative_pose", "ransac")
class RansacRelativePoseEstimator(_EssentialEstimator):
    """Essential-matrix RANSAC (normalized 8-point) and the cheirality
    motion (OpenCVRelativePoseEstimator's surface, relative_pose/opencv.py:10-66)."""

    @staticmethod
    def _ransac(*args, **kwargs):
        from .estimators import estimate_essential_ransac

        return estimate_essential_ransac(*args, **kwargs)


@register_estimator("relative_pose", "nister")
class NisterRelativePoseEstimator(_EssentialEstimator):
    """Minimal-sample Nistér 5-point RANSAC (the poselib backend's
    capability, relative_pose/poselib.py) through ``solvers.run_5point``."""

    default_conf = {"ransac_th": 0.5, "num_hypotheses": 64}

    @staticmethod
    def _ransac(*args, **kwargs):
        from .solvers import estimate_essential_5point_ransac

        return estimate_essential_5point_ransac(*args, **kwargs)


@register_estimator("fundamental", "ransac")
class RansacFundamentalEstimator(BaseEstimator):
    """8-point Sampson RANSAC with the inlier refit
    (two_view_geo/fundamental.py:43 capability)."""

    default_conf = {"ransac_th": 1.0}
    required_data_keys = ("m_kpts0", "m_kpts1")

    def _forward(self, data):
        from .estimators import estimate_fundamental_ransac

        dev = self._device(data)
        res = estimate_fundamental_ransac(
            self._tensor(data["m_kpts0"], dev), self._tensor(data["m_kpts1"], dev),
            generator=self._generator(dev),
            threshold=float(self.conf["ransac_th"]) ** 2,  # the squared Sampson distance
            num_hypotheses=self.conf["num_hypotheses"],
        )
        return {"success": bool(res.score >= 8), "M_0to1": res.model, "inliers": res.inliers}
