"""Cached-prediction evaluation pipelines: homography (HPatches-style) and
relative pose (MegaDepth-1500-style).

Counterpart of ``comet_tpu/matching/eval_pipeline.py`` (glue-factory's
eval/eval_pipeline.py, utils/export_predictions.py, the AUC helpers of
utils/tools.py and eval/utils.py, eval/hpatches.py and eval/megadepth1500.py):
a pipeline exports its model's predictions per pair to
``<exp_dir>/predictions.h5`` (reused on a rerun), evaluates them into
``results.h5`` and ``summaries.json``, and refuses a cache made under
another data or model config (``conf.json``) unless told to overwrite.

The files are the JAX package's: the same groups, datasets and JSON, the
integers int32 and the floats float32 (its default widths), so each package
reads what the other writes. h5py is imported where a file is read or
written; without it :func:`export_predictions`, :func:`save_eval`,
:func:`load_predictions`, :func:`load_eval` and ``EvalPipeline.run`` raise,
naming the package, and nothing writes another format instead.

A pipeline's model (extractor and matcher), its images, the metrics and the
robust estimators run on the pipeline's ``device`` (the CUDA card unless
``device="cpu"``); the AUCs, the medians, the Sampson distances and the pose
errors run on the host in numpy, as the JAX package's do. The estimators
draw their RANSAC samples through ``twoview.estimators.ransac_samples``.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device


def _h5py():
    try:
        import h5py
    except ModuleNotFoundError as exc:
        raise ModuleNotFoundError(
            "comet_tpu_torch.matching.eval_pipeline: the .h5 prediction and result files need "
            "the h5py package, which is not installed") from exc
    return h5py


def _host(x) -> np.ndarray:
    """A prediction as the numpy array the JAX package would write: tensors
    copied to the host, 64-bit integers and floats narrowed to 32 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.int64:
            x = x.to(torch.int32)
        elif x.dtype == torch.float64:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


# ---------------------------------------------------------------- metrics

def cal_error_auc(errors: Sequence[float], thresholds: Sequence[float]):
    """The cumulative-recall trapezoid AUC at each threshold, rounded to 4
    decimals (glue-factory's formula)."""
    errors = np.asarray(list(errors), np.float64)
    if errors.size == 0:
        return [float("nan")] * len(thresholds)
    errors = errors[np.argsort(errors)]
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]
    aucs = []
    for t in thresholds:
        last_index = np.searchsorted(errors, t)
        r = np.r_[recall[:last_index], recall[last_index - 1]]
        e = np.r_[errors[:last_index], t]
        aucs.append(float(np.round(np.trapezoid(r, x=e) / t, 4)))
    return aucs


class AUCMetric:
    """Errors gathered, then :func:`cal_error_auc` at the thresholds."""

    def __init__(self, thresholds, elements=None):
        self.thresholds = (list(thresholds) if isinstance(thresholds, (list, tuple))
                           else [thresholds])
        self._elements = list(elements) if elements is not None else []

    def update(self, values):
        self._elements += np.asarray(values).ravel().tolist()

    def compute(self):
        if not self._elements:
            return float("nan")
        return cal_error_auc(self._elements, self.thresholds)


def eval_poses(pose_results: Dict[float, Dict[str, List[float]]], auc_ths: Sequence[float],
               key: str, unit: str = "px"):
    """The RANSAC threshold with the best mean AUC: its AUC per threshold,
    its mAA and the median of every numeric per-pair metric at it. Returns
    (summaries, best threshold)."""
    pose_aucs = {th: AUCMetric(list(auc_ths), res[key]).compute()
                 for th, res in pose_results.items()}
    maas = {th: float(np.mean(v)) for th, v in pose_aucs.items()}
    best_th = max(maas, key=maas.get)
    summaries = {}
    for i, ath in enumerate(auc_ths):
        summaries[f"{key}@{ath}{unit}"] = pose_aucs[best_th][i]
    summaries[f"{key}_mAA"] = maas[best_th]
    for k, v in pose_results[best_th].items():
        arr = np.asarray(v)
        if np.issubdtype(arr.dtype, np.number):
            summaries[f"m{k}"] = round(float(np.median(arr)), 3)
    return summaries, best_th


# ---------------------------------------------------------------- storage

def save_eval(exp_dir: str, summaries: Dict, results: Dict) -> None:
    """``results.h5`` (one dataset per per-pair metric) and
    ``summaries.json`` (non-finite values as null)."""
    h5py = _h5py()
    with h5py.File(os.path.join(exp_dir, "results.h5"), "w") as hfile:
        for k, v in results.items():
            arr = np.asarray(v)
            if not np.issubdtype(arr.dtype, np.number):
                arr = arr.astype(h5py.string_dtype())
            hfile.create_dataset(k, data=arr)
    s = {k: (float(v) if np.isfinite(v) else None) if not isinstance(v, list) else v
         for k, v in summaries.items()}
    with open(os.path.join(exp_dir, "summaries.json"), "w") as f:
        json.dump(s, f, indent=4)


def load_eval(exp_dir: str):
    """(summaries, results) as :func:`save_eval` wrote them (null back to nan)."""
    h5py = _h5py()
    results = {}
    with h5py.File(os.path.join(exp_dir, "results.h5"), "r") as hfile:
        for k in hfile.keys():
            r = np.array(hfile[k])
            if r.dtype.kind in "OS":
                r = r.astype(str)
            results[k] = r
    with open(os.path.join(exp_dir, "summaries.json")) as f:
        s = json.load(f)
    return {k: (v if v is not None else np.nan) for k, v in s.items()}, results


def exists_eval(exp_dir: str) -> bool:
    return (os.path.exists(os.path.join(exp_dir, "results.h5"))
            and os.path.exists(os.path.join(exp_dir, "summaries.json")))


def export_predictions(loader: Iterable[Dict], model, pred_file: str, keys: Sequence[str],
                       optional_keys: Sequence[str] = ()) -> str:
    """``model`` over ``loader`` (dicts with a unique "name"), the requested
    keys of each prediction cached in a group per item."""
    h5py = _h5py()
    with h5py.File(pred_file, "w") as hfile:
        for data in loader:
            pred = model(data)
            grp = hfile.create_group(str(data["name"]))
            for k in list(keys) + [k for k in optional_keys if k in pred]:
                if k in keys and k not in pred:
                    raise KeyError(f"prediction missing required key {k}")
                if k in pred:
                    grp.create_dataset(k, data=_host(pred[k]))
    return pred_file


def load_predictions(pred_file: str, name: str) -> Dict[str, np.ndarray]:
    """One item's cached predictions."""
    h5py = _h5py()
    with h5py.File(pred_file, "r") as hfile:
        grp = hfile[str(name)]
        return {k: np.array(grp[k]) for k in grp.keys()}


# ---------------------------------------------------------------- pipeline

class EvalPipeline:
    """Export and cached evaluation. Subclasses define ``default_conf`` and
    ``export_keys`` and implement ``get_dataloader``, ``get_model`` and
    ``run_eval``; ``run`` handles the caches, the config guard and the
    files. ``device`` is where the model and the estimators run."""

    default_conf: Dict = {}
    export_keys: List[str] = []
    optional_export_keys: List[str] = []

    def __init__(self, conf: Optional[Dict] = None, device=None):
        self.conf = _deep_merge(self.default_conf, conf or {})
        self.device = device
        self._init(self.conf)

    def _init(self, conf):
        pass

    def _device(self) -> torch.device:
        return resolve_device(self.device, type(self).__name__)

    def get_dataloader(self):
        raise NotImplementedError

    def get_model(self):
        raise NotImplementedError

    def run_eval(self, loader, pred_file):
        raise NotImplementedError

    def save_conf(self, exp_dir, overwrite=False, overwrite_eval=False):
        """The config guard: a cache made under another data or model
        config raises unless ``overwrite``, under another eval config
        unless ``overwrite`` or ``overwrite_eval``."""
        path = os.path.join(exp_dir, "conf.json")
        if os.path.exists(path):
            with open(path) as f:
                saved = json.load(f)
            if (saved.get("data") != self.conf.get("data")
                    or saved.get("model") != self.conf.get("model")) and not overwrite:
                raise RuntimeError("configs changed, pass overwrite=True to rerun")
            if saved.get("eval") != self.conf.get("eval") and not (overwrite or overwrite_eval):
                raise RuntimeError("eval configs changed, pass overwrite_eval=True")
        with open(path, "w") as f:
            json.dump(self.conf, f, indent=2, default=str)

    def get_predictions(self, exp_dir, model=None, overwrite=False) -> str:
        pred_file = os.path.join(exp_dir, "predictions.h5")
        if not os.path.exists(pred_file) or overwrite:
            model = model if model is not None else self.get_model()
            export_predictions(self.get_dataloader(), model, pred_file, keys=self.export_keys,
                               optional_keys=self.optional_export_keys)
        return pred_file

    def run(self, exp_dir, model=None, overwrite=False, overwrite_eval=False):
        _h5py()  # before any file is written
        os.makedirs(exp_dir, exist_ok=True)
        self.save_conf(exp_dir, overwrite, overwrite_eval)
        pred_file = self.get_predictions(exp_dir, model, overwrite)
        if not exists_eval(exp_dir) or overwrite or overwrite_eval:
            s, r = self.run_eval(self.get_dataloader(), pred_file)
            save_eval(exp_dir, s, r)
        return load_eval(exp_dir)

    def inspect(self, exp_dir: str, k: int = 4, threshold: float = 3.0):
        """The k worst pairs (by match precision) of the cached predictions
        drawn to PNGs under ``<exp_dir>/inspect/`` (cv2): red/green by
        correctness where the item has ``H_0to1``, else by matching score.
        Returns the written paths."""
        import cv2

        from .gt_generation import warp_homography
        from .viz import draw_matches

        pred_file = os.path.join(exp_dir, "predictions.h5")
        if not os.path.exists(pred_file):
            raise FileNotFoundError(f"no prediction cache at {pred_file}")
        rows = []
        for data in self.get_dataloader():
            if "image0" not in data or "image1" not in data:
                continue
            pred = load_predictions(pred_file, data["name"])
            m0 = pred["matches0"]
            valid = m0 >= 0
            kp0 = pred["keypoints0"][valid]
            kp1 = pred["keypoints1"][np.clip(m0[valid], 0, len(pred["keypoints1"]) - 1)]
            if "H_0to1" in data and kp0.shape[0] > 0:
                dev = self._device()
                proj = warp_homography(torch.as_tensor(kp0, dtype=torch.float32, device=dev),
                                       torch.as_tensor(data["H_0to1"], dtype=torch.float32,
                                                       device=dev)).cpu().numpy()
                correct = (np.linalg.norm(proj - kp1, axis=-1) < threshold).astype(np.float64)
                precision = float(correct.mean()) if len(correct) else 0.0
            elif "matching_scores0" in pred:
                correct = np.asarray(pred["matching_scores0"])[valid]
                precision = float(correct.mean()) if len(correct) else 0.0
            else:
                correct, precision = None, 0.0
            rows.append((precision, data, kp0, kp1, correct))
        rows.sort(key=lambda r: r[0])
        out_dir = os.path.join(exp_dir, "inspect")
        os.makedirs(out_dir, exist_ok=True)
        written = []
        for precision, data, kp0, kp1, correct in rows[:k]:
            img = draw_matches(data["image0"], data["image1"], kp0, kp1, correct=correct)
            path = os.path.join(out_dir, f"{data['name']}_p{precision:.2f}.png")
            if not cv2.imwrite(path, img[..., ::-1]):
                raise OSError(f"cv2.imwrite could not write {path}")
            written.append(path)
        return written


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_gray(path: str, image_size: Optional[int] = None) -> np.ndarray:
    """[H, W] float32 grayscale in [0, 1], optionally square-resized (PIL)."""
    from PIL import Image

    img = Image.open(path).convert("L")
    if image_size:
        img = img.resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def _test_thresholds(ths):
    """A positive scalar alone, a non-positive one the default sweep, a list
    as given."""
    if np.isscalar(ths):
        return [ths] if ths > 0 else [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]
    return list(ths)


def _median_summaries(results) -> Dict[str, float]:
    summaries = {}
    for k, v in results.items():
        arr = np.asarray(v)
        if np.issubdtype(arr.dtype, np.number):
            summaries[f"m{k}"] = round(float(np.median(arr)), 3)
    return summaries


def _nn_model(extract):
    """Extractor on both images, mutual nearest neighbours of the
    descriptors: the pipelines' prediction."""
    from .matchers import mutual_nearest_neighbor

    def model(data):
        f0 = extract(data["image0"])
        f1 = extract(data["image1"])
        m = mutual_nearest_neighbor(f0["descriptors"], f1["descriptors"],
                                    valid0=f0.get("valid"), valid1=f1.get("valid"))
        return {"keypoints0": f0["keypoints"], "keypoints1": f1["keypoints"],
                "matches0": m["matches0"], "matching_scores0": m["scores0"]}

    return model


class HomographyEvalPipeline(EvalPipeline):
    """The homography pipeline (hpatches.py's role) over three data sources:
    synthetic textured pairs (default); ``data.image_dir``, images from a
    directory each warped by a sampled homography; ``data.image_dir`` with
    ``data.pairs_file``, one pair per line ``name0 name1 h00 ... h22``
    (row-major H_0to1). The evaluation: per-pair match precision and recall,
    the weighted-DLT homography's corner error, and the robust estimator's
    swept over RANSAC thresholds with the best mAA's chosen."""

    default_conf = {
        "data": {"n_pairs": 8, "image_size": 96, "seed": 0,
                 "image_dir": None, "pairs_file": None,
                 "warps_per_image": 1},
        "model": {"extractor": "extractor_sift", "extractor_conf": {},
                  "matcher": "nn"},
        "eval": {"estimator": "ransac", "ransac_th": -1.0,
                 "auc_ths": [1, 3, 5]},
    }
    export_keys = ["keypoints0", "keypoints1", "matches0", "matching_scores0"]

    def get_dataloader(self):
        from .benchmarks import make_synthetic_pairs

        d = self.conf["data"]
        if d.get("image_dir"):
            return self._folder_pairs(d)
        pairs = make_synthetic_pairs(n_pairs=d["n_pairs"], hw=(d["image_size"], d["image_size"]),
                                     seed=d["seed"], device=self._device())
        return [{"name": f"pair{i:04d}", "image0": p[0], "image1": p[1],
                 "H_0to1": p[2].cpu().numpy(), "scene": f"scene{i % 2}"}
                for i, p in enumerate(pairs)]

    def _folder_pairs(self, d):
        from .benchmarks import random_homography, warp_image

        image_dir = d["image_dir"]
        size = d.get("image_size") or 96
        if d.get("pairs_file"):
            items = []
            with open(d["pairs_file"]) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) < 11:
                        continue
                    n0, n1 = parts[0], parts[1]
                    h = np.asarray([float(x) for x in parts[2:11]], np.float32).reshape(3, 3)
                    items.append({
                        "name": f"{os.path.splitext(n0)[0]}-{os.path.splitext(n1)[0]}",
                        "image0": _load_gray(os.path.join(image_dir, n0)),
                        "image1": _load_gray(os.path.join(image_dir, n1)),
                        "H_0to1": h,
                        "scene": os.path.splitext(n0)[0],
                    })
            if not items:
                raise ValueError(f"no pairs parsed from {d['pairs_file']}")
            return items
        exts = (".png", ".jpg", ".jpeg", ".bmp")
        names = sorted(f for f in os.listdir(image_dir) if f.lower().endswith(exts))
        if not names:
            raise ValueError(f"no images under {image_dir}")
        rng = np.random.default_rng(d.get("seed", 0))
        dev = self._device()
        items = []
        for name in names:
            img = _load_gray(os.path.join(image_dir, name), size)
            for w in range(int(d.get("warps_per_image", 1))):
                h_gt = random_homography(rng, *img.shape[:2])
                img0 = torch.as_tensor(img[..., None], device=dev)
                img1 = warp_image(img0, torch.as_tensor(h_gt, dtype=torch.float32, device=dev))
                items.append({
                    "name": f"{os.path.splitext(name)[0]}_w{w}",
                    "image0": img0, "image1": img1,
                    "H_0to1": np.asarray(h_gt, np.float32),
                    "scene": os.path.splitext(name)[0],
                })
        return items

    def get_model(self):
        from .registry import get_model as get_registered

        mc = self.conf["model"]
        return _nn_model(get_registered(mc["extractor"], **mc.get("extractor_conf", {}),
                                        device=self.device))

    def run_eval(self, loader, pred_file):
        from ..twoview.estimators import run_homography_dlt
        from ..twoview.robust_estimators import get_estimator
        from .benchmarks import homography_corner_error
        from .eval import eval_matches_homography

        conf = self.conf["eval"]
        test_ths = _test_thresholds(conf["ransac_th"])
        dev = self._device()
        results = defaultdict(list)
        pose_results: Dict[float, Dict[str, List[float]]] = defaultdict(lambda: defaultdict(list))

        def on_dev(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        for data in loader:
            pred = load_predictions(pred_file, data["name"])
            k0, k1 = pred["keypoints0"], pred["keypoints1"]
            m0 = pred["matches0"]
            h_gt = on_dev(data["H_0to1"])
            hw = tuple(data["image0"].shape[:2])
            metrics = eval_matches_homography(on_dev(k0), on_dev(k1), on_dev(m0, torch.long),
                                              h_gt)
            row = {k: float(v) for k, v in metrics.items()}
            valid = m0 >= 0
            pts0 = k0[valid]
            pts1 = k1[np.clip(m0[valid], 0, len(k1) - 1)]
            if pts0.shape[0] >= 4:
                h_dlt = run_homography_dlt(on_dev(pts0), on_dev(pts1),
                                           weights=on_dev(pred["matching_scores0"][valid]))
                row["H_error_dlt"] = float(homography_corner_error(h_dlt, h_gt, hw))
            else:
                row["H_error_dlt"] = float("inf")
            for th in test_ths:
                err = float("inf")
                if pts0.shape[0] >= 4:
                    est = get_estimator("homography", conf["estimator"], {"ransac_th": th},
                                        device=dev)
                    out = est({"m_kpts0": on_dev(pts0), "m_kpts1": on_dev(pts1)})
                    if out["success"]:
                        err = float(homography_corner_error(out["M_0to1"], h_gt, hw))
                pose_results[th]["H_error_ransac"].append(err)
            row["names"] = data["name"]
            row["scenes"] = data["scene"]
            for k, v in row.items():
                results[k].append(v)

        summaries = _median_summaries(results)
        auc_ths = list(conf["auc_ths"])
        best_pose, best_th = eval_poses(pose_results, auc_ths=auc_ths, key="H_error_ransac",
                                        unit="px")
        dlt_aucs = AUCMetric(auc_ths, results["H_error_dlt"]).compute()
        for i, ath in enumerate(auc_ths):
            summaries[f"H_error_dlt@{ath}px"] = dlt_aucs[i]
        return {**summaries, **best_pose}, dict({**results, **pose_results[best_th]})


# ------------------------------------------------- relative-pose pipeline

def relative_pose_error_deg(r_gt, t_gt, r, t):
    """(t_err, r_err) in degrees: the rotation's geodesic angle and the
    angle between the translation directions, symmetric in sign (the scale
    is unobservable)."""
    r_gt = np.asarray(r_gt, np.float64)
    r = np.asarray(r, np.float64)
    cos = (np.trace(r.T @ r_gt) - 1.0) / 2.0
    r_err = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
    a = np.asarray(t_gt, np.float64).ravel()
    b = np.asarray(t, np.float64).ravel()
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    if denom < 1e-12:
        return 0.0, float(r_err)
    cos_t = np.abs(np.dot(a, b)) / denom
    t_err = np.degrees(np.arccos(np.clip(cos_t, 0.0, 1.0)))
    return float(t_err), float(r_err)


def sampson_distance_normalized(kpts0, kpts1, k0, k1, r, t):
    """Per-match Sampson epipolar distance in normalized image coordinates
    under a relative pose."""
    k0i = np.linalg.inv(np.asarray(k0, np.float64))
    k1i = np.linalg.inv(np.asarray(k1, np.float64))
    x0 = np.concatenate([kpts0, np.ones_like(kpts0[:, :1])], -1) @ k0i.T
    x1 = np.concatenate([kpts1, np.ones_like(kpts1[:, :1])], -1) @ k1i.T
    tx = np.asarray([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float64)
    e = tx @ np.asarray(r, np.float64)
    ex0 = x0 @ e.T
    etx1 = x1 @ e
    num = np.sum(x1 * ex0, -1) ** 2
    den = ex0[:, 0] ** 2 + ex0[:, 1] ** 2 + etx1[:, 0] ** 2 + etx1[:, 1] ** 2
    return np.sqrt(num / np.maximum(den, 1e-15))


def make_synthetic_pose_pairs(n_pairs=6, n_points=96, image_size=256, focal=300.0, noise=0.4,
                              outlier_frac=0.15, seed=0):
    """Random 3-D point clouds seen by two cameras with a known relative
    pose, projected with pixel noise, a fraction of the matches replaced by
    uniform points (the stand-in for the MegaDepth-1500 and ETH3D pairs);
    numpy, on the host."""
    rng = np.random.default_rng(seed)
    k = np.asarray([[focal, 0, image_size / 2], [0, focal, image_size / 2], [0, 0, 1.0]],
                   np.float64)
    items = []
    for i in range(n_pairs):
        ang = rng.uniform(0.08, 0.3)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        kx = np.asarray([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                         [-axis[1], axis[0], 0]])
        r = np.eye(3) + np.sin(ang) * kx + (1 - np.cos(ang)) * (kx @ kx)
        t = rng.normal(size=3)
        # deep structure and a baseline comparable to its depth spread: the
        # translation direction stays observable at sub-pixel noise
        t = t / np.linalg.norm(t) * rng.uniform(0.8, 1.5)
        pts = rng.uniform(-1, 1, size=(n_points, 3))
        pts[:, 2] = pts[:, 2] * 1.5 + 4.5

        def project(p):
            uv = p @ k.T
            return uv[:, :2] / uv[:, 2:]

        p0 = project(pts) + rng.normal(size=(n_points, 2)) * noise
        p1 = project(pts @ r.T + t) + rng.normal(size=(n_points, 2)) * noise
        n_out = int(n_points * outlier_frac)
        p1[:n_out] = rng.uniform(0, image_size, size=(n_out, 2))
        items.append({
            "name": f"pair{i:04d}",
            "K0": k.astype(np.float32), "K1": k.astype(np.float32),
            "R_0to1": r.astype(np.float32),
            "t_0to1": t.astype(np.float32),
            "kpts_proj0": p0.astype(np.float32),
            "kpts_proj1": p1.astype(np.float32),
            "scene": f"scene{i % 2}",
        })
    return items


class RelativePoseEvalPipeline(EvalPipeline):
    """The relative-pose pipeline (megadepth1500.py's role): per-pair
    epipolar precision at 1e-4, 5e-4 and 1e-3 (normalized Sampson), the
    essential-matrix estimator swept over RANSAC thresholds, the pose error
    max(R_err, t_err) in degrees, AUC@5/10/20 at the best mAA's threshold
    and inlier counts. Data: synthetic pairs, whose default model exports
    their projected correspondences (an oracle), or ``data.amd_dir``, image
    pairs with ground-truth poses from an AMD-layout tree, matched by the
    configured extractor and mutual nearest neighbours."""

    default_conf = {
        "data": {"n_pairs": 6, "n_points": 96, "image_size": 256,
                 "focal": 300.0, "noise": 0.4, "outlier_frac": 0.15,
                 "seed": 0, "amd_dir": None, "frame_gap": 2,
                 "max_pairs": 12, "intrinsics": None},
        "model": {"extractor": "extractor_sift", "extractor_conf": {}},
        "eval": {"estimator": "ransac", "ransac_th": -1.0,
                 "auc_ths": [5, 10, 20]},
    }
    export_keys = ["keypoints0", "keypoints1", "matches0", "matching_scores0"]

    def get_dataloader(self):
        d = self.conf["data"]
        if d.get("amd_dir"):
            return self._amd_pairs(d)
        d = {k: v for k, v in d.items()
             if k not in ("amd_dir", "frame_gap", "max_pairs", "intrinsics")}
        return make_synthetic_pose_pairs(**d)

    @staticmethod
    def _amd_pairs(d):
        """Image pairs ``frame_gap`` frames apart with their ground-truth
        relative pose from an AMD-layout tree (root/modelX/seq_Y/{frames,
        GroundTruth}); poses are 4 x 4 world-to-camera: R_0to1 = R1 R0^T,
        t_0to1 = t1 - R_0to1 t0. The AMD intrinsics unless ``intrinsics``
        gives (fx, fy, cx, cy)."""
        root = d["amd_dir"]
        gap = int(d.get("frame_gap", 2))
        fx, fy, cx, cy = d.get("intrinsics") or (268.44444444, 268.44444444, 320.0, 240.0)
        k = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        seq_dirs = sorted(os.path.join(r, sub) for r, dirs, _ in os.walk(root) for sub in dirs
                          if os.path.isdir(os.path.join(r, sub, "frames")))
        items = []
        for seq in seq_dirs:
            frames = sorted(os.listdir(os.path.join(seq, "frames")))
            gts = sorted(os.listdir(os.path.join(seq, "GroundTruth")))
            for i in range(0, len(frames) - gap, gap):
                p0 = np.loadtxt(os.path.join(seq, "GroundTruth", gts[i]))
                p1 = np.loadtxt(os.path.join(seq, "GroundTruth", gts[i + gap]))
                r0, t0 = p0[:3, :3], p0[:3, 3]
                r1, t1 = p1[:3, :3], p1[:3, 3]
                r01 = r1 @ r0.T
                t01 = t1 - r01 @ t0
                seq_tag = os.path.relpath(seq, root).replace(os.sep, "_")
                items.append({
                    "name": f"{seq_tag}_f{i:03d}_f{i + gap:03d}",
                    "image0": _load_gray(os.path.join(seq, "frames", frames[i])),
                    "image1": _load_gray(os.path.join(seq, "frames", frames[i + gap])),
                    "K0": k, "K1": k,
                    "R_0to1": r01.astype(np.float32),
                    "t_0to1": t01.astype(np.float32),
                    "scene": seq_tag,
                })
                if len(items) >= int(d.get("max_pairs", 12)):
                    return items
        if not items:
            raise ValueError(f"no AMD sequences under {root}")
        return items

    def get_model(self):
        from .registry import get_model as get_registered

        mc = self.conf.get("model") or {}
        matched = None
        if mc.get("extractor"):
            matched = _nn_model(get_registered(mc["extractor"], **mc.get("extractor_conf", {}),
                                               device=self.device))

        def model(data):
            if "kpts_proj0" in data:  # the synthetic pairs' oracle correspondences
                n = data["kpts_proj0"].shape[0]
                return {"keypoints0": data["kpts_proj0"], "keypoints1": data["kpts_proj1"],
                        "matches0": np.arange(n, dtype=np.int64),
                        "matching_scores0": np.ones(n, np.float32)}
            return matched(data)

        return model

    def run_eval(self, loader, pred_file):
        from ..twoview.robust_estimators import get_estimator

        conf = self.conf["eval"]
        test_ths = _test_thresholds(conf["ransac_th"])
        dev = self._device()
        results = defaultdict(list)
        pose_results: Dict[float, Dict[str, List[float]]] = defaultdict(lambda: defaultdict(list))
        for data in loader:
            pred = load_predictions(pred_file, data["name"])
            k0, k1 = pred["keypoints0"], pred["keypoints1"]
            m0 = pred["matches0"]
            valid = m0 >= 0
            pts0 = k0[valid]
            pts1 = k1[np.clip(m0[valid], 0, len(k1) - 1)]
            if pts0.shape[0] > 0:
                epi = sampson_distance_normalized(pts0, pts1, data["K0"], data["K1"],
                                                  data["R_0to1"], data["t_0to1"])
            else:  # a real pair can give no match
                epi = np.full((1,), np.inf)
            row = {
                "epi_prec@1e-4": float((epi < 1e-4).mean()),
                "epi_prec@5e-4": float((epi < 5e-4).mean()),
                "epi_prec@1e-3": float((epi < 1e-3).mean()),
                "num_matches": int(valid.sum()),
            }
            for th in test_ths:
                pr = pose_results[th]
                err, inl = float("inf"), None
                if pts0.shape[0] >= 5:  # the 5-point minimum of E
                    est = get_estimator("relative_pose", conf["estimator"], {"ransac_th": th},
                                        device=dev)
                    out = est({"m_kpts0": torch.as_tensor(pts0, dtype=torch.float32, device=dev),
                               "m_kpts1": torch.as_tensor(pts1, dtype=torch.float32, device=dev),
                               "K0": data["K0"], "K1": data["K1"]})
                    if out["success"]:
                        r_est, t_est = out["M_0to1"]
                        t_err, r_err = relative_pose_error_deg(
                            data["R_0to1"], data["t_0to1"], r_est.cpu().numpy(),
                            t_est.cpu().numpy())
                        err, inl = max(r_err, t_err), out["inliers"].cpu().numpy()
                pr["rel_pose_error"].append(err)
                pr["ransac_inl"].append(0.0 if inl is None else float(inl.sum()))
                pr["ransac_inl%"].append(0.0 if inl is None else float(inl.mean()))
            row["names"] = data["name"]
            row["scenes"] = data["scene"]
            for key, v in row.items():
                results[key].append(v)

        summaries = _median_summaries(results)
        best_pose, best_th = eval_poses(pose_results, auc_ths=list(conf["auc_ths"]),
                                        key="rel_pose_error", unit="°")
        return {**summaries, **best_pose}, dict({**results, **pose_results[best_th]})
