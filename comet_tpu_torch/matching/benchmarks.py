"""The homography matching benchmark (an HPatches-style eval loop).

Counterpart of ``comet_tpu/matching/benchmarks.py`` (gluefactory/eval/
hpatches.py and eval_pipeline.py): a TwoViewPipeline over image pairs with
known homographies, reporting the mean match count, precision and recall
and the robustly estimated homography's corner error (``H_error_ransac``)
with its accuracy buckets. The pairs are synthetic: a textured image and
its warp by a random homography, made from a numpy seed; they equal the
JAX package's for the same seed within f32 rounding (the texture's cubic
upsampling is a copy of ``jax.image.resize``'s, not torch's bicubic).

Everything after the texture runs on the pairs' device: the warp, the
extractor, the matcher, the metrics and the estimator (whose RANSAC draws
through ``twoview.estimators.ransac_samples``). Each pair waits on the
device for its metrics, the count of its matches (the JAX package reads
them with ``np.asarray``), the estimator's success and the corner error.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.bilinear import bilinear_sample
from .eval import eval_matches_homography
from .gt_generation import warp_homography


def random_homography(
    rng: np.random.Generator,
    h: int,
    w: int,
    max_rotation: float = 0.15,
    max_scale: float = 0.15,
    max_translation: float = 0.08,
    max_perspective: float = 2e-4,
) -> np.ndarray:
    """Random in-place homography (rotation, scale, translation and
    perspective about the image centre), homography-adapter style."""
    ang = rng.uniform(-max_rotation, max_rotation)
    sc = 1.0 + rng.uniform(-max_scale, max_scale)
    tx = rng.uniform(-max_translation, max_translation) * w
    ty = rng.uniform(-max_translation, max_translation) * h
    ca, sa = np.cos(ang), np.sin(ang)
    center = np.array([[1, 0, -w / 2], [0, 1, -h / 2], [0, 0, 1.0]])
    rot = np.array([[sc * ca, -sc * sa, tx], [sc * sa, sc * ca, ty], [0, 0, 1.0]])
    persp = np.eye(3)
    persp[2, 0] = rng.uniform(-max_perspective, max_perspective)
    persp[2, 1] = rng.uniform(-max_perspective, max_perspective)
    return np.linalg.inv(center) @ persp @ rot @ center


def warp_image(image: torch.Tensor, h_mat: torch.Tensor) -> torch.Tensor:
    """Warp [H, W, C] by the homography: image1[p] = image0[H^-1 p], zeros
    outside."""
    hh, ww = image.shape[:2]
    ys, xs = torch.meshgrid(torch.arange(hh, device=image.device),
                            torch.arange(ww, device=image.device), indexing="ij")
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1).float()
    src = warp_homography(grid, torch.linalg.inv_ex(h_mat)[0])
    return bilinear_sample(image, src, padding_mode="zeros").reshape(hh, ww, image.shape[-1])


def homography_corner_error(h_est: torch.Tensor, h_gt: torch.Tensor,
                            hw: Tuple[int, int]) -> torch.Tensor:
    """Mean distance of the four image corners mapped by the two
    homographies (the ``H_error_ransac`` metric)."""
    h, w = hw
    # (0, 0), (w-1, 0), (w-1, h-1), (0, h-1), filled on the device (no host copy)
    corners = torch.zeros(4, 2, device=h_gt.device)
    corners[1:3, 0] = w - 1
    corners[2:4, 1] = h - 1
    return torch.linalg.vector_norm(
        warp_homography(corners, h_est) - warp_homography(corners, h_gt), dim=-1).mean()


def run_homography_benchmark(
    pipeline,
    pairs: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    threshold: float = 3.0,
    ransac_iters: int = 256,
    ransac_threshold: float = 3.0,
    seed: int = 0,
    estimator: str = "ransac",
) -> Dict[str, float]:
    """Mean num_matches, prec@px, recall and H_error_ransac over the
    (image0, image1, H_gt) pairs, and the H_acc@{1,3,5}px buckets.
    ``estimator`` picks the homography backend of
    ``twoview.robust_estimators`` ("ransac" or "dlt")."""
    from ..twoview.robust_estimators import get_estimator

    est = get_estimator("homography", estimator,
                        {"ransac_th": ransac_threshold, "seed": seed,
                         "num_hypotheses": ransac_iters})
    per_pair: List[Dict[str, float]] = []
    for image0, image1, h_gt in pairs:
        out = pipeline(image0, image1)
        k0 = out["feats0"]["keypoints"]
        k1 = out["feats1"]["keypoints"]
        m0 = out["matches0"]
        metrics = eval_matches_homography(k0, k1, m0, h_gt, threshold)
        row = dict(zip(metrics, torch.stack([v.float() for v in metrics.values()]).tolist()))
        sel = (m0 >= 0).nonzero()[:, 0]  # the one host sync of the selection
        pts0 = k0[sel]
        pts1 = k1[m0[sel].clamp(0, k1.shape[0] - 1)]
        row["H_error_ransac"] = float("inf")
        if pts0.shape[0] >= 4:
            res = est({"m_kpts0": pts0.float(), "m_kpts1": pts1.float()})
            if res["success"]:
                row["H_error_ransac"] = float(
                    homography_corner_error(res["M_0to1"], h_gt, tuple(image0.shape[:2])))
        per_pair.append(row)

    agg: Dict[str, float] = {k: float(np.mean([r[k] for r in per_pair])) for k in per_pair[0]}
    errs = np.asarray([r["H_error_ransac"] for r in per_pair])
    for t in (1.0, 3.0, 5.0):
        agg[f"H_acc@{t:g}px"] = float((errs < t).mean())
    return agg


def _cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of ``jax.image.resize(..., "cubic")`` along one
    axis: Keys' cubic (a = -0.5) at half-pixel centres, each row divided by
    its sum (renormalized at the borders), rows whose sample lies outside
    the input zeroed. Upsampling only: the kernel is not widened."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv = np.float32(1.0) / scale
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[:, None] - np.arange(n_in, dtype=np.float32)[None, :])
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w).astype(np.float32)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


def resize_cubic(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """[h0, w0, C] -> [h, w, C] as ``jax.image.resize(img, (h, w, C),
    "cubic")`` upsamples, on the host in f32."""
    if h < img.shape[0] or w < img.shape[1]:
        raise ValueError("resize_cubic: upsampling only (the antialiased downsampling "
                         "of jax.image.resize is not reproduced)")
    mh = _cubic_weights(img.shape[0], h)
    mw = _cubic_weights(img.shape[1], w)
    out = np.einsum("hi,icx->hcx", mh, img.astype(np.float32))
    return np.einsum("wj,hjc->hwc", mw, out).astype(np.float32)


def synthetic_texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth random texture with corners: low-frequency noise upsampled by
    the cubic, then 24 flat 6 x 6 blobs (on the host)."""
    base = rng.normal(size=(h // 8, w // 8, 1)).astype(np.float32)
    img = resize_cubic(base, h, w)
    img = (img - img.min()) / max(float(np.ptp(img)), 1e-6)
    for _ in range(24):
        cy, cx = rng.integers(8, h - 8), rng.integers(8, w - 8)
        img[cy - 3:cy + 3, cx - 3:cx + 3] = rng.random()
    return img


def make_synthetic_pairs(
    n_pairs: int,
    hw: Tuple[int, int] = (120, 160),
    seed: int = 0,
    image: Optional[np.ndarray] = None,
    device=None,
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Textured random images and their random homography warps (the
    stand-in for the HPatches archive), on ``device`` (the card by
    default)."""
    dev = resolve_device(device, "make_synthetic_pairs")
    rng = np.random.default_rng(seed)
    h, w = hw
    pairs = []
    for _ in range(n_pairs):
        if image is None:
            img = synthetic_texture(rng, h, w)
        else:
            img = np.asarray(image, np.float32)
            if img.ndim == 2:
                img = img[..., None]
        h_gt = random_homography(rng, h, w)
        img0 = torch.as_tensor(img, dtype=torch.float32, device=dev)
        h_t = torch.as_tensor(h_gt, dtype=torch.float32, device=dev)
        pairs.append((img0, warp_image(img0, h_t), h_t))
    return pairs
