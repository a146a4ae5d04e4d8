"""Frame-0 keypoint seeding with mask filtering and padding.

Counterpart of ``comet_tpu/data/keypoints.py`` (the harness's seeding +
filter_and_pad, comet/models/train_eval_func_new_cp5.py:527-592, 250-314):
detect keypoints on frame 0, keep only those inside the object mask, top up
from the mask interior (then a dilated ring, then anywhere) until min_pts,
cap at max_pts. With the same ``rng`` it draws the same points as the JAX
package.

Detection backends:
- "corners": Shi-Tomasi corners (cv2.goodFeaturesToTrack) + a DoG-based
  blob detector; cv2 is imported when it runs.
- "grid": deterministic grid over the mask (no detector).
- "superpoint": SuperPoint detections (``models/superpoint.py``, on the
  caller's device, the card by default) concatenated with the corner and
  DoG ones, as the reference concatenates SuperPoint and SIFT keypoints
  (train_eval_func_new_cp5.py:557-592). Without ``superpoint_params`` (a
  flax ``.msgpack`` of the JAX package's SuperPoint) the detector holds
  random weights drawn from ``torch.Generator().manual_seed(0)`` (JAX draws
  from ``PRNGKey(0)``, which cannot be reproduced); with it, both packages
  seed the same points.

Host-side numpy apart from the SuperPoint forward; runs once per sequence.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] ImageNet-normalized float -> uint8 (uint8 passes through:
    the device-preprocess path supplies a host-resident u8 preview so
    seeding never reads the device image back; a tensor comes to the host
    first)."""
    img = img.cpu().numpy() if hasattr(img, "cpu") else np.asarray(img)
    if img.dtype == np.uint8:
        return img
    x = img * _IMAGENET_STD + _IMAGENET_MEAN
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def detect_corners(img_u8: np.ndarray, max_pts: int) -> np.ndarray:
    """Shi-Tomasi corners + DoG extrema -> [K, 2] (x, y) float32."""
    import cv2

    gray = cv2.cvtColor(img_u8, cv2.COLOR_RGB2GRAY)
    pts = cv2.goodFeaturesToTrack(
        gray, maxCorners=max_pts, qualityLevel=0.01, minDistance=3
    )
    corners = pts.reshape(-1, 2) if pts is not None else np.zeros((0, 2))
    # DoG keypoints (SIFT-detector stand-in, no descriptors needed).
    # Detection runs at HALF resolution with coordinates scaled back:
    # the Gaussian pyramid build is the whole cost (measured 129 ms at
    # 512^2 vs 27 ms at 256^2 on this 1-core host — the single largest
    # input-pipeline stage), DoG extrema are scale-covariant, and the
    # sub-pixel detail lost matters little because these are track
    # QUERY SEEDS refined by the tracker, not correspondences
    # (metric spread across seeding backends is bounded by
    # tests/test_keypoint_sensitivity.py). Full-resolution Shi-Tomasi
    # above keeps fine corner localization in the mix.
    h, w = gray.shape
    half = cv2.resize(gray, (max(w // 2, 8), max(h // 2, 8)),
                      interpolation=cv2.INTER_AREA)
    sift = cv2.SIFT_create(nfeatures=max_pts)
    kps = sift.detect(half, None)
    scale = np.asarray([w / half.shape[1], h / half.shape[0]], np.float32)
    # pixel-center-correct mapping (cv2.resize convention): the center of
    # half-res pixel x sits at full-res (x + 0.5) * s - 0.5, not x * s —
    # a plain multiply would bias every DoG seed ~0.5-1 px bottom-right
    dog = (
        np.array([k.pt for k in kps], np.float32).reshape(-1, 2) + 0.5
    ) * scale - 0.5
    out = np.concatenate([corners, dog], axis=0) if len(dog) else corners
    return out.astype(np.float32)


_SP_CACHE = {}


def detect_superpoint(img_u8: np.ndarray, max_pts: int, params_path: Optional[str] = None,
                      device=None) -> np.ndarray:
    """SuperPoint detections on an RGB uint8 frame -> [K, 2] (x, y) float32:
    the positive-score keypoints inside the frame (it is padded to a
    multiple of 8). The forward runs on ``device`` (the card by default)."""
    import torch

    from ..device import resolve_device
    from ..matching.extractors import build_superpoint

    dev = resolve_device(device, "detect_superpoint")
    h, w = img_u8.shape[:2]
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    gray = img_u8.astype(np.float32).mean(axis=-1) / 255.0
    gray = np.pad(gray, ((0, hp - h), (0, wp - w)))
    key = (max_pts, params_path, dev)
    if key not in _SP_CACHE:
        _SP_CACHE[key] = build_superpoint(max_pts, params_path=params_path, seed=0).to(dev)
    with torch.no_grad():
        out = _SP_CACHE[key](torch.as_tensor(gray, device=dev))
    kps = out.keypoints[out.scores > 0.0].cpu().numpy()
    keep = (kps[:, 0] < w) & (kps[:, 1] < h)  # not in the padding
    return kps[keep].astype(np.float32)


def grid_points(mask: np.ndarray, n_pts: int) -> np.ndarray:
    """Deterministic grid restricted to the mask interior."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        h, w = mask.shape
        g = int(np.ceil(np.sqrt(n_pts)))
        gy, gx = np.meshgrid(
            np.linspace(0, h - 1, g), np.linspace(0, w - 1, g), indexing="ij"
        )
        return np.stack([gx.reshape(-1), gy.reshape(-1)], -1)[:n_pts].astype(np.float32)
    idx = np.linspace(0, len(ys) - 1, n_pts).astype(int)
    return np.stack([xs[idx], ys[idx]], axis=-1).astype(np.float32)


def _sample_mask_points(
    mask: np.ndarray, n: int, rng: np.random.Generator
) -> Optional[np.ndarray]:
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return None
    idx = rng.integers(0, len(ys), size=n)
    return np.stack([xs[idx], ys[idx]], axis=-1).astype(np.float32)


def _dilate(mask: np.ndarray) -> np.ndarray:
    """3x3 binary dilation (the reference's max_pool2d(k=3, pad=1))."""
    padded = np.pad(mask, 1)
    out = np.zeros_like(mask)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out |= padded[dy : dy + mask.shape[0], dx : dx + mask.shape[1]]
    return out


def filter_and_pad(
    pts: np.ndarray,
    mask: np.ndarray,
    min_pts: int,
    max_pts: int,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Keep points inside the mask; top up to min_pts; cap at max_pts
    (train_eval_func_new_cp5.py:261-314). Always returns exactly max_pts
    points (padding by repetition if needed) so downstream shapes are static.
    """
    rng = rng or np.random.default_rng(0)
    h, w = mask.shape
    mask = mask.astype(bool)

    if len(pts):
        xi = np.clip(np.round(pts[:, 0]), 0, w - 1).astype(int)
        yi = np.clip(np.round(pts[:, 1]), 0, h - 1).astype(int)
        keep = pts[mask[yi, xi]]
    else:
        keep = np.zeros((0, 2), np.float32)

    if keep.shape[0] < min_pts:
        need = min_pts - keep.shape[0]
        extra = _sample_mask_points(mask, need, rng)
        if extra is None or extra.shape[0] < need:
            ring = _dilate(mask) & ~mask
            remain = need if extra is None else need - extra.shape[0]
            extra2 = _sample_mask_points(ring, remain, rng)
            if extra2 is not None:
                extra = extra2 if extra is None else np.concatenate([extra, extra2])
        if extra is None or extra.shape[0] < need:
            remain = need if extra is None else need - extra.shape[0]
            rand = np.stack(
                [rng.integers(0, w, remain), rng.integers(0, h, remain)], -1
            ).astype(np.float32)
            extra = rand if extra is None else np.concatenate([extra, rand])
        keep = np.concatenate([keep, extra], axis=0)

    if keep.shape[0] > max_pts:
        idx = rng.permutation(keep.shape[0])[:max_pts]
        keep = keep[idx]
    elif keep.shape[0] < max_pts:
        # static-shape padding: repeat existing points (harmless duplicates)
        reps = rng.integers(0, keep.shape[0], size=max_pts - keep.shape[0])
        keep = np.concatenate([keep, keep[reps]], axis=0)

    return keep.astype(np.float32)


def seed_query_points(
    frame0: np.ndarray,
    mask: np.ndarray,
    track_num: int = 512,
    min_pts: int = 256,
    backend: str = "corners",
    rng: Optional[np.random.Generator] = None,
    superpoint_params: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """Full seeding pipeline on a normalized frame-0 image -> [track_num, 2].

    backend "superpoint" concatenates the SuperPoint detections (on
    ``device``, the card by default; ``superpoint_params`` a flax
    ``.msgpack``) with the DoG/corner ones before the mask filter
    (train_eval_func_new_cp5.py:557-592).
    """
    rng = rng or np.random.default_rng(0)
    if backend == "grid":
        pts = grid_points(mask, track_num)
    elif backend == "corners":
        pts = detect_corners(denormalize_image(frame0), track_num)
    elif backend == "superpoint":
        img_u8 = denormalize_image(frame0)
        sp = detect_superpoint(img_u8, track_num, superpoint_params, device)
        dog = detect_corners(img_u8, track_num)
        pts = np.concatenate([sp, dog], axis=0) if len(dog) else sp
    else:
        raise ValueError(f"unknown keypoint backend: {backend}")
    return filter_and_pad(pts, mask, min_pts, track_num, rng)


def generate_grid_samples(rect, n=None, pixel_interval=None) -> np.ndarray:
    """Grid-sample points inside a rectangle (utils.py:782-827 parity).

    rect: [4] (or [1, 4]) [topleft_x, topleft_y, bottomright_x,
    bottomright_y]. Either ``n`` (approximate total count, split
    aspect-ratio-aware: nx = int(sqrt(n * w/h)), ny = int(n / nx)) or
    ``pixel_interval`` (nx = max(1, w // interval), same for ny).
    Returns [nx * ny, 2] (x, y) float32, endpoints inclusive (linspace).
    """
    rect = np.asarray(rect, dtype=np.float64).reshape(-1)
    x0, y0, x1, y1 = rect[:4]
    width, height = x1 - x0, y1 - y0
    if pixel_interval is not None:
        nx = max(1, int(width // pixel_interval))
        ny = max(1, int(height // pixel_interval))
    else:
        if n is None:
            raise ValueError("pass n or pixel_interval")
        nx = max(1, int(np.sqrt(n * (width / height))))
        ny = max(1, int(n / nx))
    xs = np.linspace(x0, x1, nx)
    ys = np.linspace(y0, y1, ny)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
