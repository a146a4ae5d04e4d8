"""Two-view match drawing (glue-factory's viz2d), headless.

Counterpart of ``comet_tpu/matching/viz.py``: cv2 raster drawing onto numpy
images (side by side, keypoints, matches, lines, line matches, epipolar
lines, heat maps), a matplotlib cumulative-error plot and the training
batch's match figures. Every function takes numpy arrays or the port's
tensors (moved to the host at the entry) and returns uint8 RGB images;
cv2 and matplotlib are imported in the call, and their absence raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "cm_RdGn",
    "side_by_side",
    "draw_keypoints",
    "draw_matches",
    "draw_lines",
    "draw_line_matches",
    "draw_epipolar_lines",
    "heatmap_overlay",
    "plot_cumulative_errors",
]


def _np(x, dtype=None) -> np.ndarray:
    """A tensor or array as a host numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _as_u8(img) -> np.ndarray:
    """uint8 H x W x 3, float [0, 1] H x W x 3, or grayscale H x W."""
    img = _np(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return np.ascontiguousarray(img)


def cm_RdGn(x) -> np.ndarray:
    """Red (0) to green (1), RGB floats."""
    x = np.clip(_np(x, np.float64), 0.0, 1.0)[..., None]
    return x * np.array([0.0, 1.0, 0.0]) + (1.0 - x) * np.array([1.0, 0.0, 0.0])


def side_by_side(img0, img1, pad: int = 4) -> Tuple[np.ndarray, int]:
    """The two images side by side on white: (canvas, x offset of image 1)."""
    a, b = _as_u8(img0), _as_u8(img1)
    h = max(a.shape[0], b.shape[0])
    off = a.shape[1] + pad
    canvas = np.full((h, off + b.shape[1], 3), 255, np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], off:] = b
    return canvas, off


def _hues(n: int, saturation: int) -> np.ndarray:
    """n distinct hues as uint8 RGB."""
    import cv2

    if n == 0:
        return np.zeros((0, 3), np.uint8)
    hsv = np.stack([np.linspace(0, 179, n, endpoint=False), np.full(n, saturation),
                    np.full(n, 255)], -1).astype(np.uint8)[None]
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)[0]


def _pt(p, dx: float = 0) -> Tuple[int, int]:
    return int(round(p[0])) + int(dx), int(round(p[1]))


def draw_keypoints(image, kpts, color: Tuple[int, int, int] = (0, 255, 0), radius: int = 2,
                   scores=None) -> np.ndarray:
    """Dots at keypoints [N, 2]; with ``scores`` in [0, 1], red to green."""
    import cv2

    img = _as_u8(image)
    kpts = _np(kpts)
    colors = ((cm_RdGn(scores) * 255).astype(np.uint8) if scores is not None
              else np.tile(np.asarray(color, np.uint8), (len(kpts), 1)))
    for p, c in zip(kpts, colors):
        cv2.circle(img, _pt(p), radius, c.tolist(), -1)
    return img


def draw_matches(img0, img1, kpts0, kpts1, correct=None, lw: int = 1, ps: int = 3) -> np.ndarray:
    """Matches kpts0[i] <-> kpts1[i] side by side: red to green by
    ``correct`` ([N] bool or float), else a hue per match."""
    import cv2

    canvas, off = side_by_side(img0, img1)
    kpts0, kpts1 = _np(kpts0), _np(kpts1)
    colors = ((cm_RdGn(_np(correct, np.float64)) * 255).astype(np.uint8) if correct is not None
              else _hues(len(kpts0), 200))
    for p0, p1, c in zip(kpts0, kpts1, colors):
        a, b = _pt(p0), _pt(p1, off)
        cv2.line(canvas, a, b, c.tolist(), lw, cv2.LINE_AA)
        cv2.circle(canvas, a, ps, c.tolist(), -1)
        cv2.circle(canvas, b, ps, c.tolist(), -1)
    return canvas


def draw_lines(image, lines, color: Tuple[int, int, int] = (255, 128, 0), lw: int = 2,
               endpoints: bool = True) -> np.ndarray:
    """Segments [M, 2, 2] over the image."""
    import cv2

    img = _as_u8(image)
    for a, b in _np(lines):
        cv2.line(img, _pt(a), _pt(b), color, lw, cv2.LINE_AA)
        if endpoints:
            cv2.circle(img, _pt(a), lw + 1, color, -1)
            cv2.circle(img, _pt(b), lw + 1, color, -1)
    return img


def draw_line_matches(img0, img1, lines0, lines1, correct=None, lw: int = 2) -> np.ndarray:
    """Matched segments lines0[i] <-> lines1[i] side by side, one color per
    pair (red to green by ``correct``)."""
    import cv2

    canvas, off = side_by_side(img0, img1)
    lines0 = _np(lines0)
    colors = ((cm_RdGn(_np(correct, np.float64)) * 255).astype(np.uint8) if correct is not None
              else _hues(len(lines0), 220))
    shifted = _np(lines1).copy()
    shifted[..., 0] += off
    for seg0, seg1, c in zip(lines0, shifted, colors):
        for seg in (seg0, seg1):
            cv2.line(canvas, _pt(seg[0]), _pt(seg[1]), c.tolist(), lw, cv2.LINE_AA)
    return canvas


def draw_epipolar_lines(img0, img1, f, kpts0, color: Tuple[int, int, int] = (0, 200, 255),
                        lw: int = 1) -> np.ndarray:
    """The epipolar lines in image 1 of points of image 0, under the
    fundamental matrix ``f`` (image 0 -> image 1)."""
    import cv2

    canvas, off = side_by_side(img0, img1)
    h1, w1 = _as_u8(img1).shape[:2]
    kpts0 = _np(kpts0)
    canvas = draw_keypoints(canvas, kpts0, color=color)
    f = _np(f, np.float64)
    for p in kpts0:
        a, b, c = f @ np.array([p[0], p[1], 1.0])
        pts = []  # a x + b y + c = 0 against the image's border
        if abs(b) > 1e-12:
            for x in (0.0, w1 - 1.0):
                y = -(a * x + c) / b
                if -1 <= y <= h1:
                    pts.append((x, y))
        if abs(a) > 1e-12:
            for y in (0.0, h1 - 1.0):
                x = -(b * y + c) / a
                if -1 <= x <= w1:
                    pts.append((x, y))
        if len(pts) >= 2:
            cv2.line(canvas, _pt(pts[0], off), _pt(pts[1], off), color, lw, cv2.LINE_AA)
    return canvas


def heatmap_overlay(image, heat, alpha: float = 0.5, vmin: float = 0.0,
                    vmax: Optional[float] = None) -> np.ndarray:
    """A scalar map [H, W] blended over the image, blue (low) to red (high)."""
    img = _as_u8(image).astype(np.float64)
    h = _np(heat, np.float64)
    vmax = float(h.max()) if vmax is None else vmax
    x = np.clip((h - vmin) / max(vmax - vmin, 1e-12), 0.0, 1.0)
    overlay = np.stack([x, np.zeros_like(x), 1.0 - x], -1) * 255.0
    if overlay.shape[:2] != img.shape[:2]:
        import cv2

        overlay = cv2.resize(overlay, (img.shape[1], img.shape[0]))
        x = cv2.resize(x, (img.shape[1], img.shape[0]))
    out = img * (1 - alpha * x[..., None]) + overlay * (alpha * x[..., None])
    return out.astype(np.uint8)


def plot_cumulative_errors(errors: dict, thresholds: Sequence[float] = (1.0, 50.0),
                           path: Optional[str] = None):
    """Cumulative error curves (name -> errors) as a matplotlib figure
    (Agg), saved to ``path`` when given."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    xs = np.linspace(thresholds[0], thresholds[1], 256)
    for name, errs in errors.items():
        e = np.sort(_np(errs, np.float64))
        ax.plot(xs, [np.mean(e <= x) for x in xs], label=name)
    ax.set_xlabel("error threshold")
    ax.set_ylabel("fraction of pairs")
    ax.set_ylim(0, 1)
    ax.legend()
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=100)
    return fig


def make_match_figures(pred: dict, data: dict, n_pairs: int = 2):
    """The first ``n_pairs`` of a training batch: predicted matches whose
    label is not IGNORE, red to green by correctness, over every keypoint in
    royal blue. pred: keypoints0/1 [B, N, 2], matches0 and gt_matches0 [B,
    N]; data: image0/1 [B, H, W(, C)] in [0, 1]. Returns {"matching": [uint8
    image per pair]}."""
    kp0, kp1 = _np(pred["keypoints0"]), _np(pred["keypoints1"])
    m0, gtm0 = _np(pred["matches0"]), _np(pred["gt_matches0"])
    img0, img1 = _np(data["image0"]), _np(data["image1"])
    figures = []
    for i in range(min(n_pairs, kp0.shape[0])):
        valid = (m0[i] > -1) & (gtm0[i] >= -1)
        canvas = draw_matches(img0[i], img1[i], kp0[i][valid], kp1[i][m0[i][valid]],
                              correct=gtm0[i][valid] == m0[i][valid], ps=0, lw=1)
        off = canvas.shape[1] - img1[i].shape[1]
        canvas = draw_keypoints(canvas, kp0[i], color=(65, 105, 225))
        canvas = draw_keypoints(canvas, np.asarray(kp1[i], np.float64) + np.asarray([off, 0.0]),
                                color=(65, 105, 225))
        figures.append(canvas)
    return {"matching": figures}
