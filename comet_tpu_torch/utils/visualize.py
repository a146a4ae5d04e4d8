"""Host-side visualization: track overlays and pose-axes renderings.

Counterpart of ``comet_tpu/utils/visualize.py``. Parity targets:
comet/models/visualizer.py:62 (track-overlay video writer,
save_track_flow:189-247) and save_first_k_pose_images
(train_eval_func_new_cp5.py:383-511, pred vs gt axes projected with K).
Pure numpy + cv2/matplotlib; stays off the device path.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..data.keypoints import denormalize_image


def _color_map(n: int) -> np.ndarray:
    """n distinct BGR colors via HSV wheel."""
    import cv2

    hsv = np.stack(
        [np.linspace(0, 179, n, endpoint=False), np.full(n, 255), np.full(n, 255)],
        axis=-1,
    ).astype(np.uint8)[None]
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)[0]


def draw_tracks_on_frames(
    images: np.ndarray,  # [S, H, W, 3] normalized floats or uint8
    tracks: np.ndarray,  # [S, N, 2]
    visibility: Optional[np.ndarray] = None,  # [S, N]
    trail: int = 6,
) -> np.ndarray:
    """Render per-frame track overlays with motion trails -> [S, H, W, 3] u8."""
    import cv2

    s, n = tracks.shape[:2]
    colors = _color_map(n)
    frames = []
    for t in range(s):
        img = images[t]
        frame = (
            denormalize_image(img) if img.dtype != np.uint8 else img.copy()
        )
        frame = np.ascontiguousarray(frame[..., ::-1])  # RGB -> BGR
        for i in range(n):
            if visibility is not None and visibility[t, i] < 0.5:
                continue
            x, y = tracks[t, i]
            cv2.circle(frame, (int(round(x)), int(round(y))), 2, colors[i].tolist(), -1)
            for back in range(1, min(trail, t) + 1):
                x0, y0 = tracks[t - back, i]
                x1, y1 = tracks[t - back + 1, i]
                cv2.line(
                    frame,
                    (int(round(x0)), int(round(y0))),
                    (int(round(x1)), int(round(y1))),
                    colors[i].tolist(),
                    1,
                )
        frames.append(frame[..., ::-1])  # back to RGB
    return np.stack(frames)


def save_track_video(
    images: np.ndarray,
    tracks: np.ndarray,
    path: str,
    visibility: Optional[np.ndarray] = None,
    fps: int = 8,
) -> str:
    """Write the track-overlay MP4 (visualizer.py save_video equivalent)."""
    import cv2

    frames = draw_tracks_on_frames(images, tracks, visibility)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for f in frames:
        writer.write(f[..., ::-1])
    writer.release()
    return path


def draw_pose_axes(
    image: np.ndarray,  # [H, W, 3] uint8 (or normalized float)
    r_pred: np.ndarray,  # [3, 3] column-vector rotation
    t_pred: np.ndarray,  # [3]
    k: np.ndarray,  # [3, 3]
    r_gt: Optional[np.ndarray] = None,
    t_gt: Optional[np.ndarray] = None,
    axis_len: float = 5.0,
) -> np.ndarray:
    """Project object axes with K and draw pred (solid) vs gt (thin)
    (save_first_k_pose_images equivalent)."""
    import cv2

    img = denormalize_image(image) if image.dtype != np.uint8 else image.copy()
    img = np.ascontiguousarray(img)

    def project(r, t):
        pts = np.float64(
            [[0, 0, 0], [axis_len, 0, 0], [0, axis_len, 0], [0, 0, axis_len]]
        )
        cam = pts @ r.T + t
        pix = cam @ k.T
        return (pix[:, :2] / pix[:, 2:]).astype(int)

    axis_colors = [(0, 0, 255), (0, 255, 0), (255, 0, 0)]

    def draw(r, t, thickness):
        p = project(r, t)
        for i, c in enumerate(axis_colors):
            cv2.line(img, tuple(p[0]), tuple(p[i + 1]), c, thickness)

    if r_gt is not None:
        draw(r_gt, t_gt if t_gt is not None else np.zeros(3), 1)
    draw(r_pred, t_pred, 2)
    return img


def save_pose_axes_images(
    images: Sequence[np.ndarray],
    r_pred: np.ndarray,  # [S, 3, 3]
    t_pred: np.ndarray,  # [S, 3]
    k: np.ndarray,
    out_dir: str,
    r_gt: Optional[np.ndarray] = None,
    t_gt: Optional[np.ndarray] = None,
) -> str:
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    for i, img in enumerate(images):
        rendered = draw_pose_axes(
            np.asarray(img), r_pred[i], t_pred[i], k,
            r_gt[i] if r_gt is not None else None,
            t_gt[i] if t_gt is not None else None,
        )
        cv2.imwrite(os.path.join(out_dir, f"pose_{i:04d}.png"), rendered[..., ::-1])
    return out_dir


def project_scene_points(
    points3d: np.ndarray,  # [N, 3] world
    r: np.ndarray,  # [3, 3] row-convention rotation (x_cam = x @ R + T)
    t: np.ndarray,  # [3]
    k: np.ndarray,  # [3, 3]
) -> tuple:
    """Project world points into one view; returns (uv [N, 2], depth [N],
    in_front [N])."""
    cam = points3d @ r + t
    depth = cam[:, 2]
    pix = cam @ k.T
    uv = pix[:, :2] / np.maximum(np.abs(pix[:, 2:]), 1e-8)
    return uv, depth, depth > 1e-6


def draw_reprojections(
    images: np.ndarray,  # [S, H, W, 3] uint8 or normalized float
    points3d: np.ndarray,  # [N, 3]
    r: np.ndarray,  # [S, 3, 3] row-convention
    t: np.ndarray,  # [S, 3]
    k: np.ndarray,  # [3, 3]
    valid: Optional[np.ndarray] = None,  # [N]
    draw_radius: int = 3,
    cmap: str = "gist_rainbow",
    color_mode: str = "dis_to_center",
) -> np.ndarray:
    """Per-frame reprojection overlays of the reconstructed cloud
    (create_video_with_reprojections capability,
    comet/utils/utils.py:437-530): each 3-D point is drawn as a circle at
    its reprojected location, colored by distance-to-scene-center
    ("dis_to_center") or by per-view depth ("depth"). Returns [S, H, W, 3]
    uint8 RGB frames."""
    import cv2
    import matplotlib

    colormap = matplotlib.colormaps.get_cmap(cmap)
    pts = np.asarray(points3d, np.float64)
    keep = np.ones(len(pts), bool) if valid is None else np.asarray(valid, bool)
    pts = pts[keep]

    if color_mode == "dis_to_center":
        center = pts.mean(axis=0) if len(pts) else np.zeros(3)
        dis = np.linalg.norm(pts - center, axis=-1)
        lo, hi = (dis.min(), dis.max()) if len(pts) else (0.0, 1.0)
        norm = (dis - lo) / max(hi - lo, 1e-8)
        static_colors = (np.asarray(colormap(norm))[:, :3] * 255).astype(np.uint8)
    else:
        static_colors = None

    frames = []
    for i in range(len(images)):
        img = np.asarray(images[i])
        frame = (
            denormalize_image(img) if img.dtype != np.uint8 else img.copy()
        )
        frame = np.ascontiguousarray(frame)
        uv, depth, front = project_scene_points(pts, r[i], t[i], k)
        if color_mode == "depth" and front.any():
            lo, hi = depth[front].min(), depth[front].max()
            norm = (depth - lo) / max(hi - lo, 1e-8)
            colors = (np.asarray(colormap(norm))[:, :3] * 255).astype(np.uint8)
        else:
            colors = static_colors
        h, w = frame.shape[:2]
        inside = front & (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
        for j in np.nonzero(inside)[0]:
            cv2.circle(
                frame, (int(uv[j, 0]), int(uv[j, 1])), draw_radius,
                colors[j].tolist() if colors is not None else (0, 255, 0), -1,
            )
        frames.append(frame)
    return np.stack(frames)


def save_reprojection_video(
    path: str,
    images: np.ndarray,
    points3d: np.ndarray,
    r: np.ndarray,
    t: np.ndarray,
    k: np.ndarray,
    valid: Optional[np.ndarray] = None,
    fps: int = 8,
    **kwargs,
) -> str:
    """Reprojection MP4 (create_video_with_reprojections + imageio writer
    capability, utils.py:437,530-560)."""
    import cv2

    frames = draw_reprojections(images, points3d, r, t, k, valid, **kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        writer.write(f[..., ::-1])
    writer.release()
    return path


def depth_map_visual(
    depth_map: np.ndarray,  # [H, W]
    raw_img: np.ndarray,  # [H, W, 3] uint8 RGB
    output_path: Optional[str] = None,
    cmap: str = "Spectral_r",
) -> np.ndarray:
    """Side-by-side raw | colormapped-depth panel
    (create_depth_map_visual parity, comet/utils/utils.py:583-609: min-max
    normalize to u8, Spectral_r colormap, 50-px white split, hconcat).
    Returns the combined RGB u8 image; writes a PNG when output_path is
    given."""
    import matplotlib

    d = np.asarray(depth_map, np.float64)
    lo, hi = d.min(), d.max()
    visual = ((d - lo) / max(hi - lo, 1e-12) * 255.0).astype(np.uint8)
    colormap = matplotlib.colormaps.get_cmap(cmap)
    visual = (np.asarray(colormap(visual))[:, :, :3] * 255).astype(np.uint8)
    split = np.full((raw_img.shape[0], 50, 3), 255, np.uint8)
    combined = np.concatenate([np.asarray(raw_img), split, visual], axis=1)
    if output_path:
        from PIL import Image

        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        Image.fromarray(combined).save(output_path)
    return combined


def sparse_depth_from_scene(
    points3d: np.ndarray,  # [N, 3]
    r: np.ndarray,  # [S, 3, 3]
    t: np.ndarray,  # [S, 3]
    k: np.ndarray,
    hw: tuple,
    valid: Optional[np.ndarray] = None,
) -> list:
    """Per-frame sparse depth samples [(uv [M, 2], depth [M])] from the
    reconstruction — the sparse_depth dict of utils.py:437's caller
    (triangulator.py's depth alignment input)."""
    pts = np.asarray(points3d, np.float64)
    if valid is not None:
        pts = pts[np.asarray(valid, bool)]
    h, w = hw
    out = []
    for i in range(len(r)):
        uv, depth, front = project_scene_points(pts, r[i], t[i], k)
        inside = front & (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
        out.append((uv[inside], depth[inside]))
    return out


def save_query_points_image(
    images: np.ndarray,
    query_index: int,
    query_points: np.ndarray,
    save_name: str = "query_points.png",
    radius: int = 4,
) -> str:
    """Draw the seeded query points on one frame and save it
    (visual_query_points, comet/utils/utils.py:320-347: green filled
    circles on the selected frame). images: [S, H, W, 3] float in [0, 1]
    or [S, 3, H, W]; query_points: [N, 2] (x, y) pixels."""
    import cv2

    img = np.asarray(images[query_index])
    if img.ndim == 3 and img.shape[0] == 3:  # CHW -> HWC
        img = img.transpose(1, 2, 0)
    img_u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    bgr = cv2.cvtColor(img_u8, cv2.COLOR_RGB2BGR)
    for x, y in np.asarray(query_points).reshape(-1, 2):
        bgr = cv2.circle(bgr, (int(x), int(y)), radius, (0, 255, 0), -1)
    cv2.imwrite(save_name, bgr)
    return save_name
