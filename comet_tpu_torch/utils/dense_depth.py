"""Dense-depth workflow: disparity alignment, COLMAP array IO, z-buffering.

Counterpart of ``comet_tpu/utils/dense_depth.py`` (the reference's
comet/utils/utils.py: align_dense_depth_maps:644-779, the RANSAC
scale/shift alignment of monocular disparity to SfM sparse depth, the
disparity-to-depth conversion and the dense unprojection;
read_array/write_array:349-399, COLMAP MVS binary float maps in the
src/mvs/mat.h layout; filter_invisible_reprojections:402-434, the z-buffer
mask of reprojected points). The monocular-depth network itself is a
pluggable callable. Host numpy: this feeds visualization and export.
"""

from __future__ import annotations


from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "filter_invisible_reprojections",
    "ransac_linear_fit",
    "align_disparity_to_sparse",
    "align_dense_depth_maps",
    "unproject_depth_map",
    "read_colmap_array",
    "write_colmap_array",
]

DISPARITY_MAX = 10000.0
DISPARITY_MIN = 0.0001


def filter_invisible_reprojections(
    uvs_int: np.ndarray, depths: np.ndarray
) -> np.ndarray:
    """Keep, per duplicated integer pixel, only the smallest-depth point
    (utils.py:402-434). Returns a boolean keep-mask [n]."""
    _, inverse, counts = np.unique(
        uvs_int, axis=0, return_inverse=True, return_counts=True
    )
    mask = np.ones(uvs_int.shape[0], bool)
    for i in np.where(counts > 1)[0]:
        dup = np.where(inverse == i)[0]
        mask[dup] = False
        mask[dup[np.argmin(depths[dup])]] = True
    return mask


def ransac_linear_fit(
    x: np.ndarray,
    y: np.ndarray,
    residual_threshold: float,
    max_trials: int = 2000,
    seed: int = 0,
) -> Tuple[float, float, np.ndarray]:
    """1-D RANSAC line fit y ~ scale*x + shift with a least-squares refit
    on the best consensus set (the RANSACRegressor(LinearRegression,
    min_samples=2) recipe of utils.py:709-718, without the sklearn
    dependency). Returns (scale, shift, inlier_mask)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = x.shape[0]
    if n < 2:
        raise ValueError("need at least 2 points")
    rng = np.random.default_rng(seed)
    # vectorized hypothesis sweep, CHUNKED: the residual matrix is
    # [chunk, n] — with max_trials=20000 and n~10^4 an unchunked sweep
    # would allocate gigabytes; 512 trials at a time keeps it ~40 MB
    # while producing identical results
    trials = min(max_trials, max(n * (n - 1), 1))
    best_count, mask = -1, None
    for start in range(0, trials, 512):
        chunk = min(512, trials - start)
        i = rng.integers(0, n, chunk)
        j = rng.integers(0, n - 1, chunk)
        j = np.where(j >= i, j + 1, j)  # j != i
        dx = x[j] - x[i]
        ok = np.abs(dx) > 1e-12
        slope = np.where(ok, (y[j] - y[i]) / np.where(ok, dx, 1.0), 0.0)
        inter = y[i] - slope * x[i]
        resid = np.abs(
            y[None, :] - (slope[:, None] * x[None, :] + inter[:, None])
        )
        inliers = (resid <= residual_threshold) & ok[:, None]
        counts = inliers.sum(1)
        b = int(np.argmax(counts))
        if counts[b] > best_count:
            best_count = int(counts[b])
            mask = inliers[b]
    if mask is None or mask.sum() < 2:
        mask = np.ones(n, bool)
    # least-squares refit on the consensus set
    a = np.stack([x[mask], np.ones(mask.sum())], -1)
    sol, *_ = np.linalg.lstsq(a, y[mask], rcond=None)
    return float(sol[0]), float(sol[1]), mask


def align_disparity_to_sparse(
    disp_map: np.ndarray,  # [H, W] monocular disparity (0 = invalid)
    sparse_uvd: np.ndarray,  # [N, 3] (u, v, sfm_depth)
    thres_ratio: float = 30.0,
    max_trials: int = 20000,
    seed: int = 0,
) -> np.ndarray:
    """Scale/shift-align a monocular disparity map to SfM sparse depths
    and convert to metric depth (utils.py:668-735 semantics: nearest
    sampling of disparity at the sparse projections, RANSAC line fit of
    1/depth against disparity with threshold median/thres_ratio, then
    rescale, validity-clip and invert). Returns the [H, W] depth map
    (0 = invalid)."""
    disp_map = np.asarray(disp_map, np.float32).copy()
    sparse_uvd = np.asarray(sparse_uvd, np.float64)
    if len(sparse_uvd) <= 0:
        raise ValueError("Too few points for depth alignment")
    hh, ww = disp_map.shape  # NOTE reference binds (ww, hh) = shape; its
    # bounds check transposes accordingly — here plain (rows, cols)
    int_uv = np.round(sparse_uvd[:, :2]).astype(int)
    inb = (
        (int_uv[:, 0] >= 0) & (int_uv[:, 0] < ww)
        & (int_uv[:, 1] >= 0) & (int_uv[:, 1] < hh)
    )
    sparse_uvd = sparse_uvd[inb]
    int_uv = int_uv[inb]
    sampled = disp_map[int_uv[:, 1], int_uv[:, 0]]
    pos = sampled > 0
    sampled = sampled[pos]
    sfm_depth = np.clip(
        sparse_uvd[:, 2][pos], 1.0 / DISPARITY_MAX, 1.0 / DISPARITY_MIN
    )
    target = 1.0 / sfm_depth
    thr = float(np.median(target)) / thres_ratio
    if thr <= 0:
        raise ValueError("Ill-posed scene for depth alignment")
    scale, shift, _ = ransac_linear_fit(
        sampled, target, residual_threshold=thr, max_trials=max_trials,
        seed=seed,
    )
    nz = disp_map != 0
    disp_map[nz] = disp_map[nz] * scale + shift
    valid = (disp_map > 0) & (disp_map <= DISPARITY_MAX)
    disp_map[~valid] = 0.0
    depth = np.zeros_like(disp_map)
    dz = disp_map != 0
    depth[dz] = 1.0 / disp_map[dz]
    return depth.astype(np.float32)


def align_dense_depth_maps(
    sparse_depth: Dict[str, np.ndarray],
    disp_dict: Dict[str, np.ndarray],
    **kwargs,
) -> Dict[str, np.ndarray]:
    """Per-image driver over align_disparity_to_sparse
    (utils.py:644-735 minus the pycolmap Reconstruction plumbing — the
    sparse projections come in directly as {name: [N, 3] (u, v, depth)})."""
    return {
        name: align_disparity_to_sparse(disp_dict[name], uvd, **kwargs)
        for name, uvd in sparse_depth.items()
    }


def unproject_depth_map(
    depth_map: np.ndarray,  # [H, W], 0 = invalid
    k: np.ndarray,  # [3, 3]
    r: np.ndarray,  # [3, 3] world->cam rotation
    t: np.ndarray,  # [3] world->cam translation
    rgb: Optional[np.ndarray] = None,  # [H, W, 3]
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Dense point cloud from an aligned depth map
    (utils.py:737-774 visual_dense_point_cloud): every valid pixel is
    lifted by its depth and moved to world coordinates x_w = R^T(x_c - t).
    Returns (points [M, 3], colors [M, 3] or None)."""
    h, w = depth_map.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    valid = depth_map.reshape(-1) > 0
    uv1 = np.stack(
        [xs.reshape(-1), ys.reshape(-1), np.ones(h * w)], -1
    )[valid]
    d = depth_map.reshape(-1)[valid]
    cam = (uv1 @ np.linalg.inv(k).T) * d[:, None]
    world = (cam - t) @ r
    colors = None
    if rgb is not None:
        colors = rgb.reshape(-1, rgb.shape[-1])[valid]
    return world, colors


# ---------------------------------------------------------------- COLMAP IO


def write_colmap_array(array: np.ndarray, path: str) -> str:
    """COLMAP MVS binary float map (utils.py:368-399 / colmap
    src/mvs/mat.h): ASCII "w&h&c&" header + little-endian f32 data in
    Fortran order over (width, height, channels)."""
    array = np.asarray(array)
    assert array.dtype == np.float32, "COLMAP maps are float32"
    if array.ndim == 2:
        height, width = array.shape
        channels = 1
        trans = np.transpose(array, (1, 0))
    elif array.ndim == 3:
        height, width, channels = array.shape
        trans = np.transpose(array, (1, 0, 2))
    else:
        raise ValueError("expected a 2-D or 3-D map")
    with open(path, "wb") as fid:
        fid.write(f"{width}&{height}&{channels}&".encode())
        data = trans.reshape(-1, order="F")
        fid.write(data.astype("<f4", copy=False).tobytes())
    return path


def read_colmap_array(path: str) -> np.ndarray:
    """Inverse of write_colmap_array (utils.py:349-365)."""
    with open(path, "rb") as fid:
        header = b""
        delims = 0
        while delims < 3:
            byte = fid.read(1)
            if not byte:
                raise ValueError("truncated COLMAP array header")
            header += byte
            if byte == b"&":
                delims += 1
        width, height, channels = (
            int(v) for v in header.decode().split("&")[:3]
        )
        array = np.fromfile(fid, np.float32)
    array = array.reshape((width, height, channels), order="F")
    return np.transpose(array, (1, 0, 2)).squeeze()
