"""Line-segment detection, wireframes and a baseline line matcher.

Counterpart of ``comet_tpu/matching/lines.py`` (glue-factory's
models/lines/lsd.py and wireframe.py): a static-shape anchor-marching
detector in place of LSD's region growing. The strongest gradient pixel of
each cell is an anchor; the top ``max_lines`` cells' anchors each march a
fixed number of steps both ways along their level line, and a step survives
while the sampled edge strength stays above half the threshold and its
orientation within ``angle_tol`` (mod pi) of the anchor's; a cumulative
product ends each walk at its first failure. Line descriptors are bilinear
samples of a dense map along each segment, L2-normalized per point.

The JAX package's conventions are kept where they decide the result: the
Sobel filter is zero-padded ("SAME"), each cell's argmax takes its first
maximum, the top-k of the cells keeps ties (the ``-inf`` of empty cells)
in index order (``models.superpoint.top_k``, as ``jax.lax.top_k``), and the
sample positions along a segment are ``jnp.linspace``'s (``i * (1 / (n -
1))`` in f32, the last exactly 1). The Sobel sums its taps as separate
multiplies and adds of shifted slices, in one fixed order, so the card and
the CPU filter bit for bit alike, and the gradient's magnitude is correctly
rounded (``gradient_magnitude``), as ``jnp.sqrt`` rounds it.

:func:`make_wireframe` (``extractor_wireframe``) pairs a registered point
extractor with the detector (or a registered learned one, such as
``lines_deeplsd``) and samples line descriptors from the gradient map.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.superpoint import top_k
from ..ops.bilinear import bilinear_sample
from .matchers import mutual_nearest_neighbor
from .registry import register_model

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


class LineSegments(NamedTuple):
    segments: torch.Tensor  # [K, 2, 2] endpoints (x, y) pixels
    scores: torch.Tensor  # [K] mean edge strength along the segment
    valid: torch.Tensor  # [K] bool (an anchor, and long enough)


def linspace01(n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` in f32: ``i * (1 / (n - 1))``, the last
    entry exactly 1 (``torch.linspace`` rounds some entries the other way)."""
    if n == 1:
        return torch.zeros(1, device=device)
    i = torch.arange(n, device=device)
    # the last entry set on the device (an item assignment copies from the host)
    return torch.where(i == n - 1, 1.0, i.float() * (1.0 / (n - 1)))


def _correlate3(img: torch.Tensor, k) -> torch.Tensor:
    """[H, W] cross-correlated with a 3 x 3 kernel, zero-padded: the
    nonzero taps summed row by row."""
    h, w = img.shape
    xp = F.pad(img, (1, 1, 1, 1))
    out = None
    for i in range(3):
        for j in range(3):
            if k[i][j] == 0.0:
                continue
            term = xp[i:i + h, j:j + w] * (k[i][j] / 8.0)
            out = term if out is None else out + term
    return out


def image_gradients(gray: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sobel gx, gy (divided by 8) of [H, W] in [0, 1]."""
    return _correlate3(gray, _SOBEL_X), _correlate3(gray, tuple(zip(*_SOBEL_X)))


def gradient_magnitude(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """sqrt(gx^2 + gy^2) correctly rounded, as ``jnp.sqrt`` gives it on the
    CPU: the square root taken in f64 and rounded once. Measured on the
    tests' 64 x 64 Sobel fields with torch 2.13.0+cpu (an MKL build) by
    ``tools/torch_sqrt_probe.py`` (180 calls per method): ``torch.sqrt`` in
    f32 at most 1 ulp from the correctly rounded root, ``jnp.sqrt`` and this
    function 0 ulps; the tests hold this function to ``jnp.sqrt`` bit for
    bit on the same gradients."""
    return torch.sqrt((gx * gx + gy * gy).double()).to(gx.dtype)


def detect_line_segments(
    gray: torch.Tensor,  # [H, W] in [0, 1]
    max_lines: int = 64,
    n_steps: int = 32,
    step: float = 1.5,
    mag_threshold: float = 0.02,
    angle_tol: float = 0.4,
    min_length: float = 8.0,
    nms_radius: int = 4,
) -> LineSegments:
    """The LSD stand-in: anchor marching over the Sobel gradient's magnitude
    and orientation (see the module docstring)."""
    gx, gy = image_gradients(gray)
    mag = gradient_magnitude(gx, gy)
    theta = torch.atan2(gy, gx)
    return march_segments_from_fields(
        mag, theta, max_lines=max_lines, n_steps=n_steps, step=step,
        mag_threshold=mag_threshold, angle_tol=angle_tol, min_length=min_length,
        nms_radius=nms_radius)


def march_segments_from_fields(
    mag: torch.Tensor,  # [H, W] edge strength (the gradient's or a learned one)
    theta: torch.Tensor,  # [H, W] the NORMAL orientation (perpendicular to lines)
    max_lines: int = 64,
    n_steps: int = 32,
    step: float = 1.5,
    mag_threshold: float = 0.02,
    angle_tol: float = 0.4,
    min_length: float = 8.0,
    nms_radius: int = 4,
) -> LineSegments:
    """The anchor-marching core of the LSD and DeepLSD stand-ins: the best
    pixel of each 2 * nms_radius cell, the top ``max_lines`` cells, a march
    of ``n_steps`` steps each way. Segments are [K, 2, 2]; an empty cell's
    anchor is not valid."""
    h, w = mag.shape
    dev = mag.device
    cell = 2 * nms_radius
    hc, wc = -(-h // cell), -(-w // cell)
    padded = torch.full((hc * cell, wc * cell), -torch.inf, dtype=mag.dtype, device=dev)
    padded[:h, :w] = torch.where(mag > mag_threshold, mag, -torch.inf)
    cells = padded.reshape(hc, cell, wc, cell).permute(0, 2, 1, 3).reshape(hc * wc, cell * cell)
    in_cell = cells.argmax(dim=-1)  # the first maximum
    cell_best = cells.gather(1, in_cell[:, None])[:, 0]
    peak_scores, cidx = top_k(cell_best, max_lines)
    best = in_cell[cidx]
    ay = (torch.div(cidx, wc, rounding_mode="floor") * cell
          + torch.div(best, cell, rounding_mode="floor")).float()
    ax = ((cidx % wc) * cell + best % cell).float()
    anchor_ok = torch.isfinite(peak_scores)

    # the level line's direction (unit): perpendicular to the anchor's normal
    a_theta = theta[ay.long(), ax.long()]
    dx = -torch.sin(a_theta)
    dy = torch.cos(a_theta)
    t = (torch.arange(1, n_steps + 1, dtype=torch.float32, device=dev) * step)[None, :]
    maps = torch.stack([mag, theta], dim=-1)

    def march(sign: float):
        px = ax[:, None] + sign * dx[:, None] * t  # [K, n_steps]
        py = ay[:, None] + sign * dy[:, None] * t
        inside = (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)
        pts = torch.stack([px.clamp(0, w - 1), py.clamp(0, h - 1)], dim=-1)
        sampled = bilinear_sample(maps, pts)
        m, th = sampled[..., 0], sampled[..., 1]
        # the orientation difference mod pi (level lines are undirected)
        dth = (th - a_theta[:, None]).abs()
        dth = torch.minimum(dth, (dth - torch.pi).abs())
        ok = inside & (m > mag_threshold * 0.5) & (dth < angle_tol)
        alive = torch.cumprod(ok.to(torch.int32), dim=1)  # ends at the first failure
        count = alive.sum(dim=1)
        length = count.float() * step
        return length, (alive * m).sum(dim=1) / count.clamp_min(1)

    len_pos, mag_pos = march(1.0)
    len_neg, mag_neg = march(-1.0)
    e0 = torch.stack([ax - dx * len_neg, ay - dy * len_neg], dim=-1)
    e1 = torch.stack([ax + dx * len_pos, ay + dy * len_pos], dim=-1)
    total_len = len_pos + len_neg
    scores = (mag_pos * len_pos + mag_neg * len_neg) / total_len.clamp_min(1e-6)
    valid = anchor_ok & (total_len >= min_length)
    return LineSegments(segments=torch.stack([e0, e1], dim=1),
                        scores=torch.where(valid, scores, 0.0), valid=valid)


def sample_line_points(segments: torch.Tensor, n_samples: int) -> torch.Tensor:
    """[K, 2, 2] -> [K, n_samples, 2] evenly spaced points along each
    segment, the endpoints included."""
    t = linspace01(n_samples, segments.device)[None, :, None]
    return segments[:, 0:1] * (1 - t) + segments[:, 1:2] * t


def sample_line_descriptors(
    desc_map: torch.Tensor,  # [H, W, D] dense descriptors
    segments: torch.Tensor,  # [K, 2, 2]
    n_samples: int = 5,
) -> torch.Tensor:
    """[K, n_samples, D] bilinear descriptor samples along each line (inside
    the map), L2-normalized per point."""
    h, w = desc_map.shape[:2]
    pts = sample_line_points(segments, n_samples)
    pts = torch.stack([pts[..., 0].clamp(0, w - 1), pts[..., 1].clamp(0, h - 1)], dim=-1)
    d = bilinear_sample(desc_map, pts)
    norm = torch.linalg.vector_norm(d.float(), dim=-1, keepdim=True).clamp_min(1e-8)
    return d / norm.to(d.dtype)


def match_lines_nn(
    ldesc0: torch.Tensor,  # [K0, S, D]
    ldesc1: torch.Tensor,  # [K1, S, D]
    valid0: Optional[torch.Tensor] = None,
    valid1: Optional[torch.Tensor] = None,
    threshold: float = 0.0,
) -> Dict[str, torch.Tensor]:
    """Baseline line matcher: mutual nearest neighbours of the normalized
    mean line descriptors."""

    def norm(x):
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-8)

    return mutual_nearest_neighbor(norm(ldesc0.mean(dim=1)), norm(ldesc1.mean(dim=1)),
                                   threshold=threshold, valid0=valid0, valid1=valid1)


@register_model(
    "extractor_wireframe",
    {"point_extractor": "extractor_sift", "point_conf": {},
     "line_detector": None, "line_conf": {},
     "max_lines": 64, "n_line_samples": 5},
)
def make_wireframe(
    point_extractor: str = "extractor_sift",
    point_conf: Optional[Dict] = None,
    line_detector: Optional[str] = None,
    line_conf: Optional[Dict] = None,
    max_lines: int = 64,
    n_line_samples: int = 5,
    device=None,
):
    """Wireframe extractor: a registered point extractor's features, line
    segments (the LSD stand-in, or the registered ``line_detector``, e.g.
    "lines_deeplsd", a callable gray -> :class:`LineSegments`) and line
    descriptors sampled from the (gx, gy, |g|) gradient map. An image runs
    where it lives; a numpy image goes to ``device`` (the card by default).
    The returned callable keeps the two parts as ``point_extractor`` and
    ``line_detector`` (None for the LSD stand-in)."""
    from .extractors import as_image
    from .registry import get_model

    extract_points = get_model(point_extractor, **(point_conf or {}), device=device)
    detect = None
    if line_detector is not None:
        detect = get_model(line_detector, **{"max_lines": max_lines, **(line_conf or {})},
                           device=device)

    def extract(image) -> Dict[str, torch.Tensor]:
        image = as_image(image, device, "extractor_wireframe")
        gray = image.mean(dim=-1) if image.dim() == 3 else image
        pts = extract_points(image)
        segs = detect(gray) if detect is not None else detect_line_segments(
            gray, max_lines=max_lines)
        gx, gy = image_gradients(gray)
        desc_map = torch.stack([gx, gy, gradient_magnitude(gx, gy)], dim=-1)
        ldesc = sample_line_descriptors(desc_map, segs.segments, n_samples=n_line_samples)
        return {
            **pts,
            "lines": segs.segments,
            "line_scores": segs.scores,
            "line_valid": segs.valid,
            "line_descriptors": ldesc,
        }

    extract.point_extractor, extract.line_detector = extract_points, detect
    return extract
