"""Input preprocessing on the card: crop + resize + normalize.

Counterpart of ``comet_tpu/data/device_pipeline.py``. The host path
(``datasets.py``) preprocesses with PIL: sequence square crop -> LANCZOS
resize -> ImageNet normalize. Here the host only decodes the frames (and
computes the mask bbox); the crop + resize + normalization run as tensor
ops on the given device. The fused crop-resize is two sampling-matrix
products: output row i samples the source at ``y0 + (i + 0.5) * box / out -
0.5`` (the half-pixel resize convention, torch ``interpolate(align_corners=
False)``), with the filter's weights folded into the matrices and
out-of-image taps carrying zero weight, as PIL's zero padding of a crop that
exceeds the image.

Two filters: "bilinear" (cheapest) and "lanczos" (PIL's Lanczos-3 as the
same kind of sampling matrices, which matches the host path up to PIL's
per-pass uint8 rounding). The products stay in f32: TF32 must be off
(``torch.backends.cuda.matmul.allow_tf32``, PyTorch's default), or
:func:`preprocess_frames` raises on the card.

On the card, :class:`DevicePreprocessDataset` does its device work on a
stream of its own (it runs on ``prefetch``'s producer thread) and hands the
images over with a CUDA event; the consumer calls :func:`wait_ready`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from .datasets import SequenceSample, VideoPoseDataset

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def _sampling_matrix(src_size: int, start: torch.Tensor, box: torch.Tensor,
                     out_size: int) -> torch.Tensor:
    """[out, src] bilinear crop-resize matrix from f32 scalars on the
    device. Out-of-range taps (a crop square partly outside the image) match
    no source pixel and contribute zero: PIL's crop zero-padding."""
    device = start.device
    pos = start + (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * (
        box / out_size
    ) - 0.5
    f = torch.floor(pos)
    w = pos - f
    i0 = f.to(torch.int32)
    rng = torch.arange(src_size, dtype=torch.int32, device=device)
    return (i0[:, None] == rng) * (1.0 - w[:, None]) + ((i0 + 1)[:, None] == rng) * w[:, None]


def _lanczos_matrix(src_size: int, start: torch.Tensor, box: torch.Tensor, out_size: int,
                    a: float = 3.0) -> torch.Tensor:
    """[out, src] Lanczos-3 crop-resize matrix with PIL's LANCZOS semantics
    for an integer crop box: tap windows live in crop coordinates (k = 0 ..
    box - 1), the filter widens by max(box / out, 1) when downscaling, the
    weights normalize over the in-crop window, and crop taps outside the
    source image vanish (PIL's zero-padded crop). The crop-coordinate axis
    is 2 * src_size long (a sequence square with its margin never exceeds
    that)."""
    f32 = dict(dtype=torch.float32, device=start.device)
    k = torch.arange(2 * src_size, **f32)
    scale = box / out_size
    fscale = torch.clamp(scale, min=1.0)
    center = (torch.arange(out_size, **f32) + 0.5) * scale
    x = (k[None, :] + 0.5 - center[:, None]) / fscale  # [out, 2 src]
    weights = torch.where((x.abs() < a) & (k[None, :] < box),
                          torch.sinc(x) * torch.sinc(x / a), torch.zeros((), **f32))
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-12)
    # crop tap k sits at source pixel floor(start) + k; out-of-image taps
    # match no column and contribute zero
    s_idx = torch.floor(start) + k
    onehot = (s_idx[:, None] == torch.arange(src_size, **f32)[None, :]).float()
    return weights @ onehot  # [out, src]


def _square(square, device) -> torch.Tensor:
    """The crop box (x0, y0, x1, y1) as f32 on the device."""
    if isinstance(square, torch.Tensor):
        return square.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(square, np.float32), device=device)


def _check_f32_products(device: torch.device) -> None:
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("preprocess_frames: TF32 is on (torch.backends.cuda.matmul."
                           "allow_tf32); the sampling products must run in f32")


def preprocess_frames(
    frames_u8: torch.Tensor,  # [S, H, W, 3] uint8
    square: Union[Sequence[float], np.ndarray, torch.Tensor],  # (x0, y0, x1, y1)
    crop_size: int,
    resample: str = "bilinear",
) -> torch.Tensor:
    """uint8 frames -> [S, crop, crop, 3] float32 ImageNet-normalized, on
    the frames' device. resample: "bilinear" or "lanczos" (the reference's
    PIL filter as sampling matrices)."""
    device = frames_u8.device
    _check_f32_products(device)
    s, h, w, _ = frames_u8.shape
    x0, y0, x1, y1 = _square(square, device)
    matrix = _lanczos_matrix if resample == "lanczos" else _sampling_matrix
    my = matrix(h, y0, y1 - y0, crop_size)
    mx = matrix(w, x0, x1 - x0, crop_size)
    img = frames_u8.float() / 255.0
    t = torch.einsum("oh,shwc->sowc", my, img)
    out = torch.einsum("sowc,pw->sopc", t, mx)
    mean = torch.tensor(_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(_STD, dtype=torch.float32, device=device)
    return (out - mean) / std


def preprocess_mask(
    mask_u8: torch.Tensor,  # [H, W] uint8
    square: Union[Sequence[float], np.ndarray, torch.Tensor],
    crop_size: int,
) -> torch.Tensor:
    """Nearest-neighbor crop-resize of the binary mask -> [crop, crop] bool."""
    device = mask_u8.device
    _check_f32_products(device)
    h, w = mask_u8.shape
    x0, y0, x1, y1 = _square(square, device)

    def nearest(src_size, start, box):
        pos = start + (torch.arange(crop_size, dtype=torch.float32, device=device) + 0.5) * (
            box / crop_size
        ) - 0.5
        idx = torch.round(pos).to(torch.int32)
        return (idx[:, None] == torch.arange(src_size, dtype=torch.int32, device=device)).float()

    my = nearest(h, y0, y1 - y0)
    mx = nearest(w, x0, x1 - x0)
    m = (mask_u8 > 0).float()
    return (my @ m @ mx.T) > 0.5


def _host_nearest_mask(mask_u8: np.ndarray, square, crop_size: int) -> np.ndarray:
    """Host-side twin of :func:`preprocess_mask` (same half-pixel rounding
    convention), avoiding a device round trip per sequence."""
    h, w = mask_u8.shape
    x0, y0, x1, y1 = [float(v) for v in square]

    def idx(src_size, start, box):
        pos = start + (np.arange(crop_size, dtype=np.float32) + 0.5) * (
            box / crop_size
        ) - 0.5
        return np.round(pos).astype(np.int64)

    yi = idx(h, y0, y1 - y0)
    xi = idx(w, x0, x1 - x0)
    valid = (yi >= 0) & (yi < h)
    validx = (xi >= 0) & (xi < w)
    m = (mask_u8 > 0)
    out = m[np.clip(yi, 0, h - 1)][:, np.clip(xi, 0, w - 1)]
    out &= valid[:, None] & validx[None, :]
    return out


def _host_crop_resize_u8(frame: np.ndarray, square, size: int) -> np.ndarray:
    """Cheap uint8 preview of the preprocessed frame (clip + pad + bilinear
    resize, cv2) for host-side keypoint seeding, so that seeding never
    reads the card's images back."""
    import cv2

    h, w = frame.shape[:2]
    x0, y0, x1, y1 = [int(v) for v in square]
    box = np.zeros((y1 - y0, x1 - x0, 3), np.uint8)
    sy0, sy1 = max(y0, 0), min(y1, h)
    sx0, sx1 = max(x0, 0), min(x1, w)
    if sy1 > sy0 and sx1 > sx0:
        box[sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0] = frame[sy0:sy1, sx0:sx1]
    return cv2.resize(box, (size, size), interpolation=cv2.INTER_LINEAR)


def wait_ready(sample: SequenceSample) -> None:
    """Make the current stream wait for ``sample.images`` (made on another
    stream of the card) and tell the allocator that the current stream uses
    them; nothing for host images."""
    if sample.ready is not None:
        stream = torch.cuda.current_stream(sample.images.device)
        stream.wait_event(sample.ready)
        sample.images.record_stream(stream)


class DevicePreprocessDataset:
    """Wrap a VideoPoseDataset so crop/resize/normalize run on the card.

    Same SequenceSample output as the host path; decode + bbox stay on the
    host (PIL). The frame-0 mask resizes on the host (exact twin of
    :func:`preprocess_mask`) and every sample carries a ``frame0_u8``
    preview (cv2), so keypoint seeding never reads the card's image back.

    ``keep_on_device=True`` returns the images as a tensor on the card
    (with ``ready``, the event the consumer waits on: :func:`wait_ready`)
    instead of numpy, so the eval step takes them without a round trip
    through the host. ``device``: the card by default; ``"cpu"`` runs the
    same ops on the CPU. ``decode="native"`` (the C++ loader) is not ported
    yet and raises.
    """

    def __init__(self, base: VideoPoseDataset, resample: str = "bilinear",
                 keep_on_device: bool = False, decode: str = "pil",
                 device: Optional[Union[str, torch.device]] = None):
        if resample not in ("bilinear", "lanczos"):
            raise ValueError(f"unknown resample {resample!r}")
        if decode == "native":
            raise NotImplementedError("decode='native' needs the C++ loader, which comes with "
                                      "its own slice of the port (ROADMAP Queue 1)")
        if decode != "pil":
            raise ValueError(f"unknown decode {decode!r}")
        self.base = base
        self.crop_size = base.crop_size
        self.seq_names = base.seq_names
        self.resample = resample
        self.keep_on_device = keep_on_device
        self.decode = decode
        self.device = resolve_device(device, "DevicePreprocessDataset")
        self._stream = None  # the side stream, made at the first sample

    def __len__(self):
        return len(self.base)

    def _transfer_crop(self, frames_u8: np.ndarray, square: np.ndarray):
        """Slice the frames to the (margin-padded, 128-bucketed) crop square
        on the host before the host-to-device copy, shifting the crop box
        into the slice's frame. Only pixels the resample matrices can touch
        are copied: the square plus a support margin (Lanczos-3 reach = 3 *
        max(box / out, 1) source pixels); content inside the margin is
        identical and everything outside the image stays zero-weighted, so
        the output is unchanged."""
        s, h, w, _ = frames_u8.shape
        x0, y0, x1, y1 = [float(v) for v in square]
        box = max(x1 - x0, y1 - y0, 1.0)
        m = int(np.ceil(3.0 * max(box / self.crop_size, 1.0))) + 2
        cx0 = min(max(int(np.floor(x0)) - m, 0), w)
        cy0 = min(max(int(np.floor(y0)) - m, 0), h)
        cx1 = max(min(int(np.ceil(x1)) + m, w), cx0)
        cy1 = max(min(int(np.ceil(y1)) + m, h), cy0)
        ch, cw = max(cy1 - cy0, 1), max(cx1 - cx0, 1)
        bh = min(-(-ch // 128) * 128, -(-h // 128) * 128)
        bw = min(-(-cw // 128) * 128, -(-w // 128) * 128)
        out = np.zeros((s, bh, bw, 3), np.uint8)
        out[:, :ch, :cw] = frames_u8[:, cy0:cy1, cx0:cx1]
        shifted = np.asarray([x0 - cx0, y0 - cy0, x1 - cx0, y1 - cy0], np.float32)
        return out, shifted

    def _preprocess(self, crop_u8: np.ndarray, shifted: np.ndarray):
        """(images, ready event or None): on the card, on the side stream,
        with an event recorded after the work."""
        if self.device.type != "cuda":
            return preprocess_frames(torch.from_numpy(crop_u8).to(self.device), shifted,
                                     self.crop_size, self.resample), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream = self._stream
        with torch.cuda.stream(stream):
            frames = torch.from_numpy(crop_u8).pin_memory().to(self.device, non_blocking=True)
            images = preprocess_frames(frames, shifted, self.crop_size, self.resample)
            ready = torch.cuda.Event()
            ready.record(stream)
        return images, ready

    def __getitem__(self, index: int) -> SequenceSample:
        raw = self.base.load_sequence_raw(self.seq_names[index])
        crop_u8, shifted = self._transfer_crop(raw["frames_u8"], raw["square"])
        images, ready = self._preprocess(crop_u8, shifted)
        if not self.keep_on_device:
            if ready is not None:
                ready.synchronize()
            images, ready = images.cpu().numpy(), None
        first_mask = _host_nearest_mask(raw["mask0_u8"], raw["square"], self.crop_size)
        frame0_u8 = _host_crop_resize_u8(raw["frames_u8"][0], raw["square"], self.crop_size)
        return SequenceSample(
            images=images,
            t_xyz=raw["t_xyz"],
            q_wxyz=raw["q_wxyz"],
            t_uvz=raw["t_uvz"],
            r_matrix=raw["r_matrix"],
            ratio=raw["ratio"],
            seq_name=raw["seq_name"],
            image_names=raw["image_names"],
            first_mask=first_mask,
            frame0_u8=frame0_u8,
            ready=ready,
        )
