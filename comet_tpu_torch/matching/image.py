"""Host image loading and preprocessing for the matching stack.

Counterpart of ``comet_tpu/matching/image.py``, itself glue-factory's
utils/image.py (ImagePreprocessor, read_image, load_image): the same conf
and the same output dict (image, scales, image_size, transform,
original_image_size, and with ``square_pad`` the padded image and its
padding mask). Resizing is PIL's: LANCZOS where an antialiased bilinear or
bicubic resize is asked for, else the named filter.

Images are channel-first f32 numpy arrays in [0, 1] ([C, H, W], grayscale
[1, H, W]); ``torch.from_numpy(data["image"])`` hands one to the models.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
from PIL import Image

__all__ = ["PreprocessConf", "ImagePreprocessor", "read_image", "numpy_image_to_chw",
           "load_image"]

_FILTERS = {
    "nearest": Image.NEAREST,
    "bilinear": Image.BILINEAR,
    "bicubic": Image.BICUBIC,
    "lanczos": Image.LANCZOS,
    "area": Image.BOX,
}


@dataclasses.dataclass
class PreprocessConf:
    """glue-factory's ``ImagePreprocessor.default_conf``."""

    resize: Optional[object] = None  # an edge length, or an (h, w) pair
    edge_divisible_by: Optional[int] = None
    side: str = "long"
    interpolation: str = "bilinear"
    antialias: bool = True
    square_pad: bool = False
    add_padding_mask: bool = False


class ImagePreprocessor:
    def __init__(self, conf=None, **kwargs):
        if isinstance(conf, PreprocessConf):
            self.conf = dataclasses.replace(conf, **kwargs)
        else:
            merged = dict(conf or {})
            merged.update(kwargs)
            self.conf = PreprocessConf(**merged)

    def get_new_image_size(self, h: int, w: int) -> Tuple[int, int]:
        """The resized (h, w): an edge on the conf's side, or the given pair,
        each then floored to ``edge_divisible_by``."""
        conf = self.conf
        if not isinstance(conf.resize, int):
            size = tuple(int(x) for x in conf.resize)
            if len(size) != 2:
                raise ValueError(f"resize pair must be (h, w), got {conf.resize}")
        else:
            side, side_size = conf.side, conf.resize
            aspect_ratio = w / h
            if side not in ("short", "long", "vert", "horz"):
                raise ValueError(f"side can be one of 'short', 'long', 'vert', 'horz'; got {side!r}")
            if side == "vert":
                size = side_size, int(side_size * aspect_ratio)
            elif side == "horz":
                size = int(side_size / aspect_ratio), side_size
            elif (side == "short") ^ (aspect_ratio < 1.0):
                size = side_size, int(side_size * aspect_ratio)
            else:
                size = int(side_size / aspect_ratio), side_size
        if conf.edge_divisible_by is not None:
            df = conf.edge_divisible_by
            size = tuple(int(x // df * df) for x in size)
        return size

    def _resize(self, img: np.ndarray, size: Tuple[int, int], interpolation: str) -> np.ndarray:
        """[C, H, W] -> [C, h, w], each channel through PIL in f32."""
        if self.conf.antialias and interpolation in ("bilinear", "bicubic"):
            filt = Image.LANCZOS  # PIL's windowed sinc in place of kornia's antialias blur
        else:
            filt = _FILTERS[interpolation]
        h, w = size
        return np.stack([np.asarray(Image.fromarray(c.astype(np.float32)).resize((w, h), filt),
                                    dtype=np.float32) for c in img], axis=0)

    def __call__(self, img: np.ndarray, interpolation: Optional[str] = None) -> dict:
        img = np.asarray(img, dtype=np.float32)
        if img.ndim == 2:
            img = img[None]
        h, w = img.shape[-2:]
        size = (h, w)
        if self.conf.resize is not None:
            size = self.get_new_image_size(h, w)
            img = self._resize(img, size, interpolation or self.conf.interpolation)
        scale = np.array([img.shape[-1] / w, img.shape[-2] / h], dtype=np.float32)
        data = {
            "scales": scale,
            "image_size": np.array(size[::-1]),
            "transform": np.diag([scale[0], scale[1], 1.0]).astype(np.float32),
            "original_image_size": np.array([w, h]),
        }
        if self.conf.square_pad:
            sl = max(img.shape[-2:])
            canvas = np.zeros((img.shape[0], sl, sl), dtype=img.dtype)
            canvas[:, :img.shape[-2], :img.shape[-1]] = img
            data["image"] = canvas
            if self.conf.add_padding_mask:
                mask = np.zeros((1, sl, sl), dtype=bool)
                mask[:, :img.shape[-2], :img.shape[-1]] = True
                data["padding_mask"] = mask
        else:
            data["image"] = img
        return data

    def load_image(self, image_path) -> dict:
        return self(load_image(image_path))


def read_image(path, grayscale: bool = False) -> np.ndarray:
    """[H, W, 3] uint8 RGB, or [H, W] grayscale, from disk."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"No image at path {path}.")
    with Image.open(path) as im:
        return np.asarray(im.convert("L" if grayscale else "RGB"))


def numpy_image_to_chw(image: np.ndarray) -> np.ndarray:
    """HWC or HW -> CHW f32 in [0, 1] (divided by 255)."""
    if image.ndim == 3:
        image = image.transpose(2, 0, 1)
    elif image.ndim == 2:
        image = image[None]
    else:
        raise ValueError(f"Not an image: {image.shape}")
    return (image / 255.0).astype(np.float32)


def load_image(path, grayscale: bool = False) -> np.ndarray:
    return numpy_image_to_chw(read_image(path, grayscale=grayscale))
