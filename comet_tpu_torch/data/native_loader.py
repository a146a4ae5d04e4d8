"""The native (C++) frame-loading path of the video-pose datasets.

Counterpart of ``comet_tpu/data/native_loader.py``. Wraps a
:class:`~comet_tpu_torch.data.datasets.VideoPoseDataset` so that the host's
image work (frame decode, mask decode and bbox scan, crop, LANCZOS resize,
ImageNet normalization) runs in the cometio library (``native/cometio.cpp``)
on a thread pool instead of serially through PIL. The resample is bit-exact
against PIL's 8-bit fixed-point Lanczos and the mask luma and bbox against
``convert("L")`` + ``mask_bbox``, so the samples equal the PIL path's: a
choice of throughput only.

Where the library cannot be built or loaded, :class:`NativeLoaderDataset`
raises ``RuntimeError`` with the build error. (The JAX module's docstring
says that callers fall back to the PIL path; its code raises, and so does
this one: a run that asked for the native loader never gets PIL's.)

Only the pose text files and the first mask's NEAREST resize stay in numpy
and PIL.
"""

from __future__ import annotations

import numpy as np

from .. import native
from .datasets import SequenceSample, VideoPoseDataset, compute_sequence_square, parse_pose_file


def sequence_head(base: VideoPoseDataset, seq_name: str, n_threads: int = 0) -> dict:
    """What both native paths read of a sequence before its frames: the PIL
    path's listing and sampling (the same draws from the dataset's
    generator, so the paths are interchangeable), the masks through the C++
    loader, the crop square and ratio, and the poses with the PIL path's
    parser. Keys: frame_paths, image_names, mask0_u8, square, ratio, t_xyz,
    q_wxyz, t_uvz, r_matrix."""
    frame_paths, mask_paths, gt_paths, names = base._select_files(seq_name)
    bboxes, mask0 = native.load_masks(mask_paths, n_threads)
    square, ratio = compute_sequence_square(bboxes, base.crop_size)
    rows = [parse_pose_file(p, base.intr) for p in gt_paths]
    return dict(frame_paths=frame_paths, image_names=names, mask0_u8=mask0, square=square,
                ratio=float(ratio),
                t_xyz=np.asarray([r[1] for r in rows], np.float32),
                q_wxyz=np.asarray([r[2] for r in rows], np.float32),
                t_uvz=np.asarray([r[3] for r in rows], np.float32),
                r_matrix=np.asarray([r[0] for r in rows], np.float32))


class NativeLoaderDataset:
    """The dataset's samples, with the C++ loader for frames and masks."""

    def __init__(self, base: VideoPoseDataset, n_threads: int = 0):
        if not native.available():
            raise RuntimeError(f"native loader unavailable: {native.build_error()}")
        self.base = base
        self.crop_size = base.crop_size
        self.seq_names = base.seq_names
        self.n_threads = n_threads

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, index: int) -> SequenceSample:
        return self.load_sequence(self.seq_names[index])

    def load_sequence(self, seq_name: str) -> SequenceSample:
        from PIL import Image

        head = sequence_head(self.base, seq_name, self.n_threads)
        square, mask0 = head.pop("square"), head.pop("mask0_u8")
        images = native.load_sequence(head.pop("frame_paths"), square, self.crop_size,
                                      n_threads=self.n_threads)
        mask = Image.fromarray(mask0).crop(tuple(square))
        first_mask = np.asarray(mask.resize((self.crop_size, self.crop_size),
                                            Image.Resampling.NEAREST), np.uint8) > 0
        return SequenceSample(images=images, seq_name=seq_name, first_mask=first_mask, **head)
