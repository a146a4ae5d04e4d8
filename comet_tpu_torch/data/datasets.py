"""Video-sequence datasets (AMD / DCA_SpaceNet directory layouts).

Counterpart of ``comet_tpu/data/datasets.py``, host-side numpy and PIL as
there: sequence-level mask bbox + 15% margin -> square crop -> LANCZOS
resize -> ImageNet normalization; the (u, v) image-plane projection of T
computed with the per-dataset intrinsics; max-gap temporal sampling for
training, deterministic even sampling for eval. PIL is imported by the
functions that decode, so the module imports without it.

Outputs are numpy arrays in channel-LAST layout ([S, H, W, 3]); the
device-preprocess path (``device_pipeline.py``) puts them on the card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np

from ..geometry.codecs import INTRINSICS_TABLE

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def matrix_to_quat_wxyz(r: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> wxyz quaternion (scipy scalar_first parity)."""
    from scipy.spatial.transform import Rotation as R

    return R.from_matrix(r).as_quat(scalar_first=True)


def sample_with_max_gap(
    total_frames: int, seq_len: int, rng: Optional[np.random.Generator] = None,
    max_gap: int = 8,
) -> List[int]:
    """Arithmetic subsampling with random stride <= max_gap
    (kubric_movif_SFM_dataset_YT.py:64-99)."""
    if total_frames < seq_len:
        return np.linspace(0, total_frames - 1, seq_len).astype(int).tolist()
    rng = rng or np.random.default_rng()
    max_step = max(1, min(max_gap, (total_frames - 1) // (seq_len - 1)))
    step = int(rng.integers(1, max_step + 1))
    max_start = total_frames - (seq_len - 1) * step
    start = int(rng.integers(0, max_start))
    return [start + i * step for i in range(seq_len)]


def sample_evenly(total_frames: int, seq_len: int) -> List[int]:
    """Deterministic fallback used when augmentation is off."""
    if total_frames < seq_len:
        return np.linspace(0, total_frames - 1, seq_len).astype(int).tolist()
    max_step = max(1, min(8, (total_frames - 1) // (seq_len - 1)))
    return [i * max_step for i in range(seq_len)]


def make_bbox_square(bbox: np.ndarray, target_size: float) -> np.ndarray:
    """Expand bbox to a square of target_size around its center.

    Matches the reference's semantics exactly (symmetric per-side padding in
    float32, then truncation to int — kubric_movif_SFM_dataset_YT.py:36-59):
    the integer truncation matters because the crop box feeds PIL.Image.crop,
    and a float box would be *rounded* there instead, shifting the crop by up
    to one source pixel versus the reference.
    """
    out = np.array(bbox, dtype=np.float32)
    pad_h = (target_size - (bbox[3] - bbox[1])) / 2.0
    out[1] -= pad_h
    out[3] += pad_h
    pad_w = (target_size - (bbox[2] - bbox[0])) / 2.0
    out[0] -= pad_w
    out[2] += pad_w
    return out.astype(int)


def mask_bbox(mask: np.ndarray) -> List[float]:
    """Tight bbox (xmin, ymin, xmax, ymax) of nonzero mask pixels."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        h, w = mask.shape[:2]
        return [0.0, 0.0, float(w), float(h)]
    return [float(xs.min()), float(ys.min()), float(xs.max() + 1), float(ys.max() + 1)]


def compute_sequence_square(bboxes, crop_size: int):
    """Sequence-level union bbox + 15% margin -> integer square crop box
    (kubric_movif_SFM_dataset_YT.py:228-246). Returns (square, ratio).
    """
    bb = np.asarray(bboxes, np.float64)
    union = np.array(
        [bb[:, 0].min(), bb[:, 1].min(), bb[:, 2].max(), bb[:, 3].max()]
    )
    bbox_size = max(union[2] - union[0], union[3] - union[1])
    size_with_margin = bbox_size * 1.3
    margin = bbox_size * 0.15
    union = union + np.array([-margin, -margin, margin, margin])
    square = make_bbox_square(union, size_with_margin)
    ratio = crop_size / size_with_margin
    return square, ratio


def parse_pose_file(path: str, intr) -> tuple:
    """4x4 w2c pose txt -> (R 3x3, T 3, quat wxyz, [u, v, Tz]) with the
    intrinsics projection of T (kubric_movif_SFM_dataset_YT.py:198-217)."""
    pose = np.loadtxt(path)
    if pose.shape != (4, 4):
        raise ValueError(f"{path} is not a 4x4 pose matrix")
    r_mat = pose[:3, :3]
    t_vec = pose[:3, 3]
    if abs(t_vec[2]) < 1e-6:
        raise ZeroDivisionError(f"Tz ~ 0 in {path}")
    u = (intr.fx * t_vec[0] + intr.cx * t_vec[2]) / t_vec[2]
    v = (intr.fy * t_vec[1] + intr.cy * t_vec[2]) / t_vec[2]
    return r_mat, t_vec, matrix_to_quat_wxyz(r_mat), [u, v, t_vec[2]]


@dataclass
class SequenceSample:
    """One loaded sequence — mirrors the reference dataset's dict output
    (kubric_movif_SFM_dataset_YT.py:265-266)."""

    images: Any  # [S, H, W, 3] float32, ImageNet-normalized: numpy, or a tensor on the card
    t_xyz: np.ndarray  # [S, 3]
    q_wxyz: np.ndarray  # [S, 4]
    t_uvz: np.ndarray  # [S, 3]
    r_matrix: np.ndarray  # [S, 3, 3]
    ratio: float
    seq_name: str
    image_names: List[str]
    first_mask: np.ndarray  # [H, W] bool
    # optional host-resident uint8 preview of the preprocessed frame 0 so
    # keypoint seeding never pulls a device-resident image back (set by
    # the device-preprocess fast path; None on the PIL parity path)
    frame0_u8: Optional[np.ndarray] = None
    # for images on the card made on another stream: the CUDA event after
    # which they may be read (device_pipeline.wait_ready)
    ready: Any = None


class VideoPoseDataset:
    """Base dataset over sequence directories with pose ground truth."""

    def __init__(
        self,
        data_root: str,
        crop_size: int = 512,
        seq_len: int = 16,
        use_augs: bool = False,
        intrinsics_key: str = "AMD",
        seed: int = 0,
    ):
        if not os.path.isdir(data_root):
            raise ValueError(f"Data root path does not exist: {data_root}")
        self.data_root = data_root
        self.crop_size = crop_size
        self.seq_len = seq_len
        self.use_augs = use_augs
        self.intr = INTRINSICS_TABLE[intrinsics_key]
        self.rng = np.random.default_rng(seed)
        self.seq_names = self._list_sequences()

    # --- layout hooks (overridden by the DCA variant) ---------------------
    def _list_sequences(self) -> List[str]:
        """AMD layout: modelX/seq_Y (kubric_..._YT.py:130-158)."""
        seqs = []
        models = [
            d for d in os.listdir(self.data_root)
            if d.startswith("model") and os.path.isdir(os.path.join(self.data_root, d))
        ]
        models.sort(key=lambda x: int(x[5:]))
        for model in models:
            inner = [
                s for s in os.listdir(os.path.join(self.data_root, model))
                if s.startswith("seq_")
            ]
            inner.sort(key=lambda x: int(x[4:]))
            seqs.extend(os.path.join(model, s) for s in inner)
        return seqs

    def _frame_dirs(self, seq_name: str):
        base = os.path.join(self.data_root, seq_name)
        return (
            os.path.join(base, "frames"),
            os.path.join(base, "GroundTruth"),
            os.path.join(base, "Mask"),
        )

    def _frame_prefixes(self):
        return "frame_", "obj_w2c_", "mask_"

    # ----------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.seq_names)

    def __getitem__(self, index: int) -> SequenceSample:
        return self.load_sequence(self.seq_names[index])

    def _select_files(self, seq_name: str):
        """Directory listing + temporal sampling — the shared head of the
        host (PIL) and device preprocessing paths; consumes the RNG
        identically in both so runs are interchangeable. Returns (frame,
        mask, gt) path lists + names."""
        frames_dir, gts_dir, masks_dir = self._frame_dirs(seq_name)
        fpre, gpre, mpre = self._frame_prefixes()
        image_names = sorted(f for f in os.listdir(frames_dir) if f.startswith(fpre))
        gt_names = sorted(f for f in os.listdir(gts_dir) if f.startswith(gpre))
        mask_names = sorted(f for f in os.listdir(masks_dir) if f.startswith(mpre))

        total = len(image_names)
        if self.use_augs:
            sel = sample_with_max_gap(total, self.seq_len, self.rng)
        else:
            sel = sample_evenly(total, self.seq_len)
        return (
            [os.path.join(frames_dir, image_names[i]) for i in sel],
            [os.path.join(masks_dir, mask_names[i]) for i in sel],
            [os.path.join(gts_dir, gt_names[i]) for i in sel],
            [image_names[i] for i in sel],
        )

    def _load_common(self, seq_name: str):
        """Decode frames/masks/poses (PIL) and compute the sequence square
        crop."""
        from PIL import Image

        frame_paths, mask_paths, gt_paths, names = self._select_files(seq_name)

        imgs, masks, bboxes = [], [], []
        t_list, q_list, uvz_list, r_list = [], [], [], []
        for fp, mp, gp in zip(frame_paths, mask_paths, gt_paths):
            img = Image.open(fp).convert("RGB")
            mask = np.array(Image.open(mp).convert("L"), np.uint8)
            r_mat, t_vec, quat, uvz = parse_pose_file(gp, self.intr)

            imgs.append(img)
            masks.append(mask)
            bboxes.append(mask_bbox(mask))
            t_list.append(t_vec)
            q_list.append(quat)
            uvz_list.append(uvz)
            r_list.append(r_mat)

        square, ratio = compute_sequence_square(bboxes, self.crop_size)
        return imgs, masks, t_list, q_list, uvz_list, r_list, names, square, ratio

    def load_sequence(self, seq_name: str) -> SequenceSample:
        (
            imgs, masks, t_list, q_list, uvz_list, r_list, names, square, ratio
        ) = self._load_common(seq_name)
        from PIL import Image

        rgb = []
        for img in imgs:
            cropped = img.crop(tuple(square))
            rgb.append(
                np.asarray(
                    cropped.resize(
                        (self.crop_size, self.crop_size), Image.Resampling.LANCZOS
                    ),
                    np.float32,
                )
            )
        video = np.stack(rgb) / 255.0
        video = (video - _IMAGENET_MEAN) / _IMAGENET_STD

        mask_pil = Image.fromarray(masks[0]).crop(tuple(square))
        first_mask = (
            np.asarray(
                mask_pil.resize(
                    (self.crop_size, self.crop_size), Image.Resampling.NEAREST
                ),
                np.uint8,
            )
            > 0
        )

        return SequenceSample(
            images=video.astype(np.float32),
            t_xyz=np.asarray(t_list, np.float32),
            q_wxyz=np.asarray(q_list, np.float32),
            t_uvz=np.asarray(uvz_list, np.float32),
            r_matrix=np.asarray(r_list, np.float32),
            ratio=float(ratio),
            seq_name=seq_name,
            image_names=names,
            first_mask=first_mask,
        )

    def load_sequence_raw(self, seq_name: str):
        """Decode-only variant for the device preprocessing path
        (data/device_pipeline.py): returns the RAW uint8 frames + frame-0
        mask + crop square; crop/resize/normalize then run on the card
        instead of in PIL."""
        (
            imgs, masks, t_list, q_list, uvz_list, r_list, names, square, ratio
        ) = self._load_common(seq_name)
        frames_u8 = np.stack([np.asarray(im, np.uint8) for im in imgs])
        return {
            "frames_u8": frames_u8,  # [S, H, W, 3]
            "mask0_u8": masks[0],  # [H, W]
            "square": np.asarray(square, np.float32),  # (x0, y0, x1, y1)
            "ratio": float(ratio),
            "t_xyz": np.asarray(t_list, np.float32),
            "q_wxyz": np.asarray(q_list, np.float32),
            "t_uvz": np.asarray(uvz_list, np.float32),
            "r_matrix": np.asarray(r_list, np.float32),
            "seq_name": seq_name,
            "image_names": names,
        }


class AMDDataset(VideoPoseDataset):
    """AMD layout (kubric_movif_SFM_dataset_YT.py:101)."""

    def __init__(self, data_root, crop_size=512, seq_len=16, use_augs=False, seed=0):
        super().__init__(
            data_root, crop_size, seq_len, use_augs, intrinsics_key="AMD", seed=seed
        )


class DCADataset(VideoPoseDataset):
    """DCA_SpaceNet layout: seq_X/000000/{frame,GroundTruth,Mask}
    (kubric_movif_SFM_dataset_DCA.py:102-237)."""

    # The reference assigns `sequences = [...]` four times in a row with
    # different bounds/exclusions (kubric_movif_SFM_dataset_DCA.py:133-170);
    # only the LAST assignment is effective: seq number < 1135, minus these.
    DEFAULT_EXCLUDE = ("seq_1119", "seq_1129", "seq_1138", "seq_1139")
    DEFAULT_MAX_SEQ_NUM = 1135

    def __init__(
        self, data_root, crop_size=512, seq_len=16, use_augs=False, seed=0,
        exclude: Optional[Sequence[str]] = None,
        max_seq_num: Optional[int] = None,
    ):
        self._exclude = set(
            self.DEFAULT_EXCLUDE if exclude is None else exclude
        )
        self._max_seq_num = (
            self.DEFAULT_MAX_SEQ_NUM if max_seq_num is None else max_seq_num
        )
        super().__init__(
            data_root, crop_size, seq_len, use_augs,
            intrinsics_key="AMD_test", seed=seed,
        )

    def _keep(self, name: str) -> bool:
        if name in self._exclude:
            return False
        if name.startswith("seq_"):
            try:
                return int(name.split("_")[1]) < self._max_seq_num
            except ValueError:
                return True
        return True

    def _list_sequences(self) -> List[str]:
        return sorted(
            d for d in os.listdir(self.data_root)
            if os.path.isdir(os.path.join(self.data_root, d)) and self._keep(d)
        )

    def _frame_dirs(self, seq_name: str):
        base = os.path.join(self.data_root, seq_name, "000000")
        return (
            os.path.join(base, "frame"),
            os.path.join(base, "GroundTruth"),
            os.path.join(base, "Mask"),
        )
