"""Synthetic on-disk dataset fixtures in the AMD and DCA directory layouts.

Counterpart of ``comet_tpu/data/fixtures.py``: with the same arguments it
writes the same files. Tiny sequences (a textured square moving against
black, with matching masks and 4x4 w2c pose files) so dataset/eval tests
and benchmarks run without the real data. Layout:
  root/modelX/seq_Y/{frames/frame_*.png, GroundTruth/obj_w2c_*.txt,
  Mask/mask_*.png}
PIL and scipy are imported when a fixture is written.
"""

from __future__ import annotations

import os

import numpy as np


def generate_amd_fixture(
    root: str,
    n_models: int = 1,
    n_seqs: int = 2,
    n_frames: int = 20,
    img_hw=(480, 640),
    seed: int = 0,
) -> str:
    """Create a synthetic AMD-layout dataset; returns the root path."""
    from PIL import Image
    from scipy.spatial.transform import Rotation as R

    rng = np.random.default_rng(seed)
    h, w = img_hw
    fx = fy = 268.44444444
    cx, cy = 320.0, 240.0

    for mi in range(1, n_models + 1):
        for si in range(1, n_seqs + 1):
            base = os.path.join(root, f"model{mi}", f"seq_{si}")
            for sub in ("frames", "GroundTruth", "Mask"):
                os.makedirs(os.path.join(base, sub), exist_ok=True)

            # smooth trajectory: object orbits with small rotation increments
            t0 = np.array([0.1, -0.05, 6.0]) + rng.normal(0, 0.2, 3) * [1, 1, 0]
            rot0 = R.random(random_state=int(rng.integers(1 << 30)))
            drot = R.from_euler("xyz", rng.normal(0, 1.5, 3), degrees=True)

            for fi in range(n_frames):
                t = t0 + np.array([0.01, 0.005, 0.02]) * fi
                rot = rot0 * (drot ** fi)
                pose = np.eye(4)
                pose[:3, :3] = rot.as_matrix()
                pose[:3, 3] = t

                u = (fx * t[0] + cx * t[2]) / t[2]
                v = (fy * t[1] + cy * t[2]) / t[2]

                img = np.zeros((h, w, 3), np.uint8)
                mask = np.zeros((h, w), np.uint8)
                # a textured square centered at the projection
                half = 40
                y0, y1 = int(max(0, v - half)), int(min(h, v + half))
                x0, x1 = int(max(0, u - half)), int(min(w, u + half))
                if y1 > y0 and x1 > x0:
                    tex = rng.integers(
                        60, 255, size=(y1 - y0, x1 - x0, 3)
                    ).astype(np.uint8)
                    img[y0:y1, x0:x1] = tex
                    mask[y0:y1, x0:x1] = 255

                Image.fromarray(img).save(
                    os.path.join(base, "frames", f"frame_{fi:06d}.png")
                )
                Image.fromarray(mask).save(
                    os.path.join(base, "Mask", f"mask_{fi:06d}.png")
                )
                np.savetxt(
                    os.path.join(base, "GroundTruth", f"obj_w2c_{fi:06d}.txt"), pose
                )
    return root


def generate_dca_fixture(
    root: str,
    n_seqs: int = 2,
    n_frames: int = 20,
    img_hw=(512, 512),
    seed: int = 0,
) -> str:
    """Synthetic DCA_SpaceNet-layout fixture: seq_N/000000/{frame,
    GroundTruth,Mask} with the DCA intrinsics
    (kubric_movif_SFM_dataset_DCA.py:236-237)."""
    from PIL import Image
    from scipy.spatial.transform import Rotation as R

    rng = np.random.default_rng(seed)
    h, w = img_hw
    fx, fy = 214.7556, 286.3407
    cx = cy = 256.0

    for si in range(1, n_seqs + 1):
        base = os.path.join(root, f"seq_{si}", "000000")
        for sub in ("frame", "GroundTruth", "Mask"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        for fi in range(n_frames):
            angle = 0.05 * fi
            rot = R.from_rotvec(axis * angle)
            t = np.array(
                [0.3 * np.sin(0.2 * fi), 0.2 * np.cos(0.2 * fi), 6.0 + 0.1 * fi]
            )
            pose = np.eye(4)
            pose[:3, :3] = rot.as_matrix()
            pose[:3, 3] = t

            u = (fx * t[0] + cx * t[2]) / t[2]
            v = (fy * t[1] + cy * t[2]) / t[2]

            img = np.zeros((h, w, 3), np.uint8)
            mask = np.zeros((h, w), np.uint8)
            half = 60
            y0, y1 = int(max(0, v - half)), int(min(h, v + half))
            x0, x1 = int(max(0, u - half)), int(min(w, u + half))
            if y1 > y0 and x1 > x0:
                tex = rng.integers(60, 255, size=(y1 - y0, x1 - x0, 3)).astype(np.uint8)
                img[y0:y1, x0:x1] = tex
                mask[y0:y1, x0:x1] = 255

            Image.fromarray(img).save(os.path.join(base, "frame", f"frame_{fi:06d}.png"))
            Image.fromarray(mask).save(os.path.join(base, "Mask", f"mask_{fi:06d}.png"))
            np.savetxt(os.path.join(base, "GroundTruth", f"obj_w2c_{fi:06d}.txt"), pose)
    return root
