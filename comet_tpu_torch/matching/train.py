"""Matcher training on homography-supervised pairs.

Counterpart of ``comet_tpu/matching/train.py`` (the glue-factory trainer's
core): a train step over the matcher's assignment NLL against ground-truth
labels from ``gt_generation``, and the batch builder that makes those
labels from synthetic textures, random homographies, photometric
augmentation and the extractor's features.

A step is ``step(module, optimizer, batch) -> loss``: the matcher runs on
each sample of the batch in turn (the JAX package vmaps it), the loss is the
mean of the samples' losses, and one ``optimizer.step()`` follows (Adam, as
the JAX package's ``optax.adam``). The step reads nothing back to the host:
the loss it returns stays on the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .gt_generation import IGNORE, UNMATCHED

BATCH_KEYS = ("kpts0", "desc0", "kpts1", "desc1", "gt0", "gt1")


def matcher_nll_loss(
    scores: torch.Tensor,  # [N0, N1] assignment probabilities
    matchability0: torch.Tensor,  # [N0]
    matchability1: torch.Tensor,  # [N1]
    gt0: torch.Tensor,  # [N0] ground-truth index / UNMATCHED / IGNORE
    gt1: torch.Tensor,  # [N1]
) -> torch.Tensor:
    """NLL of the ground-truth assignment: matched pairs maximize their
    assignment probability, unmatched points minimize their matchability,
    IGNORE points add nothing."""
    eps = 1e-8
    pos0 = gt0 >= 0
    p_match = scores.gather(1, gt0.clamp(0, scores.shape[1] - 1)[:, None])[:, 0]
    nll_pos = -torch.log(p_match + eps) * pos0
    un0, un1 = gt0 == UNMATCHED, gt1 == UNMATCHED
    nll_un0 = -torch.log(1.0 - matchability0 + eps) * un0
    nll_un1 = -torch.log(1.0 - matchability1 + eps) * un1
    n_un = (un0.sum() + un1.sum()).clamp_min(1)
    return nll_pos.sum() / pos0.sum().clamp_min(1) + (nll_un0.sum() + nll_un1.sum()) / n_un


def _lightglue_sample_loss(module, kpts0, desc0, kpts1, desc1, gt0, gt1):
    out = module(kpts0, desc0, kpts1, desc1)
    return matcher_nll_loss(out["assignment"], out["matchability0"], out["matchability1"],
                            gt0, gt1)


def _superglue_sample_loss(module, kpts0, desc0, kpts1, desc1, gt0, gt1):
    from .superglue import superglue_nll_loss

    return superglue_nll_loss(module(kpts0, desc0, kpts1, desc1)["log_assignment"], gt0, gt1)


def _build_step(sample_loss) -> Callable:
    def step(module: torch.nn.Module, optimizer: torch.optim.Optimizer,
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        n = batch["kpts0"].shape[0]
        loss = torch.stack([sample_loss(module, *(batch[k][b] for k in BATCH_KEYS))
                            for b in range(n)]).mean()
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def build_matcher_train_step() -> Callable:
    """A train step ``(module, optimizer, batch) -> loss`` of a matcher with
    ``assignment`` and ``matchability0/1`` outputs (LightGlue) under
    :func:`matcher_nll_loss`. ``batch``: kpts0, desc0, kpts1, desc1, gt0, gt1
    with a leading batch axis."""
    return _build_step(_lightglue_sample_loss)


def build_superglue_train_step() -> Callable:
    """:func:`build_matcher_train_step` for optimal-transport matchers
    (SuperGlue): the loss is ``superglue.superglue_nll_loss`` of the log
    assignment, with no validity masks, as the JAX package's step."""
    return _build_step(_superglue_sample_loss)


def make_homography_training_batch(
    extractor,
    rng: np.random.Generator,
    batch_size: int = 4,
    image_hw: Tuple[int, int] = (96, 96),
    difficulty: float = 0.7,
    max_angle: float = 45.0,
    photometric=None,
    th_positive: float = 3.0,
    th_negative: float = 5.0,
    device=None,
) -> Dict[str, torch.Tensor]:
    """One supervised batch on ``device`` (the card by default): a synthetic
    texture, its warp by a difficulty-scaled homography, both views
    augmented photometrically (``photometric``: a PhotometricConfig, None
    for the "lg" preset), the extractor's features, and ground-truth labels
    from the true homography. Keypoints are normalized to [-1, 1];
    extractor padding slots (``valid`` False), and matches pointing at them,
    are labelled IGNORE.

    The textures and homographies come from ``rng`` as the JAX package draws
    them; each pair's augmentation draws from a ``torch.Generator`` seeded
    with ``rng.integers(1 << 30)``, where JAX seeds its key."""
    from .augmentations import LG_PRESET, photometric_augment, sample_homography_difficulty
    from .benchmarks import synthetic_texture, warp_image
    from .gt_generation import gt_matches_from_homography

    dev = resolve_device(device, "make_homography_training_batch")
    conf = LG_PRESET if photometric is None else photometric
    h, w = image_hw
    sx, sy = max(w - 1.0, 1.0), max(h - 1.0, 1.0)
    rows = {k: [] for k in BATCH_KEYS}
    for _ in range(batch_size):
        img0 = torch.as_tensor(synthetic_texture(rng, h, w), device=dev)
        h_mat = torch.as_tensor(sample_homography_difficulty(rng, h, w, difficulty, max_angle),
                                dtype=torch.float32, device=dev)
        img1 = warp_image(img0, h_mat)
        generator = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
        f0 = extractor(photometric_augment(generator, img0, conf))
        f1 = extractor(photometric_augment(generator, img1, conf))
        gt = gt_matches_from_homography(f0["keypoints"], f1["keypoints"], h_mat,
                                        pos_threshold=th_positive, neg_threshold=th_negative)
        gt0, gt1 = gt["matches0"], gt["matches1"]
        v0, v1 = f0.get("valid"), f1.get("valid")
        if v0 is not None:
            gt0 = torch.where(v0, gt0, IGNORE)
            # matches pointing at padded slots are not real either
            gt1 = torch.where((gt1 >= 0) & ~v0[gt1.clamp(0, v0.shape[0] - 1)], IGNORE, gt1)
        if v1 is not None:
            gt1 = torch.where(v1, gt1, IGNORE)
            gt0 = torch.where((gt0 >= 0) & ~v1[gt0.clamp(0, v1.shape[0] - 1)], IGNORE, gt0)
        for side, f in (("0", f0), ("1", f1)):
            k = f["keypoints"]
            rows["kpts" + side].append(torch.stack([k[:, 0] / sx, k[:, 1] / sy], -1) * 2.0 - 1.0)
            rows["desc" + side].append(f["descriptors"])
        rows["gt0"].append(gt0)
        rows["gt1"].append(gt1)
    return {k: torch.stack(v) for k, v in rows.items()}


def make_adam(module: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``'s step as ``torch.optim.Adam`` (b1 0.9, b2 0.999,
    eps 1e-8 outside the root)."""
    return torch.optim.Adam(module.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
