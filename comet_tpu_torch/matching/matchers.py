"""Feature matchers: mutual nearest neighbour (and a small rotary helper).

Counterpart of ``comet_tpu/matching/matchers.py`` (gluefactory's
nearest_neighbor_matcher). The registered ``matcher_nn`` passes no validity
masks to :func:`mutual_nearest_neighbor`, as the JAX package's does, so
zero-score padding keypoints take part in the matching.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .registry import register_model


def mutual_nearest_neighbor(
    desc0: torch.Tensor,  # [N0, D] L2-normalized
    desc1: torch.Tensor,  # [N1, D]
    threshold: float = 0.0,
    valid0: Optional[torch.Tensor] = None,
    valid1: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Mutual-NN matching with a cosine-similarity threshold: matches0 [N0]
    (index into set 1 or -1) and scores0 [N0]. Ties go to the lowest index."""
    sim = desc0 @ desc1.T  # [N0, N1]
    if valid0 is not None:
        sim = sim.masked_fill(~valid0[:, None], -math.inf)
    if valid1 is not None:
        sim = sim.masked_fill(~valid1[None, :], -math.inf)
    nn01 = sim.argmax(dim=1)
    nn10 = sim.argmax(dim=0)
    scores = sim.gather(1, nn01[:, None])[:, 0]
    mutual = torch.arange(desc0.shape[0], device=sim.device) == nn10[nn01]
    ok = mutual & (scores > threshold) & torch.isfinite(scores)
    return {
        "matches0": torch.where(ok, nn01, -1),
        "scores0": torch.where(ok, scores, 0.0),
    }


def _nn_matcher(threshold=0.0):
    # no valid0 / valid1: the JAX package's registered matcher drops them
    return lambda f0, f1: mutual_nearest_neighbor(f0["descriptors"], f1["descriptors"], threshold)


register_model("matcher_nn", {"threshold": 0.0})(_nn_matcher)


def rotary_encode(x: torch.Tensor, kpts: torch.Tensor, num_heads: int) -> torch.Tensor:
    """2-D rotary encoding of features x [N, D] by keypoints [N, 2] in
    [-1, 1]: feature pairs (i, i + D/2) rotate by angles proportional to the
    coordinates over geometric bands."""
    half = x.shape[1] // 2
    freqs = 2.0 ** torch.arange(half // 2, dtype=torch.float32, device=x.device)
    ang = torch.cat([kpts[:, :1] * freqs[None] * math.pi, kpts[:, 1:2] * freqs[None] * math.pi],
                    dim=-1)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[:, :half], x[:, half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
