"""Track-supervision losses.

Counterpart of ``comet_tpu/models/losses.py`` (itself the reference's
comet/models/losses.py): ``sequence_loss`` (per-iteration gamma-decayed
masked L1 or Huber on tracks), ``balanced_ce_loss`` (pos/neg-balanced BCE
for visibility or confidence) and ``reduce_masked_mean``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

EPS = 1e-6


def reduce_masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean of x over the elements where mask > 0 (mask broadcast to x)."""
    mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
    prod = x * mask
    if dim is None:
        return prod.sum() / (mask.sum() + EPS)
    return prod.sum(dim=dim) / (mask.sum(dim=dim) + EPS)


def huber_loss(x: torch.Tensor, y: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber, summed over the coordinate axis."""
    diff = x - y
    abs_diff = diff.abs()
    quad = 0.5 * diff ** 2
    lin = delta * (abs_diff - 0.5 * delta)
    return torch.where(abs_diff <= delta, quad, lin).sum(dim=-1)


def sequence_loss(
    flow_preds: Sequence[torch.Tensor],  # per-iteration [B, S, N, 2]
    flow_gt: torch.Tensor,  # [B, S, N, 2]
    vis: torch.Tensor,  # [B, S, N] visibility
    valids: torch.Tensor,  # [B, S, N] validity mask
    gamma: float = 0.8,
    vis_aware: bool = False,
    use_huber: bool = False,
) -> torch.Tensor:
    """Gamma-decayed per-iteration masked track loss: iteration i of n has
    weight gamma^(n-1-i); ground truth that is invalid or not finite is left
    out of the mean."""
    n_predictions = len(flow_preds)
    finite = torch.isfinite(flow_gt).all(dim=-1)
    valids = valids.float() * finite.float()
    gt = torch.where(finite[..., None], flow_gt, torch.zeros_like(flow_gt))

    total = 0.0
    for i, pred in enumerate(flow_preds):
        weight = gamma ** (n_predictions - i - 1)
        if use_huber:
            i_loss = huber_loss(pred, gt, delta=6.0)
        else:
            i_loss = (pred - gt).abs().mean(dim=-1)
        if vis_aware:
            i_loss = i_loss * (vis.float() + 0.1)  # visible points dominate
        total = total + weight * reduce_masked_mean(i_loss, valids)
    return total / n_predictions


def balanced_ce_loss(pred_logits: torch.Tensor, gt: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Pos/neg-balanced binary cross-entropy of raw scores (before the
    sigmoid) against gt in {0, 1}, over the valid elements."""
    gt = gt.float()
    valid = valid.float()
    pos = (gt > 0.95).float() * valid
    neg = (gt < 0.05).float() * valid
    loss_pos = -(F.logsigmoid(pred_logits) * pos).sum() / (pos.sum() + EPS)
    loss_neg = -(F.logsigmoid(-pred_logits) * neg).sum() / (neg.sum() + EPS)
    return loss_pos + loss_neg
