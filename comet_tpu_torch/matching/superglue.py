"""SuperGlue: an attentional GNN and Sinkhorn optimal transport; the
inference path.

Counterpart of ``comet_tpu/matching/superglue.py`` (the reference vendors
gluefactory_nonfree/superglue.py): a keypoint (x, y, score) MLP added to the
projected descriptors, ``depth`` rounds of self message passing on both sets
and cross message passing in both directions (an MHA message merged by an
MLP on [x, message]), final projections, and a partial assignment from
log-domain Sinkhorn iterations over the score matrix with a learned dustbin.
Validity masks stand in for padding; every logit is f32.
:func:`superglue_nll_loss` is the training loss; it keeps the JAX package's
labels as they are: every label below 0, IGNORE (-2) too, goes to the
dustbin and is counted (ROADMAP Queue 3).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..models.blocks import Linear, gelu
from .registry import register_model


def log_sinkhorn(
    scores: torch.Tensor,  # [N0, N1] f32 similarities
    bin_score: torch.Tensor,  # scalar dustbin affinity
    iters: int,
    valid0: Optional[torch.Tensor] = None,
    valid1: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Log-domain Sinkhorn over the dustbin-augmented scores -> the log
    assignment [N0+1, N1+1]. Each valid keypoint carries one unit of mass,
    each dustbin the other side's count, all over (m + n); invalid rows and
    columns carry none and absorb none."""
    n0, n1 = scores.shape
    dev = scores.device
    v0 = torch.ones(n0, dtype=torch.bool, device=dev) if valid0 is None else valid0
    v1 = torch.ones(n1, dtype=torch.bool, device=dev) if valid1 is None else valid1
    m = v0.sum().float()
    n = v1.sum().float()
    neg = torch.full((), -1e9, device=dev)  # built on the device: no host sync
    b = bin_score.float()
    s = torch.where(v0[:, None] & v1[None, :], scores.float(), neg)
    bins0 = torch.where(v0, b, neg)
    bins1 = torch.where(v1, b, neg)
    z = torch.cat([torch.cat([s, bins0[:, None]], dim=1),
                   torch.cat([bins1, b.reshape(1)])[None]], dim=0)
    norm = -torch.log(m + n)
    log_mu = torch.cat([torch.where(v0, norm, neg), (torch.log(n) + norm)[None]])
    log_nu = torch.cat([torch.where(v1, norm, neg), (torch.log(m) + norm)[None]])
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(z + v[None, :], dim=1)
        v = log_nu - torch.logsumexp(z + u[:, None], dim=0)
    return z + u[:, None] + v[None, :] - norm


class KeypointEncoder(nn.Module):
    """MLP on (x, y, score) -> the feature width, added to the descriptor."""

    def __init__(self, dim: int, layers=(32, 64, 128)):
        super().__init__()
        widths = (3,) + tuple(layers)
        for i in range(len(layers)):
            setattr(self, f"fc{i}", Linear(widths[i], widths[i + 1]))
        self.n_layers = len(layers)
        self.out = Linear(widths[-1], dim)

    def forward(self, kpts, scores):
        x = torch.cat([kpts, scores[:, None]], dim=-1)
        for i in range(self.n_layers):
            x = torch.relu(getattr(self, f"fc{i}")(x))
        return self.out(x)


class MessagePass(nn.Module):
    """One attentional message-passing step: an MHA message from
    ``context`` merged into x by an MLP on [x, message], residual."""

    def __init__(self, dim: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.q = Linear(dim, dim)
        self.k = Linear(dim, dim)
        self.v = Linear(dim, dim)
        self.merge1 = Linear(2 * dim, 2 * dim)
        self.merge2 = Linear(2 * dim, dim)

    def forward(self, x, context, mask=None):
        d = x.shape[-1]
        h = self.num_heads
        hd = d // h
        q = self.q(x).reshape(-1, h, hd)
        k = self.k(context).reshape(-1, h, hd)
        v = self.v(context).reshape(-1, h, hd)
        logits = torch.einsum("qhd,khd->hqk", q / math.sqrt(hd), k)
        if mask is not None:
            logits = logits.masked_fill(~mask[None, None, :], -math.inf)
        msg = torch.einsum("hqk,khd->qhd", torch.softmax(logits, dim=-1), v).reshape(-1, d)
        return x + self.merge2(gelu(self.merge1(torch.cat([x, msg], dim=-1))))


class SuperGlueMatcher(nn.Module):
    """SuperGlue over two keypoint sets: hard matches and the full log
    assignment (with dustbins). ``in_dim`` is the descriptors' width (the
    JAX module infers it at init; default ``dim``)."""

    # flax modules named like list entries that are not
    FLAX_VERBATIM = ("input_proj_1", "final_proj_1")

    def __init__(self, depth: int = 9, dim: int = 256, num_heads: int = 4,
                 sinkhorn_iters: int = 50, filter_threshold: float = 0.2,
                 in_dim: Optional[int] = None):
        super().__init__()
        self.conf = dict(depth=depth, dim=dim, num_heads=num_heads,
                         sinkhorn_iters=sinkhorn_iters, filter_threshold=filter_threshold)
        self.dim, self.in_dim = dim, in_dim or dim
        self.sinkhorn_iters, self.filter_threshold = sinkhorn_iters, filter_threshold
        self.kenc = KeypointEncoder(dim)
        self.input_proj = Linear(self.in_dim, dim)
        self.input_proj_1 = Linear(self.in_dim, dim)
        for name in ("self0", "self1", "cross0", "cross1"):
            setattr(self, name, nn.ModuleList(MessagePass(dim, num_heads) for _ in range(depth)))
        self.final_proj = Linear(dim, dim)
        self.final_proj_1 = Linear(dim, dim)
        self.bin_score = nn.Parameter(torch.tensor(1.0))

    def init_own_params(self, generator):
        self.bin_score.fill_(1.0)

    def forward(self, kpts0, desc0, kpts1, desc1, scores0=None, scores1=None, valid0=None,
                valid1=None) -> Dict[str, torch.Tensor]:
        n0, n1 = kpts0.shape[0], kpts1.shape[0]
        dev = kpts0.device
        s0 = torch.ones(n0, dtype=kpts0.dtype, device=dev) if scores0 is None else scores0
        s1 = torch.ones(n1, dtype=kpts1.dtype, device=dev) if scores1 is None else scores1
        v0 = torch.ones(n0, dtype=torch.bool, device=dev) if valid0 is None else valid0
        v1 = torch.ones(n1, dtype=torch.bool, device=dev) if valid1 is None else valid1
        x0 = self.input_proj(desc0) + self.kenc(kpts0, s0)
        x1 = self.input_proj_1(desc1) + self.kenc(kpts1, s1)
        for i in range(len(self.self0)):
            # self on both sets, then cross in both directions
            x0 = self.self0[i](x0, x0, mask=v0)
            x1 = self.self1[i](x1, x1, mask=v1)
            x0n = self.cross0[i](x0, x1, mask=v1)
            x1 = self.cross1[i](x1, x0, mask=v0)
            x0 = x0n
        f0, f1 = self.final_proj(x0), self.final_proj_1(x1)
        sim = torch.einsum("nd,md->nm", f0, f1) / math.sqrt(self.dim)
        log_p = log_sinkhorn(sim, self.bin_score, self.sinkhorn_iters, v0, v1)
        # log_sinkhorn adds log(m + n) back: a sure match has p ~ 1
        p = torch.exp(log_p[:n0, :n1])
        nn01 = p.argmax(dim=1)
        nn10 = p.argmax(dim=0)
        best = p.gather(1, nn01[:, None])[:, 0]
        mutual = torch.arange(n0, device=dev) == nn10[nn01]
        ok = mutual & (best > self.filter_threshold) & v0
        return {
            "matches0": torch.where(ok, nn01, -1),
            "scores0": torch.where(ok, best, 0.0),
            "assignment": p,
            "log_assignment": log_p,
        }


def superglue_nll_loss(
    log_assignment: torch.Tensor,  # [N0+1, N1+1]
    gt0: torch.Tensor,  # [N0] ground-truth index into set 1, or < 0
    gt1: torch.Tensor,  # [N1]
    valid0: Optional[torch.Tensor] = None,
    valid1: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """NLL of the ground-truth partial assignment: a matched point's cell,
    an unmatched one's dustbin, each matched pair counted once (its row);
    over the valid rows and the valid unmatched columns. As in the JAX
    package, any negative label is "unmatched": IGNORE is trained as the
    dustbin unless ``valid0`` / ``valid1`` leave it out."""
    n0, n1 = gt0.shape[0], gt1.shape[0]
    dev = log_assignment.device
    v0 = torch.ones(n0, dtype=torch.bool, device=dev) if valid0 is None else valid0
    v1 = torch.ones(n1, dtype=torch.bool, device=dev) if valid1 is None else valid1
    col = torch.where(gt0 >= 0, gt0, n1)  # unmatched: the dustbin column
    ll0 = log_assignment[:n0].gather(1, col[:, None])[:, 0]
    row = torch.where(gt1 >= 0, gt1, n0)  # unmatched: the dustbin row
    ll1 = log_assignment[:, :n1].gather(0, row[None, :])[0]
    ll1 = torch.where(gt1 >= 0, 0.0, ll1)
    num = v0.sum() + (v1 & (gt1 < 0)).sum()
    total = torch.where(v0, ll0, 0.0).sum() + torch.where(v1, ll1, 0.0).sum()
    return -total / num.float().clamp_min(1.0)


register_model(
    "matcher_superglue",
    {"depth": 9, "dim": 256, "num_heads": 4, "sinkhorn_iters": 50, "filter_threshold": 0.2},
)(SuperGlueMatcher)
