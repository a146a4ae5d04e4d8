"""GlueStick: the joint point and line assignment GNN.

Counterpart of ``comet_tpu/matching/gluestick.py`` (glue-factory's
models/matchers/gluestick.py): line endpoints become junction tokens in the
same set as the keypoints, junctions first (``2K`` endpoint tokens, then
``N`` keypoints); a keypoint encoder MLP on (x, y, score) is added to the
projected descriptors, an endpoint encoder MLP on (endpoint, vector to the
other endpoint, line score) gives each endpoint its line encoding; ``depth``
rounds of a self layer, ``num_line_iterations`` line layers and a cross
layer, each attention layer's weights shared by both images (4-head
attention with a key mask, an MLP merge on [x, message], the caller adds
the residual); a line layer sends one message per endpoint from (its
token, the other endpoint's token, the line encoding) and scatter-means
them onto the junction tokens (``line_attention=True``: a softmax per
junction over its endpoints, then a scatter-sum). The point assignment is a
dual log-softmax with one learned dustbin over all tokens; the line
assignment scores line pairs by the better of the direct and the reversed
endpoint pairing, with its own dustbin; matches are mutual maxima above
``filter_threshold``.

As in the JAX package the MLPs' norms are LayerNorms, a fully masked key
set gives a zero message (finite logits, zeroed weights), and the scatter
is a one-hot [T, 2K] contraction. The parameter names mirror the flax paths
(``self_<i>``, ``line_<i>`` and ``cross_<i>`` are module names, not list
entries), so ``weights.module_params_from_jax`` carries the JAX package's
weights across, the scalar ``bin_score`` and ``line_bin_score`` included.
``in_dim`` and ``line_in_dim`` are the point and line descriptors' widths
(the JAX module infers them at init; default ``dim``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..models.blocks import LayerNorm, Linear
from .registry import register_model

_NEG = -1e9


class GSMLP(nn.Module):
    """Dense layers of ``channels`` widths, LayerNorm and ReLU between them,
    none after the last."""

    def __init__(self, in_dim: int, channels: Sequence[int]):
        super().__init__()
        widths = (in_dim,) + tuple(channels)
        self.n = len(channels)
        for i in range(self.n):
            setattr(self, f"fc{i}", Linear(widths[i], widths[i + 1]))
            if i < self.n - 1:
                setattr(self, f"norm{i}", LayerNorm(widths[i + 1]))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
            if i < self.n - 1:
                x = torch.relu(getattr(self, f"norm{i}")(x))
        return x


class KeypointEncoderGS(nn.Module):
    """(x, y, score) -> dim, added to the descriptor's projection."""

    def __init__(self, dim: int, layers: Sequence[int] = (32, 64, 128, 256)):
        super().__init__()
        self.encoder = GSMLP(3, tuple(layers) + (dim,))

    def forward(self, kpts, scores):
        return self.encoder(torch.cat([kpts, scores[:, None]], dim=-1))


class EndPtEncoderGS(nn.Module):
    """Per-endpoint line encoding from (endpoint, vector to the other
    endpoint, line score): [2K, dim] in (line0 end0, line0 end1, line1
    end0, ...) order."""

    def __init__(self, dim: int, layers: Sequence[int] = (32, 64, 128, 256)):
        super().__init__()
        self.encoder = GSMLP(5, tuple(layers) + (dim,))

    def forward(self, lines, scores):  # [K, 2, 2], [K]
        k = lines.shape[0]
        off = lines[:, 1] - lines[:, 0]
        offsets = torch.stack([off, -off], dim=1).reshape(2 * k, 2)
        x = torch.cat([lines.reshape(2 * k, 2), offsets,
                       scores.repeat_interleave(2)[:, None]], dim=-1)
        return self.encoder(x)


class AttentionalPropagationGS(nn.Module):
    """The attention message from ``source`` merged by an MLP([2D, 2D, D])
    on [x, message]; the caller adds the residual."""

    def __init__(self, dim: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.q = Linear(dim, dim)
        self.k = Linear(dim, dim)
        self.v = Linear(dim, dim)
        self.merge = Linear(dim, dim)
        self.mlp = GSMLP(2 * dim, (2 * dim, dim))

    def forward(self, x, source, mask=None):
        d = x.shape[-1]
        h = self.num_heads
        hd = d // h
        q = self.q(x).reshape(-1, h, hd)
        k = self.k(source).reshape(-1, h, hd)
        v = self.v(source).reshape(-1, h, hd)
        logits = torch.einsum("qhd,khd->hqk", q / math.sqrt(hd), k)
        if mask is not None:
            # finite fill: a fully masked set gives uniform weights, zeroed below
            logits = torch.where(mask[None, None, :], logits, _NEG)
        w = torch.softmax(logits, dim=-1)
        if mask is not None:
            w = torch.where(mask.any(), w, 0.0)
        msg = torch.einsum("hqk,khd->qhd", w, v).reshape(-1, d)
        return self.mlp(torch.cat([x, self.merge(msg)], dim=-1))


class LineLayerGS(nn.Module):
    """Line message passing onto the junction tokens (see the module
    docstring); returns the updated tokens."""

    def __init__(self, dim: int, line_attention: bool = False):
        super().__init__()
        self.line_attention = line_attention
        self.mlp = GSMLP(3 * dim, (2 * dim, dim))
        if line_attention:
            self.proj_node = Linear(dim, dim)
            self.proj_neigh = Linear(2 * dim, dim)

    def forward(self, x, line_enc, junc_idx, lvalid):
        # x [T, D] tokens; line_enc [2K, D]; junc_idx [2K] into [0, T);
        # lvalid [2K] endpoint validity (the parent line's)
        d = x.shape[-1]
        t = x.shape[0]
        k2 = junc_idx.shape[0]
        line_desc = x[junc_idx]
        flipped = line_desc.reshape(-1, 2, d).flip(1).reshape(k2, d)
        msg = self.mlp(torch.cat([line_desc, flipped, line_enc], dim=-1))
        onehot = ((junc_idx[None, :] == torch.arange(t, device=x.device)[:, None])
                  & lvalid[None, :]).float()  # [T, 2K]
        if self.line_attention:
            query = self.proj_node(x)[junc_idx]
            key = self.proj_neigh(torch.cat([flipped, line_enc], dim=-1))
            s = (query * key).float().sum(-1) / math.sqrt(d)
            e = torch.where(lvalid, torch.exp(s - s.max()), 0.0)
            denom = onehot @ e  # [T] per-junction normalizer
            prob = e / (denom[junc_idx] + 1e-8)
            update = onehot @ (prob[:, None] * msg).float()
        else:
            total = onehot @ msg.float()
            count = onehot.sum(dim=1, keepdim=True)
            update = total / count.clamp_min(1.0)
        return x + update.to(x.dtype)


def log_double_softmax(
    scores: torch.Tensor,  # [M, N] f32
    bin_score: torch.Tensor,  # scalar
    valid0: torch.Tensor,  # [M]
    valid1: torch.Tensor,  # [N]
) -> torch.Tensor:
    """Rows softmax over [N real + dustbin], columns over [M real + dustbin],
    the real block averaged: [M+1, N+1], the corner 0."""
    m, n = scores.shape
    s = torch.where(valid0[:, None] & valid1[None, :], scores, _NEG)
    b = bin_score.float()
    ls0 = torch.log_softmax(torch.cat([s, torch.where(valid0, b, _NEG)[:, None]], dim=1), dim=1)
    ls1 = torch.log_softmax(torch.cat([s, torch.where(valid1, b, _NEG)[None, :]], dim=0), dim=0)
    out = torch.zeros(m + 1, n + 1, device=scores.device)
    out[:m, :n] = (ls0[:, :n] + ls1[:m]) / 2.0
    out[:m, n] = ls0[:, n]
    out[m, :n] = ls1[m]
    return out


def get_matches(
    log_assignment: torch.Tensor,  # [M+1, N+1]
    valid0: torch.Tensor,
    valid1: torch.Tensor,
    threshold: float,
):
    """Mutual maxima of the inner block, kept above ``threshold`` in
    probability: (matches0, matches1, scores0, scores1)."""
    m, n = log_assignment.shape[0] - 1, log_assignment.shape[1] - 1
    block = log_assignment[:m, :n]
    m0 = block.argmax(dim=1)
    m1 = block.argmax(dim=0)
    max0 = block.gather(1, m0[:, None])[:, 0]
    mutual0 = torch.arange(m, device=block.device) == m1[m0]
    mutual1 = torch.arange(n, device=block.device) == m0[m1]
    mscores0 = torch.where(mutual0, torch.exp(max0), 0.0)
    mscores1 = torch.where(mutual1, mscores0[m1], 0.0)
    ok0 = mutual0 & (mscores0 > threshold) & valid0 & valid1[m0]
    ok1 = mutual1 & ok0[m1] & valid1
    return torch.where(ok0, m0, -1), torch.where(ok1, m1, -1), mscores0, mscores1


class GlueStickMatcher(nn.Module):
    """The joint point and line matcher. Inputs: kpts [N, 2] normalized,
    desc [N, Dp], lines [K, 2, 2] normalized endpoints, ldesc [K, S, Dl]
    line-point descriptors (samples 0 and S-1, the endpoints, are the
    junction tokens' descriptors unless ``jdesc`` is given); optional
    validity masks, detector and line scores (default 1) and ``junc_idx``
    [K, 2] mapping endpoints to shared junction tokens (default: each
    endpoint its own). Returns the JAX package's 17 outputs."""

    def __init__(self, depth: int = 9, dim: int = 256, num_heads: int = 4,
                 encoder_layers: Sequence[int] = (32, 64, 128, 256),
                 num_line_iterations: int = 1, line_attention: bool = False,
                 filter_threshold: float = 0.2, in_dim: Optional[int] = None,
                 line_in_dim: Optional[int] = None):
        super().__init__()
        self.conf = dict(depth=depth, dim=dim, num_heads=num_heads,
                         encoder_layers=tuple(encoder_layers),
                         num_line_iterations=num_line_iterations,
                         line_attention=line_attention, filter_threshold=filter_threshold)
        self.depth, self.dim = depth, dim
        self.num_line_iterations, self.filter_threshold = num_line_iterations, filter_threshold
        self.input_proj = Linear(in_dim or dim, dim)
        self.endpoint_proj = Linear(line_in_dim or dim, dim)
        self.kenc = KeypointEncoderGS(dim, encoder_layers)
        self.lenc = EndPtEncoderGS(dim, encoder_layers)
        for i in range(depth):
            setattr(self, f"self_{i}", AttentionalPropagationGS(dim, num_heads))
            setattr(self, f"line_{i}", LineLayerGS(dim, line_attention))
            setattr(self, f"cross_{i}", AttentionalPropagationGS(dim, num_heads))
        self.final_proj = Linear(dim, dim)
        self.final_line_proj = Linear(dim, dim)
        self.bin_score = nn.Parameter(torch.tensor(1.0))
        self.line_bin_score = nn.Parameter(torch.tensor(1.0))
        # flax module names that look like list entries
        self.FLAX_VERBATIM = tuple(f"{kind}_{i}" for i in range(depth)
                                   for kind in ("self", "line", "cross"))

    def init_own_params(self, generator):
        self.bin_score.fill_(1.0)
        self.line_bin_score.fill_(1.0)

    def forward(self, kpts0, desc0, kpts1, desc1, lines0, ldesc0, lines1, ldesc1,
                valid0=None, valid1=None, lvalid0=None, lvalid1=None,
                scores0=None, scores1=None, line_scores0=None, line_scores1=None,
                junc_idx0=None, junc_idx1=None, jdesc0=None, jdesc1=None
                ) -> Dict[str, torch.Tensor]:
        dev = kpts0.device
        n0, n1 = kpts0.shape[0], kpts1.shape[0]
        k0, k1 = lines0.shape[0], lines1.shape[0]

        def defaults(n, k, v, lv, s, ls, ji):
            ones = lambda c, dt: torch.ones(c, dtype=dt, device=dev)  # noqa: E731
            v = ones(n, torch.bool) if v is None else v
            lv = ones(k, torch.bool) if lv is None else lv
            s = ones(n, torch.float32) if s is None else s
            ls = ones(k, torch.float32) if ls is None else ls
            ji = (torch.arange(2 * k, device=dev).reshape(k, 2) if ji is None else ji.long())
            return v, lv, s, ls, ji

        v0, lv0, s0, ls0, ji0 = defaults(n0, k0, valid0, lvalid0, scores0, line_scores0,
                                         junc_idx0)
        v1, lv1, s1, ls1, ji1 = defaults(n1, k1, valid1, lvalid1, scores1, line_scores1,
                                         junc_idx1)

        def tokens(kpts, desc, lines, ldesc, jdesc, s, ls):
            if jdesc is None:  # the first and last line-point samples
                jdesc = torch.stack([ldesc[:, 0], ldesc[:, -1]], dim=1).reshape(
                    2 * lines.shape[0], -1)
            xj = self.endpoint_proj(jdesc) + self.kenc(lines.reshape(-1, 2),
                                                       ls.repeat_interleave(2))
            xp = self.input_proj(desc) + self.kenc(kpts, s)
            return torch.cat([xj, xp], dim=0)  # junctions first

        x0 = tokens(kpts0, desc0, lines0, ldesc0, jdesc0, s0, ls0)
        x1 = tokens(kpts1, desc1, lines1, ldesc1, jdesc1, s1, ls1)
        line_enc0 = self.lenc(lines0, ls0)
        line_enc1 = self.lenc(lines1, ls1)
        ejv0, ejv1 = lv0.repeat_interleave(2), lv1.repeat_interleave(2)  # endpoint validity
        tv0, tv1 = torch.cat([ejv0, v0]), torch.cat([ejv1, v1])  # token validity
        ji0_flat, ji1_flat = ji0.reshape(-1), ji1.reshape(-1)

        for i in range(self.depth):
            self_l = getattr(self, f"self_{i}")
            x0 = x0 + self_l(x0, x0, mask=tv0)
            x1 = x1 + self_l(x1, x1, mask=tv1)
            line_l = getattr(self, f"line_{i}")
            for _ in range(self.num_line_iterations):
                x0 = line_l(x0, line_enc0, ji0_flat, ejv0)
                x1 = line_l(x1, line_enc1, ji1_flat, ejv1)
            cross_l = getattr(self, f"cross_{i}")
            d0 = cross_l(x0, x1, mask=tv1)
            d1 = cross_l(x1, x0, mask=tv0)
            x0, x1 = x0 + d0, x1 + d1

        # the point assignment over all tokens, one dustbin for both kinds
        f0 = self.final_proj(x0).float()
        f1 = self.final_proj(x1).float()
        sim = (f0 @ f1.T) / math.sqrt(self.dim)
        log_full = log_double_softmax(sim, self.bin_score, tv0, tv1)
        tm0, tm1, tsc0, tsc1 = get_matches(log_full, tv0, tv1, self.filter_threshold)
        # a keypoint's match counts only where it lands on a keypoint token
        km0 = tm0[2 * k0:]
        km0 = torch.where(km0 >= 2 * k1, km0 - 2 * k1, -1)
        km1 = tm1[2 * k1:]
        km1 = torch.where(km1 >= 2 * k0, km1 - 2 * k0, -1)
        ksc0, ksc1 = tsc0[2 * k0:], tsc1[2 * k1:]
        kp_log = log_full[2 * k0:, 2 * k1:]  # the keypoint rows, columns and dustbins

        # the line assignment from the junction tokens
        lf0 = self.final_line_proj(x0[:2 * k0]).float()
        lf1 = self.final_line_proj(x1[:2 * k1]).float()
        lsim = (lf0 @ lf1.T) / math.sqrt(self.dim)
        lsim = lsim[:, ji1_flat][ji0_flat].reshape(k0, 2, k1, 2)  # at each endpoint's junction
        raw_line_scores = 0.5 * torch.maximum(lsim[:, 0, :, 0] + lsim[:, 1, :, 1],
                                              lsim[:, 0, :, 1] + lsim[:, 1, :, 0])
        line_log = log_double_softmax(raw_line_scores, self.line_bin_score, lv0, lv1)
        lm0, lm1, lsc0, lsc1 = get_matches(line_log, lv0, lv1, self.filter_threshold)
        return {
            "matches0": km0,
            "matches1": km1,
            "matching_scores0": ksc0,
            "matching_scores1": ksc1,
            "log_assignment": kp_log,
            "token_log_assignment": log_full,
            "token_matches0": tm0,
            "line_matches0": lm0,
            "line_matches1": lm1,
            "line_matching_scores0": lsc0,
            "line_matching_scores1": lsc1,
            "line_log_assignment": line_log,
            "raw_line_scores": raw_line_scores,
            # the JAX package's aliases
            "scores0": ksc0,
            "assignment": torch.exp(kp_log[:n0, :n1]),
            "line_scores0": lsc0,
            "line_assignment": torch.exp(line_log[:k0, :k1]),
        }


def gluestick_nll_loss(
    log_assignment: torch.Tensor,  # [M+1, N+1]
    gt_matches0: torch.Tensor,  # [M] index into N, or -1
    gt_matches1: torch.Tensor,  # [N] index into M, or -1
    gt_assignment: Optional[torch.Tensor] = None,  # [M, N] bool
    balancing: float = 0.5,
) -> torch.Tensor:
    """``balancing * nll(positives) + (1 - balancing) * nll(dustbins)``; a
    label of -1 is a dustbin, any other negative label is left out."""
    m, n = log_assignment.shape[0] - 1, log_assignment.shape[1] - 1
    if gt_assignment is None:
        gt_assignment = ((gt_matches0[:, None] == torch.arange(n, device=gt_matches0.device)[None])
                         & (gt_matches0 >= 0)[:, None])
    pos = gt_assignment.float()
    num_pos = pos.sum().clamp_min(1.0)
    neg0 = (gt_matches0 == -1).float()
    neg1 = (gt_matches1 == -1).float()
    num_neg = (neg0.sum() + neg1.sum()).clamp_min(1.0)
    nll_pos = -(log_assignment[:m, :n] * pos).sum() / num_pos
    nll_neg = (-(log_assignment[:m, n] * neg0).sum()
               - (log_assignment[m, :n] * neg1).sum()) / num_neg
    return balancing * nll_pos + (1.0 - balancing) * nll_neg


register_model(
    "matcher_gluestick",
    {
        "depth": 9,
        "dim": 256,
        "num_heads": 4,
        "num_line_iterations": 1,
        "line_attention": False,
        "filter_threshold": 0.2,
    },
)(GlueStickMatcher)
