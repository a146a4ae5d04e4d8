"""LightGlue, the adaptive transformer matcher, and its training loss.

Counterpart of ``comet_tpu/matching/lightglue.py`` (gluefactory/models/
matchers/lightglue.py:46-530): the learnable Fourier position encoding with
rotary pairs in adjacent channels, self blocks (packed ``Wqkv``, rotary q
and k, one parameter set for both images), cross blocks (one shared
``to_qk`` map, one similarity matrix for both directions), per-layer match
assignment with log-sigmoid dustbins, token confidences, and the adaptive
depth (early exit) and width (point pruning).

The adaptive path keeps the JAX package's static form: a carried
``stopped`` flag freezes the descriptors and the answering layer's
assignment, and pruned points leave the attention through validity masks
rather than ``index_select``. Which layer answers (``stop_layer``), which
points take part and the per-point layer counts (``prune0/1``) are the
reference's; the card never waits on a data-dependent host decision.
Keypoints come normalized to [-1, 1] (:func:`normalize_keypoints` gives the
reference's size-based normalization). ``forward(..., training=True)``
switches stopping and pruning off and adds every layer's log assignment
and token-confidence logits, which :func:`lightglue_loss` (the per-layer
balanced assignment NLL and the confidence BCE) takes.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.blocks import LayerNorm, Linear
from .registry import register_model

_NEG = -1e9


def normalize_keypoints(kpts: torch.Tensor, size) -> torch.Tensor:
    """Shift to the image centre and scale by the larger half-extent;
    ``size`` is (width, height)."""
    size = torch.as_tensor(size, dtype=torch.float32, device=kpts.device)
    return (kpts - size / 2.0) / (size.max() / 2.0)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent channel pairs: (x1, x2) -> (-x2, x1)."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).reshape(*x.shape[:-2], -1)


def apply_rotary(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """t [N, H, hd]; cos, sin [N, hd] broadcast over the heads."""
    return t * cos[:, None, :] + rotate_half(t) * sin[:, None, :]


class _NormalDense(nn.Linear):
    """A bias-free Dense with a normal(std) initializer."""

    def __init__(self, cin: int, cout: int, std: float):
        super().__init__(cin, cout, bias=False)
        self.std = std

    def init_own_params(self, generator):
        nn.init.normal_(self.weight, 0.0, self.std, generator=generator)


class LearnableFourierPosEnc(nn.Module):
    """(cos, sin), each [N, f_dim]: a learned projection of (x, y) to
    f_dim / 2 frequencies, each repeated twice."""

    def __init__(self, f_dim: int, gamma: float = 1.0, in_dim: int = 2):
        super().__init__()
        self.Wr = _NormalDense(in_dim, f_dim // 2, gamma ** -2)

    def forward(self, kpts):
        proj = self.Wr(kpts)
        return (torch.repeat_interleave(torch.cos(proj), 2, dim=-1),
                torch.repeat_interleave(torch.sin(proj), 2, dim=-1))


def _masked_softmax(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis without the masked keys; rows with every
    key masked get zero weights."""
    w = torch.softmax(torch.where(mask, logits, _NEG), dim=-1)
    return torch.where(mask.any(dim=-1, keepdim=True), w, 0.0)


def _ffn_block(lin1, norm, lin2, x, message):
    return x + lin2(F.gelu(norm(lin1(torch.cat([x, message], dim=-1)))))


class SelfBlock(nn.Module):
    """Self-attention with rotary q and k; one parameter set for both images."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.Wqkv = Linear(dim, 3 * dim)
        self.out_proj = Linear(dim, dim)
        self.ffn_lin1 = Linear(2 * dim, 2 * dim)
        self.ffn_norm = LayerNorm(2 * dim, 1e-6)
        self.ffn_lin2 = Linear(2 * dim, dim)

    def forward(self, x, cos, sin, mask=None):
        n, d = x.shape
        h = self.num_heads
        hd = d // h
        qkv = self.Wqkv(x).reshape(n, h, hd, 3)  # torch's unflatten layout
        q = apply_rotary(qkv[..., 0], cos, sin)
        k = apply_rotary(qkv[..., 1], cos, sin)
        logits = torch.einsum("ihd,jhd->hij", q / math.sqrt(hd), k)
        kv_mask = (torch.ones(n, dtype=torch.bool, device=x.device) if mask is None
                   else mask)[None, None, :]
        ctx = torch.einsum("hij,jhd->ihd", _masked_softmax(logits, kv_mask), qkv[..., 2])
        return _ffn_block(self.ffn_lin1, self.ffn_norm, self.ffn_lin2, x,
                          self.out_proj(ctx.reshape(n, d)))


class CrossBlock(nn.Module):
    """Cross-attention: one shared ``to_qk`` map gives one similarity matrix
    for both directions; value, output and ffn weights shared."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.to_qk = Linear(dim, dim)
        self.to_v = Linear(dim, dim)
        self.to_out = Linear(dim, dim)
        self.ffn_lin1 = Linear(2 * dim, 2 * dim)
        self.ffn_norm = LayerNorm(2 * dim, 1e-6)
        self.ffn_lin2 = Linear(2 * dim, dim)

    def forward(self, x0, x1, mask0=None, mask1=None):
        h = self.num_heads
        hd = self.dim // h
        scale = hd ** -0.25  # the square root on each side

        def split(t):
            return t.reshape(t.shape[0], h, hd)

        qk0 = split(self.to_qk(x0)) * scale
        qk1 = split(self.to_qk(x1)) * scale
        v0, v1 = split(self.to_v(x0)), split(self.to_v(x1))
        sim = torch.einsum("ihd,jhd->hij", qk0, qk1)
        m0 = torch.ones(x0.shape[0], dtype=torch.bool, device=x0.device) if mask0 is None else mask0
        m1 = torch.ones(x1.shape[0], dtype=torch.bool, device=x1.device) if mask1 is None else mask1
        attn01 = _masked_softmax(sim, m1[None, None, :])
        attn10 = _masked_softmax(sim.transpose(1, 2), m0[None, None, :])
        msg0 = torch.einsum("hij,jhd->ihd", attn01, v1).reshape(x0.shape)
        msg1 = torch.einsum("hij,jhd->ihd", attn10, v0).reshape(x1.shape)
        ffn = (self.ffn_lin1, self.ffn_norm, self.ffn_lin2)
        return _ffn_block(*ffn, x0, self.to_out(msg0)), _ffn_block(*ffn, x1, self.to_out(msg1))


class TransformerLayer(nn.Module):
    """Self-attention on both images (shared weights), then cross-attention."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.self_attn = SelfBlock(dim, num_heads)
        self.cross_attn = CrossBlock(dim, num_heads)

    def forward(self, d0, d1, enc0, enc1, mask0=None, mask1=None):
        d0 = self.self_attn(d0, enc0[0], enc0[1], mask0)
        d1 = self.self_attn(d1, enc1[0], enc1[1], mask1)
        return self.cross_attn(d0, d1, mask0, mask1)


def sigmoid_log_double_softmax(sim, z0, z1, valid0, valid1) -> torch.Tensor:
    """[M+1, N+1] log assignment from sim [M, N] and matchability logits
    z0 [M, 1], z1 [N, 1]; invalid rows and columns stay out of each
    softmax's normalization."""
    certainties = F.logsigmoid(z0) + F.logsigmoid(z1).T
    sim = torch.where(valid0[:, None] & valid1[None, :], sim, _NEG)
    inner = F.log_softmax(sim, dim=1) + F.log_softmax(sim, dim=0) + certainties
    top = torch.cat([inner, F.logsigmoid(-z0)], dim=1)
    bottom = torch.cat([F.logsigmoid(-z1[:, 0]), inner.new_zeros(1)])[None]
    return torch.cat([top, bottom], dim=0)


class MatchAssignment(nn.Module):
    """Per-layer ``final_proj`` similarity and ``matchability`` heads."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.matchability = Linear(dim, 1)
        self.final_proj = Linear(dim, dim)

    def forward(self, desc0, desc1, valid0, valid1):
        scale = self.dim ** 0.25
        m0 = self.final_proj(desc0) / scale
        m1 = self.final_proj(desc1) / scale
        sim = torch.einsum("md,nd->mn", m0, m1)
        return sigmoid_log_double_softmax(sim, self.matchability(desc0),
                                          self.matchability(desc1), valid0, valid1)

    def get_matchability(self, desc):
        return torch.sigmoid(self.matchability(desc))[:, 0]


class TokenConfidence(nn.Module):
    """The early-exit confidence logits of one layer."""

    def __init__(self, dim: int):
        super().__init__()
        self.token = Linear(dim, 1)

    def forward(self, desc0, desc1):
        return self.token(desc0.detach())[:, 0], self.token(desc1.detach())[:, 0]


def confidence_threshold(layer_index: int, n_layers: int) -> float:
    """The scaled early-exit threshold of a layer."""
    return float(np.clip(0.8 + 0.1 * np.exp(-4.0 * layer_index / n_layers), 0.0, 1.0))


def filter_matches(scores: torch.Tensor, threshold: float, valid0, valid1):
    """Mutual-max matches from the [M+1, N+1] log assignment; invalid
    (padded or pruned) points give -1. Ties go to the lowest index."""
    inner = torch.where(valid0[:, None] & valid1[None, :], scores[:-1, :-1], _NEG)
    m0 = inner.argmax(dim=1)
    m1 = inner.argmax(dim=0)
    max0 = inner.gather(1, m0[:, None])[:, 0]
    mutual0 = torch.arange(inner.shape[0], device=inner.device) == m1[m0]
    mutual1 = torch.arange(inner.shape[1], device=inner.device) == m0[m1]
    mscores0 = torch.where(mutual0, torch.exp(max0), 0.0)
    mscores1 = torch.where(mutual1, mscores0[m1], 0.0)
    valid_match0 = mutual0 & (mscores0 > threshold) & valid0
    valid_match1 = mutual1 & valid_match0[m1] & valid1
    return (torch.where(valid_match0, m0, -1), torch.where(valid_match1, m1, -1),
            torch.where(valid0, mscores0, 0.0), torch.where(valid1, mscores1, 0.0))


class LightGlueMatcher(nn.Module):
    """The full LightGlue, ``depth`` layers. ``depth_confidence`` and
    ``width_confidence`` > 0 switch on the adaptive path. ``in_dim`` is the
    descriptors' width (the JAX module infers it at init; default ``dim``)."""

    def __init__(self, depth: int = 9, dim: int = 256, num_heads: int = 4,
                 filter_threshold: float = 0.1, depth_confidence: float = -1.0,
                 width_confidence: float = -1.0, in_dim: Optional[int] = None):
        super().__init__()
        self.conf = dict(depth=depth, dim=dim, num_heads=num_heads,
                         filter_threshold=filter_threshold, depth_confidence=depth_confidence,
                         width_confidence=width_confidence)
        self.depth, self.dim, self.in_dim = depth, dim, in_dim or dim
        self.filter_threshold = filter_threshold
        self.depth_confidence, self.width_confidence = depth_confidence, width_confidence
        self.input_proj = Linear(self.in_dim, dim)
        self.posenc = LearnableFourierPosEnc(dim // num_heads)
        self.transformers = nn.ModuleList(TransformerLayer(dim, num_heads) for _ in range(depth))
        self.log_assignment = nn.ModuleList(MatchAssignment(dim) for _ in range(depth))
        self.token_confidence = nn.ModuleList(TokenConfidence(dim) for _ in range(depth - 1))

    def forward(self, kpts0, desc0, kpts1, desc1, valid0=None, valid1=None,
                training: bool = False) -> Dict[str, torch.Tensor]:
        """``training``: no stopping or pruning, and the outputs add
        ``all_log_assignment`` [L, M+1, N+1] and ``conf_logits0/1`` [L-1, M
        / N] (the loss's inputs)."""
        m, n = kpts0.shape[0], kpts1.shape[0]
        dev = kpts0.device
        v0 = torch.ones(m, dtype=torch.bool, device=dev) if valid0 is None else valid0
        v1 = torch.ones(n, dtype=torch.bool, device=dev) if valid1 is None else valid1
        d0, d1 = self.input_proj(desc0), self.input_proj(desc1)
        enc0, enc1 = self.posenc(kpts0), self.posenc(kpts1)
        do_stop = self.depth_confidence > 0 and not training
        do_prune = self.width_confidence > 0 and not training
        act0, act1 = v0, v1  # active = valid and not pruned
        all_la, conf0, conf1 = [], [], []
        if not (do_stop or do_prune):
            for i, layer in enumerate(self.transformers):
                d0, d1 = layer(d0, d1, enc0, enc1, v0, v1)
                if training:
                    all_la.append(self.log_assignment[i](d0, d1, v0, v1))
                    if i < self.depth - 1:
                        c0, c1 = self.token_confidence[i](d0, d1)
                        conf0.append(c0)
                        conf1.append(c1)
            scores = all_la[-1] if training else self.log_assignment[-1](d0, d1, v0, v1)
            stop_layer = torch.full((), self.depth, dtype=torch.int32, device=dev)
            prune0 = torch.full((m,), self.depth, dtype=torch.int32, device=dev)
            prune1 = torch.full((n,), self.depth, dtype=torch.int32, device=dev)
        else:
            stopped = torch.zeros((), dtype=torch.bool, device=dev)
            stop_layer = torch.full((), self.depth, dtype=torch.int32, device=dev)
            prune0 = v0.to(torch.int32)
            prune1 = v1.to(torch.int32)
            scores = torch.zeros(m + 1, n + 1, device=dev)
            for i, layer in enumerate(self.transformers):
                nd0, nd1 = layer(d0, d1, enc0, enc1, act0, act1)
                d0 = torch.where(((~stopped) & act0)[:, None], nd0, d0)
                d1 = torch.where(((~stopped) & act1)[:, None], nd1, d1)
                # the assignment of the layer that answers: frozen once stopped
                scores = torch.where(stopped, scores, self.log_assignment[i](d0, d1, act0, act1))
                if i == self.depth - 1:
                    continue
                c0, c1 = self.token_confidence[i](d0, d1)
                conf0, conf1 = torch.sigmoid(c0), torch.sigmoid(c1)
                thr = confidence_threshold(i, self.depth)
                if do_stop:
                    n_conf = (act0 & (conf0 >= thr)).sum() + (act1 & (conf1 >= thr)).sum()
                    ratio = n_conf / (act0.sum() + act1.sum()).clamp_min(1)
                    stop_now = ratio > self.depth_confidence
                    stop_layer = torch.where(stop_now & ~stopped, i + 1, stop_layer)
                    stopped = stopped | stop_now
                if do_prune:
                    la = self.log_assignment[i]
                    keep0 = (la.get_matchability(d0) > 1.0 - self.width_confidence) | (conf0 <= thr)
                    keep1 = (la.get_matchability(d1) > 1.0 - self.width_confidence) | (conf1 <= thr)
                    act0 = act0 & (keep0 | stopped)
                    act1 = act1 & (keep1 | stopped)
                    prune0 = prune0 + (act0 & ~stopped).to(torch.int32)
                    prune1 = prune1 + (act1 & ~stopped).to(torch.int32)

        matches0, matches1, mscores0, mscores1 = filter_matches(
            scores, self.filter_threshold, act0, act1)
        out = {
            "matches0": matches0,
            "matches1": matches1,
            "scores0": mscores0,
            "scores1": mscores1,
            "log_assignment": scores,
            "assignment": torch.exp(scores[:-1, :-1]),
            "matchability0": self.log_assignment[-1].get_matchability(d0),
            "matchability1": self.log_assignment[-1].get_matchability(d1),
            "stop_layer": stop_layer,
            "prune0": prune0,
            "prune1": prune1,
        }
        if training:
            out["all_log_assignment"] = torch.stack(all_la)
            out["conf_logits0"] = torch.stack(conf0)
            out["conf_logits1"] = torch.stack(conf1)
        return out


def _assignment_nll(la: torch.Tensor, gt0: torch.Tensor, gt1: torch.Tensor,
                    nll_balancing: float = 0.5) -> torch.Tensor:
    """Balanced NLL of the ground-truth assignment under the [M+1, N+1] log
    assignment ``la``: matched points (gt0 >= 0) maximize their inner
    entry, unmatched ones (UNMATCHED) their dustbin, IGNORE adds nothing."""
    from .gt_generation import UNMATCHED

    m, n = la.shape[0] - 1, la.shape[1] - 1
    pos0 = gt0 >= 0
    ll_pos = la[:m, :n].gather(1, gt0.clamp(0, n - 1)[:, None])[:, 0]
    nll_pos = -(ll_pos * pos0).sum() / pos0.sum().clamp_min(1)
    neg0, neg1 = gt0 == UNMATCHED, gt1 == UNMATCHED
    num_neg = neg0.sum().clamp_min(1) + neg1.sum().clamp_min(1)
    nll_neg = -((la[:m, n] * neg0).sum() + (la[m, :n] * neg1).sum()) / num_neg
    return nll_balancing * nll_pos + (1.0 - nll_balancing) * nll_neg


def lightglue_loss(out: Dict[str, torch.Tensor], gt0: torch.Tensor, gt1: torch.Tensor,
                   gamma: float = 1.0, nll_balancing: float = 0.5) -> Dict[str, torch.Tensor]:
    """LightGlue's training loss on a ``training=True`` output: the final
    layer's NLL plus each earlier layer's weighted gamma^(L-i-1) (i + 1
    where gamma <= 0), over the weights' sum, plus the token-confidence BCE
    against "layer i's argmax already equals the final layer's" (both log
    assignments detached). Returns total, assignment_nll, confidence, last."""
    all_la = out["all_log_assignment"]
    n_layers = all_la.shape[0]
    nll_final = _assignment_nll(all_la[-1], gt0, gt1, nll_balancing)
    total, sum_w = nll_final, 1.0
    for i in range(n_layers - 1):
        w = gamma ** (n_layers - i - 1) if gamma > 0 else float(i + 1)
        total = total + w * _assignment_nll(all_la[i], gt0, gt1, nll_balancing)
        sum_w += w
    total = total / sum_w

    la_final = all_la[-1].detach()
    conf_loss = all_la.new_zeros(())
    for i in range(n_layers - 1):
        la_i = all_la[i].detach()
        correct0 = la_i[:-1, :].argmax(-1) == la_final[:-1, :].argmax(-1)
        correct1 = la_i[:, :-1].argmax(0) == la_final[:, :-1].argmax(0)
        bce0 = F.binary_cross_entropy_with_logits(out["conf_logits0"][i], correct0.float())
        bce1 = F.binary_cross_entropy_with_logits(out["conf_logits1"][i], correct1.float())
        conf_loss = conf_loss + (bce0 + bce1) / 2.0
    conf_loss = conf_loss / max(n_layers - 1, 1)
    return {"total": total + conf_loss, "assignment_nll": total, "confidence": conf_loss,
            "last": nll_final}


register_model(
    "matcher_lightglue",
    {"depth": 9, "dim": 256, "num_heads": 4, "filter_threshold": 0.1,
     "depth_confidence": -1.0, "width_confidence": -1.0},
)(LightGlueMatcher)
