"""COMET's camera-only train step in plain PyTorch, float32: the reference
of the train cell.

The released recipe (train_util.py's build_optimizer and
WarmupCosineRestarts): the camera predictor is trained without its frozen
DINOv2 backbone; the loss is the mean squared error over frames 1..S-1,
times 100, of the uv-z translation (weight ``weight_trans``) and the
rotation (weight ``weight_rot``) of the frame-0-relative encoding; the
gradients are clipped to a global norm of ``clip_grad``, then AdamW (betas
0.9, 0.999, eps 1e-8, weight decay 1e-4) at the schedule's rate for the
count of steps before it: cosine restarts over 80 epochs with a linear
warmup from ``warmup_lr_init`` over the first ``warmup_ratio`` of each.
A parameter the loss does not reach gets a zero gradient, as in JAX.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .comet import Plain, camera_spec

_UV_NORM = 128.0  # the codec's du/dv normalization, whatever the crop size
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def trainable(name: str) -> bool:
    return name.startswith("camera_predictor.") and ".backbone." not in name


def _quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def encode_uvz(q, t_uvz, focal, ratio):
    """Ground truth in the uv-z codec, per sequence: q [B, S, 4] wxyz,
    t_uvz [B, S, 3], focal [B, S, 2], ratio [B] -> [B, S, 8] =
    (du, dv, dd, frame-0-relative quaternion with w >= 0, focal); frame 0
    the identity."""
    q0_inv = q[:, :1] * q.new_tensor([1.0, -1.0, -1.0, -1.0])
    rel = _quat_mul(q, q0_inv.expand_as(q))
    rel = torch.where(rel[..., :1] < 0, -rel, rel)
    r = ratio[:, None]
    du = (t_uvz[..., 0] - t_uvz[:, :1, 0]) * r / _UV_NORM
    dv = (t_uvz[..., 1] - t_uvz[:, :1, 1]) * r / _UV_NORM
    dd = (t_uvz[..., 2] / t_uvz[:, :1, 2] - 1.0) * r
    f = focal[..., 0].clamp(0.1, 30.0)
    enc = torch.cat([torch.stack([du, dv, dd], -1), rel, f[..., None]], -1)
    first = torch.cat([enc.new_tensor([0, 0, 0, 1, 0, 0, 0]).expand(enc.shape[0], 7),
                       f[:, :1]], -1)
    return torch.cat([first[:, None], enc[:, 1:]], 1)


def pose_loss(pred, gt_enc, weight_trans: float, weight_rot: float):
    trans = ((pred[:, 1:, :3] - gt_enc[:, 1:, :3]) ** 2).mean() * 100.0
    rot = ((pred[:, 1:, 3:7] - gt_enc[:, 1:, 3:7]) ** 2).mean() * 100.0
    return weight_trans * trans + weight_rot * rot


def rate(step: int, train: dict, steps_per_epoch: int) -> float:
    period = train.get("restart_epochs", 80) * steps_per_epoch
    warm = int(period * train["warmup_ratio"])
    t = step % period
    if t < warm:
        return train["warmup_lr_init"] + (train["lr"] - train["warmup_lr_init"]) * t / max(warm, 1)
    return train["lr"] * (1.0 + math.cos(math.pi * (t - warm) / max(period - warm, 1))) / 2.0


class Trainer:
    """The reference's train state: float32 parameters (a copy of
    ``params``), AdamW's moments, the step count."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, steps_per_epoch: int,
                 rnd=None):
        self.cfg, self.rnd, self.steps_per_epoch = cfg, rnd, steps_per_epoch
        self.p = {k: v.detach().clone() for k, v in params.items()}
        self.names = sorted(k for k in self.p if trainable(k))
        for k in self.names:
            self.p[k].requires_grad_(True)
        self.opt = torch.optim.AdamW([self.p[k] for k in self.names], lr=1.0, foreach=False,
                                     **ADAMW)
        self.count = 0

    def step(self, images, tracks, confidence, gt: dict) -> Dict[str, object]:
        """One step; returns its loss and the clipped gradients, by name."""
        train = self.cfg["train"]
        pred = Plain(self.p, self.rnd).camera(images, tracks, confidence, camera_spec(self.cfg))
        gt_enc = encode_uvz(gt["q"], gt["t_uvz"], gt["focal"], gt["ratio"])
        loss = pose_loss(pred, gt_enc, train["weight_trans"], train["weight_rot"])
        leaves = [self.p[k] for k in self.names]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        scale = torch.clamp(train["clip_grad"] / norm, max=1.0)
        for p, g in zip(leaves, grads):
            p.grad = g * scale
        for group in self.opt.param_groups:
            group["lr"] = rate(self.count, train, self.steps_per_epoch)
        self.opt.step()
        self.count += 1
        return {"loss": loss.detach(), "grads": {k: p.grad for k, p in zip(self.names, leaves)}}

    def leaves(self) -> List[str]:
        return self.names
