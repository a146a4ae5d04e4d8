"""COMET end to end: tracker + camera predictor, and its entry points.

Counterpart of ``comet_tpu/models/comet.py`` (``COMET``, ``encode_gt``,
``decode_predictions``, ``pose_loss``). The tracker branch serves the
camera predictor; under ``cfg.freeze_track`` (every preset) it runs under
``torch.no_grad()``, the counterpart of JAX's ``stop_gradient`` on its
outputs, so a train step records no graph through it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..config import CometConfig, KernelRoute
from ..geometry.cameras import CameraSet
from ..device import resolve_device
from ..geometry.codecs import (
    INTRINSICS_TABLE,
    decode_relative_uvz,
    decode_relative_xyz,
    encode_relative_uvz,
    encode_relative_xyz,
)
from ..ops.bilinear import resize_bilinear_align_corners
from ..utils.profiling import span
from .blocks import init_params, set_route
from .camera_predictor import CameraPredictor
from .encoders import BasicEncoder, ShallowEncoder
from .refine import refine_track
from .tracker import BaseTracker


class COMET(nn.Module):
    def __init__(self, cfg: CometConfig):
        super().__init__()
        self.cfg = cfg
        tc, dtype = cfg.tracker, cfg.dtype
        if cfg.enable_track:
            self.coarse_fnet = BasicEncoder(tc.coarse_latent_dim, tc.coarse_stride, dtype)
            self.coarse_tracker = BaseTracker(
                stride=tc.coarse_stride, corr_levels=tc.coarse_corr_levels,
                corr_radius=tc.coarse_corr_radius, latent_dim=tc.coarse_latent_dim,
                hidden_size=tc.coarse_hidden_size, use_space_attn=True,
                depth=tc.coarse_depth, fine=False, predict_conf=tc.predict_conf,
                dtype=dtype,
            )
            if cfg.fine_tracker:
                psize = 2 * tc.fine_pradius + 1
                # native-resolution fine features; the upsample to psize is
                # folded into the fine tracker's correlation volumes
                self.fine_fnet = ShallowEncoder(
                    tc.fine_latent_dim, stride=1, dtype=dtype, resize_output=False
                )
                self.fine_tracker = BaseTracker(
                    stride=1, corr_levels=tc.fine_corr_levels,
                    corr_radius=tc.fine_corr_radius, latent_dim=tc.fine_latent_dim,
                    hidden_size=tc.fine_hidden_size, use_space_attn=False,
                    depth=tc.fine_depth, fine=True, dtype=dtype, corr_size=(psize, psize),
                )
        if cfg.enable_pose:
            cc = cfg.camera
            self.camera_predictor = CameraPredictor(
                hidden_size=cc.hidden_size, num_heads=cc.num_heads, mlp_ratio=cc.mlp_ratio,
                att_depth=cc.att_depth, trunk_depth=cc.trunk_depth, down_size=cc.down_size,
                use_trajectory=cc.use_trajectory, use_time=cc.use_time, use_gapr=cc.use_gapr,
                backbone_depth=cc.backbone_depth, backbone_dim=cc.backbone_dim,
                backbone_heads=cc.backbone_heads, dtype=dtype,
            )

    def set_route(self, route: KernelRoute) -> "COMET":
        """Switch every block and LayerNorm to ``route``; no parameter
        changes, so one built model serves every route."""
        set_route(self, route)
        return self

    def forward(
        self,
        images: torch.Tensor,  # [B, S, H, W, 3] ImageNet-normalized
        queries: torch.Tensor,  # [B, N, 2] frame-0 query points (pixels)
    ) -> Dict[str, torch.Tensor]:
        with span("forward"):
            cfg = self.cfg
            out: Dict[str, torch.Tensor] = {}
            pred_track = track_confidence = None

            if cfg.enable_track:
                with span("tracker"), (torch.no_grad() if cfg.freeze_track
                                       else contextlib.nullcontext()):
                    pred_track, track_confidence = self._track(images, queries, out)

            if cfg.enable_pose:
                with span("camera"):
                    preds = self.camera_predictor(images, pred_track, track_confidence)
                out["pred_pose_enc"] = preds.pred_pose_enc  # [B, S, 7]
            return out

    def _track(self, images, queries, out):
        """The coarse and fine trackers: (tracks, confidence), and their
        other outputs into ``out``."""
        cfg, tc, dtype = self.cfg, self.cfg.tracker, self.cfg.dtype
        b, s, h, w, _ = images.shape
        with span("tracker.coarse"):
            imgs_flat = images.reshape(b * s, h, w, 3)
            if tc.coarse_down_ratio > 1:
                imgs_flat = resize_bilinear_align_corners(
                    imgs_flat, h // tc.coarse_down_ratio, w // tc.coarse_down_ratio
                )
            fmaps = self.coarse_fnet(imgs_flat.to(dtype))
            fmaps = fmaps.reshape(b, s, *fmaps.shape[1:])
            coarse_out = self.coarse_tracker(
                queries, fmaps, iters=tc.coarse_iters, down_ratio=tc.coarse_down_ratio
            )
        coarse_pred = coarse_out.coord_preds[-1]  # [B, S, N, 2]

        if cfg.fine_tracker:
            with span("tracker.fine"):
                refined, score = refine_track(
                    images.to(dtype),
                    self.fine_fnet,
                    lambda q, f, iters: self.fine_tracker(q, f, iters=iters),
                    coarse_pred,
                    pradius=tc.fine_pradius,
                    sradius=tc.fine_sradius,
                    compute_score=True,
                    iters=tc.fine_iters,
                )
                # confidence = normalized inverse heatmap std
                inv = 1.0 / (score + 1e-6)
                track_confidence = inv / inv.amax(dim=1, keepdim=True)
        else:
            refined = coarse_pred
            track_confidence = torch.ones_like(coarse_out.vis)
        out["coarse_track"] = coarse_pred.detach()
        out["pred_track"] = refined
        out["track_score"] = track_confidence
        if coarse_out.vis is not None:
            out["track_vis"] = coarse_out.vis.detach()
        return refined, track_confidence


def build_comet(
    cfg: CometConfig, device: Optional[str] = None, seed: int = 0,
    route: KernelRoute = KernelRoute(),
) -> COMET:
    """COMET with random weights drawn from ``seed`` (the JAX package's
    initializers), in eval mode on ``device``, taking the kernels of
    ``route`` (default: the JAX package's defaults; see ``COMET.set_route``).

    The default device is CUDA; without a card it raises rather than fall
    back: pass ``device="cpu"`` explicitly. ``device="meta"`` builds the
    parameter shapes only.
    """
    device = resolve_device(device, "build_comet")
    if device.type == "meta":
        with torch.device("meta"):
            return COMET(cfg).set_route(route).eval()
    model = COMET(cfg).set_route(route)
    generator = torch.Generator().manual_seed(seed)
    init_params(model, generator)
    return model.to(device).eval()


def encode_gt(cfg: CometConfig, gt_cams: CameraSet) -> torch.Tensor:
    """Ground-truth cameras in the config's codec: a per-sequence camera set
    ([S, ...] -> [S, 8] uvz or [S, 7] xyz) or a batched one ([B, S, ...] ->
    [B, S, 8 or 7])."""
    fn = encode_relative_uvz if cfg.camera.use_gapr else encode_relative_xyz
    if gt_cams.q.dim() == 3:
        return torch.stack([fn(CameraSet(*(f[i] for f in gt_cams)))
                            for i in range(gt_cams.q.shape[0])])
    return fn(gt_cams)


def decode_predictions(
    cfg: CometConfig, pred_pose_enc: torch.Tensor, gt_cams: CameraSet
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relative predictions -> absolute (quat, T_xyz), with the frame-0
    camera of ``gt_cams`` as the reference. Batched camera sets
    ([B, S, ...]) decode per sequence."""
    if gt_cams.q.dim() == 3:
        parts = [
            decode_predictions(cfg, pred_pose_enc[i], CameraSet(*(f[i] for f in gt_cams)))
            for i in range(gt_cams.q.shape[0])
        ]
        return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])
    if cfg.camera.use_gapr:
        return decode_relative_uvz(pred_pose_enc, gt_cams, INTRINSICS_TABLE[cfg.dataset])
    return decode_relative_xyz(pred_pose_enc, gt_cams)


def pose_loss(
    cfg: CometConfig, pred_pose_enc: torch.Tensor, gt_enc: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """MSE over frames 1..S-1, x100, of translation and rotation, weighted
    by ``weight_trans`` and ``weight_rot``; pred [B, S, 7], gt [B, S, >= 7].
    The dtype is PyTorch's promotion of the two, as JAX's."""
    trans = ((pred_pose_enc[:, 1:, :3] - gt_enc[..., 1:, :3]) ** 2).mean() * 100.0
    rot = ((pred_pose_enc[:, 1:, 3:7] - gt_enc[..., 1:, 3:7]) ** 2).mean() * 100.0
    loss = cfg.train.weight_trans * trans + cfg.train.weight_rot * rot
    return {"loss": loss, "loss_trans": trans, "loss_rot": rot}
