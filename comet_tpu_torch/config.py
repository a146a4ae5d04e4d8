"""Typed configuration with named experiment presets.

Counterpart of ``comet_tpu/config.py``: the same frozen dataclasses, fields,
defaults and five presets (ours, abl_all, abl_track, abl_time, abl_uvz),
with a torch dtype for the compute type, and :class:`KernelRoute`, the
explicit form of the JAX package's kernel switches.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Coarse/fine tracker hyperparameters."""

    # coarse
    coarse_stride: int = 4
    coarse_down_ratio: int = 2
    coarse_corr_levels: int = 5
    coarse_corr_radius: int = 4
    coarse_latent_dim: int = 128
    coarse_hidden_size: int = 384
    coarse_depth: int = 6
    coarse_iters: int = 4
    # fine
    fine_corr_levels: int = 3
    fine_corr_radius: int = 3
    fine_latent_dim: int = 32
    fine_hidden_size: int = 256
    fine_depth: int = 4
    fine_iters: int = 6
    fine_pradius: int = 15
    fine_sradius: int = 2
    predict_conf: bool = False


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera predictor hyperparameters."""

    hidden_size: int = 768
    num_heads: int = 8
    mlp_ratio: float = 4.0
    att_depth: int = 4
    trunk_depth: int = 4
    down_size: int = 336
    use_trajectory: bool = True  # trajectory-guided fusion (T_P)
    use_time: bool = True  # temporal reasoning (T_F)
    use_gapr: bool = True  # 3-head uv+d vs single xyz head
    # frozen DINOv2 backbone (dinov2_vitb14_reg)
    backbone_depth: int = 12
    backbone_dim: int = 768
    backbone_heads: int = 12


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-5
    warmup_ratio: float = 0.1
    warmup_lr_init: float = 1e-7
    restart_num: int = 80
    clip_grad: float = 1.0
    weight_trans: float = 1.0
    weight_rot: float = 2.0
    epochs: int = 300
    ckpt_interval: int = 5
    eval_interval: int = 5
    print_interval: int = 50
    eval_print_interval: int = 50
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class CometConfig:
    """Top-level experiment configuration."""

    name: str = "ours"
    seqlen: int = 16
    img_size: int = 512
    track_num: int = 512
    min_track_num: int = 256
    enable_track: bool = True
    enable_pose: bool = True
    fine_tracker: bool = True
    freeze_track: bool = True
    dataset: str = "AMD_eval"  # intrinsics key: spark | AMD | AMD_eval | AMD_test
    data_root: str = "datasets/AMD"
    window_len: int = 8
    compute_dtype: str = "bfloat16"
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    def replace(self, **kw) -> "CometConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class KernelRoute:
    """Which hand-written kernels the forward takes where the JAX package
    has a switch. The defaults are the JAX package's defaults. A route
    changes no parameter: the same state_dict serves every route."""

    fused_block: bool = True
    """``COMET_FUSED_BLOCK``: an AttnBlock over short sequences (L <= 64,
    rows >= 256) runs as one K2 launch; off, it runs unfused and its
    attention goes to K3."""
    fused_cross: bool = False
    """``COMET_FUSED_CROSS``: a CrossAttnBlock with Lq <= 512, Lk <= 1024
    and rows >= 256 runs as one K4 kernel."""
    fused_ln: bool = False
    """``COMET_FUSED_LN``: every LayerNorm (the JAX package's
    FusedLayerNorm) runs as K5."""


# The JAX package's other kernel route: block off, cross on, LayerNorm on.
FUSED_ROUTE = KernelRoute(fused_block=False, fused_cross=True, fused_ln=True)


def _preset(name: str, **camera_kw) -> CometConfig:
    return CometConfig(name=name, camera=CameraConfig(**camera_kw))


PRESETS = {
    "ours": _preset("ours"),
    "abl_all": _preset("abl_all", use_trajectory=False, use_time=False, use_gapr=False),
    "abl_track": _preset("abl_track", use_trajectory=False),
    "abl_time": _preset("abl_time", use_time=False),
    "abl_uvz": _preset("abl_uvz", use_gapr=False),
}


def get_config(name: str = "ours") -> CometConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset '{name}'; available: {sorted(PRESETS)}")
    return PRESETS[name]
