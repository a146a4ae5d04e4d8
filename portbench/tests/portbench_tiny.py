"""A tiny configuration and cell for the benchmark's CPU tests: the
published configuration files with every size cut down, the traffic cut to
2 sequences a request."""

from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = {"comet-ours": "ours-infer-b8", "comet-abl_all": "abl_all-infer-b8"}

_TOP = dict(seqlen=2, img_size=64, track_num=8)
_TRACKER = dict(
    coarse_stride=4, coarse_down_ratio=2, coarse_corr_levels=2, coarse_corr_radius=2,
    coarse_latent_dim=16, coarse_hidden_size=32, coarse_depth=2, coarse_iters=2,
    fine_corr_levels=3, fine_corr_radius=2, fine_latent_dim=8, fine_hidden_size=16,
    fine_depth=2, fine_iters=2, fine_pradius=7, fine_sradius=2,
)
_CAMERA = dict(hidden_size=32, num_heads=2, att_depth=1, trunk_depth=1, down_size=28,
               backbone_depth=2, backbone_dim=32, backbone_heads=2)
MIX = dict(batch=2, pool=2, warmup=1, check_among=1, check_requests=1, trace_requests=2)


def tiny_config(name: str = "comet-ours", dtype: str = "float32") -> dict:
    with open(ROOT / "portbench" / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg.update(_TOP, compute_dtype=dtype)
    cfg["tracker"].update(_TRACKER)
    cfg["camera"].update(_CAMERA)
    return cfg


def tiny_cell(name: str = "comet-ours", dtype: str = "float32", root: Path = ROOT):
    from portbench.run import Cell

    cell = Cell(WORKLOADS[name], root=root, cfg=tiny_config(name, dtype))
    cell.mix = dict(cell.mix, **MIX)
    return cell
