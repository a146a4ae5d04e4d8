"""The one traffic generator. A mix is a data file under ``traffic/``; its
``mode`` names the loop that drives it (``portbench/modes.py``), and every
other key is a parameter of that loop.

``infer_closed``: one client sends a request, waits until its outputs are
on the host, and sends the next. A request is ``batch`` sequences of the
configuration's ``seqlen`` frames of ``img_size``² × 3 standard normal
pixels (already normalized, as the model takes them) with ``track_num``
query points each, uniform in [``query_margin``, img_size −
``query_margin``]. ``pool`` distinct requests are drawn on the device from
the seed before the window and sent in turn; ``warmup`` of them in set-up.
The check judges ``check_requests`` drawn from the seed among the window's
first ``check_among``; a traced run profiles the first ``trace_requests``.

``train_closed``: train steps back to back, ``batch`` sequences each, fresh
images every step, queries (the same margin) and ground-truth cameras drawn
once, sequence b's image-plane motion at ``gt_uv_px[b]`` pixels (so the
sequences weigh unlike in the loss); the schedule counts
``steps_per_epoch`` steps an epoch.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Tuple

import torch

def load(path: Path) -> dict:
    from .modes import MODES

    with open(path) as f:
        mix = json.load(f)
    if mix.get("mode") not in MODES:
        raise ValueError(f"{path}: mode {mix.get('mode')!r} is none of {sorted(MODES)}")
    return mix


def inference_pool(mix: dict, cfg: dict, gen: torch.Generator, device) -> List[Tuple]:
    """``mix["pool"]`` requests (images [B, S, H, W, 3], queries [B, N, 2])."""
    b, s, hw, n = mix["batch"], cfg["seqlen"], cfg["img_size"], cfg["track_num"]
    m = mix["query_margin"]
    pool = []
    for _ in range(mix["pool"]):
        images = torch.randn((b, s, hw, hw, 3), generator=gen, device=device)
        queries = torch.rand((b, n, 2), generator=gen, device=device) * (hw - 2 * m) + m
        pool.append((images, queries))
    return pool
