"""Forward entry point: the full model as a function of its parameters.

Counterpart of ``__graft_entry__.py::entry``: ``fn(params, images,
queries)`` is ``torch.func.functional_call`` of the model, and ``params``
holds zeros of every parameter's and buffer's shape, as the JAX entry
builds them; the model itself is built on the meta device and holds no
memory.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .config import CometConfig, KernelRoute, get_config
from .device import resolve_device
from .models import build_comet


def entry(
    cfg: Optional[CometConfig] = None, device=None, route: KernelRoute = KernelRoute(),
) -> Tuple[Callable, Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]]:
    """(fn, (params, images, queries)) for the forward of ``cfg`` (default:
    the full ``ours`` configuration) on ``device`` (the card by default):
    images [1, S, H, W, 3] ~ N(0, 1) and queries [1, N, 2] uniform in the
    image's inner part, from seed 0."""
    device = resolve_device(device, "entry")
    cfg = cfg or get_config("ours")
    model = build_comet(cfg, device="meta", route=route)
    params = {name: torch.zeros(t.shape, dtype=t.dtype, device=device)
              for name, t in (*model.named_parameters(), *model.named_buffers())}
    gen = torch.Generator(device=device).manual_seed(0)
    images = torch.randn(1, cfg.seqlen, cfg.img_size, cfg.img_size, 3, generator=gen,
                         device=device)
    queries = torch.rand(1, cfg.track_num, 2, generator=gen, device=device) * (
        cfg.img_size - 64) + 32

    def fn(params, images, queries):
        return torch.func.functional_call(model, params, (images, queries))

    return fn, (params, images, queries)
