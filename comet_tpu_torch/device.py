"""The device an entry point of the port runs on."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]], what: str) -> torch.device:
    """``device`` as given, else the CUDA card. Without a card the default
    raises rather than fall back to the CPU: the caller passes
    ``device="cpu"`` explicitly to run there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what}: no CUDA device; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)
