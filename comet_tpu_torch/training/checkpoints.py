"""Checkpoints: the epoch-directory convention and auto-resume.

Counterpart of ``comet_tpu/training/checkpoints.py``, itself the reference's
scheme (train_util.py:165-309, 1852-1862; train_e2epose2.py:92-113,
157-163): the whole training state is saved to ``ckpt_{epoch:06d}``
directories, and auto-resume finds the newest by its name.

The format is the port's own, not orbax's: one ``state.pt`` per directory,
written with ``torch.save``, holding a dict of the state's entries, each an
object's ``state_dict()`` (model, optimizer, scheduler, ``RunningStats``) or
a plain value (epoch). A JAX checkpoint cannot be read here, nor this one by
the JAX package; weights cross over as a flax ``.msgpack``
(``utils.serialization.load_params_msgpack``). A model that tensor
parallelism sharded is refused: gather it first.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

_CKPT_RE = re.compile(r"^ckpt_(\d{6})$")
STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str, epoch: int, state: Dict[str, Any]) -> str:
    """Save ``state`` (name -> an object with ``state_dict()``, or a plain
    value) to ``ckpt_dir/ckpt_{epoch:06d}/state.pt``, replacing what is
    there; the file appears whole or not at all. Returns the directory. A
    model that tensor parallelism sharded raises (gather it first)."""
    from ..utils.serialization import check_gathered

    for v in state.values():
        if isinstance(v, torch.nn.Module):
            check_gathered(v)
    path = os.path.join(ckpt_dir, f"ckpt_{epoch:06d}")
    os.makedirs(path, exist_ok=True)
    payload = {k: v.state_dict() if hasattr(v, "state_dict") else v for k, v in state.items()}
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def find_last_checkpoint(ckpt_dir: str) -> Optional[Tuple[int, str]]:
    """The newest ckpt_NNNNNN directory as (epoch, path) (train_util.py:1852-1862)."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m:
            epoch = int(m.group(1))
            if best is None or epoch > best[0]:
                best = (epoch, os.path.join(ckpt_dir, name))
    return best


def restore_checkpoint(path: str, target: Dict[str, Any]) -> Dict[str, Any]:
    """Restore a state saved by :func:`save_checkpoint` into ``target``
    (the same names): an object with ``load_state_dict`` is loaded in place
    (a model or optimizer keeps its device), a plain value is replaced.
    Returns ``target`` with the plain values restored."""
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    missing = sorted(set(target) - set(saved))
    if missing:
        raise KeyError(f"restore_checkpoint: {path} holds no {missing}")
    out = dict(target)
    for k, v in target.items():
        if hasattr(v, "load_state_dict"):
            v.load_state_dict(saved[k])
        else:
            out[k] = saved[k]
    return out


def auto_resume(ckpt_dir: str, target: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
    """Resume from the newest checkpoint if there is one: (the epoch after
    it, the restored state); else (0, ``target`` unchanged)."""
    found = find_last_checkpoint(ckpt_dir)
    if found is None:
        return 0, target
    epoch, path = found
    return epoch + 1, restore_checkpoint(path, target)
