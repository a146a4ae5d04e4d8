"""Experiment checkpoints of the matching stack: the read side.

Counterpart of the readers of ``comet_tpu/matching/experiments.py``
(gluefactory/utils/experiments.py:22-91): an experiment directory holds
``checkpoint_<step>.msgpack`` files (a flax msgpack tree ``{"params",
"opt"}``) with JSON sidecars (conf, step, loss, eval) and a
``checkpoint_best`` copy. The port reads the JAX package's files with its
own msgpack decoder (no flax). Writing checkpoints comes with matcher
training (ROADMAP Queue 1 item 7a).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Tuple

from ..utils.serialization import read_msgpack

_CKPT_RE = re.compile(r"^checkpoint_(\d+)\.msgpack$")
BEST_NAME = "checkpoint_best.msgpack"


def _sidecar(path: str) -> str:
    return path[: -len(".msgpack")] + ".json"


def list_checkpoints(exp_dir: str) -> List[Tuple[int, str]]:
    """Every numbered checkpoint of an experiment directory, (step, path),
    unsorted."""
    if not os.path.isdir(exp_dir):
        return []
    out = []
    for name in os.listdir(exp_dir):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(exp_dir, name)))
    return out


def get_last_checkpoint(exp_dir: str) -> str:
    """Path of the highest-step checkpoint."""
    ckpts = list_checkpoints(exp_dir)
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints under {exp_dir}")
    return sorted(ckpts)[-1][1]


def get_best_checkpoint(exp_dir: str) -> str:
    """Path of the best-eval checkpoint copy."""
    return os.path.join(exp_dir, BEST_NAME)


def load_checkpoint(path_or_dir: str, get_last: bool = False) -> Tuple[Dict[str, Any], Dict]:
    """(tree, meta) of a checkpoint file, or of an experiment directory's
    ``checkpoint_best`` (the last numbered one with ``get_last``, or where
    no best exists). The tree is the raw msgpack dict tree (numpy leaves),
    as the JAX package returns it without a template."""
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        path = get_last_checkpoint(path_or_dir) if get_last else get_best_checkpoint(path_or_dir)
        if not os.path.exists(path):  # no best yet: the last
            path = get_last_checkpoint(path_or_dir)
    tree = read_msgpack(path)
    meta = {}
    if os.path.exists(_sidecar(path)):
        with open(_sidecar(path)) as f:
            meta = json.load(f)
    return tree, meta


def load_experiment_into_pipeline(pipeline, path_or_dir: str) -> Dict:
    """Put a trained matcher checkpoint into a built pipeline whose matcher
    is a ``configs.MatcherWrapper``: its next call builds the matcher from
    those weights. Returns the checkpoint's meta."""
    holder = getattr(pipeline.matcher, "holder", None)
    if holder is None:
        raise TypeError("pipeline matcher is not a wrapped matcher module; "
                        "only trainable matchers load experiment checkpoints")
    tree, meta = load_checkpoint(path_or_dir)
    holder["params"] = tree["params"] if "params" in tree else tree
    return meta
