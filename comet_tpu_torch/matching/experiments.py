"""Experiment checkpoints of the matching stack.

Counterpart of ``comet_tpu/matching/experiments.py``
(gluefactory/utils/experiments.py:22-140): an experiment directory holds
``checkpoint_<step>.msgpack`` files (a flax msgpack tree ``{"params",
"opt"}``) with JSON sidecars (conf, step, loss, eval) and a
``checkpoint_best`` copy. Both packages read and write the same files: the
port with its own msgpack encoder and decoder (no flax). ``params`` is the
matcher's flax variables (``weights.module_params_to_jax``) and ``opt`` the
state of ``optax.adam``: ``{"0": {"count", "mu", "nu"}, "1": {}}``, mu and nu
in the parameters' tree. :func:`adam_state_to_jax` and
:func:`adam_state_from_jax` carry it into and out of ``torch.optim.Adam``
(``count``: every parameter's ``step``; ``mu``: ``exp_avg``; ``nu``:
``exp_avg_sq``), which takes optax's step.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..utils.serialization import msgpack_serialize, read_msgpack

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


def delete_old_checkpoints(exp_dir: str, num_keep: int) -> None:
    """Keep only the ``num_keep`` newest numbered checkpoints (and their
    sidecars); ``checkpoint_best`` is never deleted."""
    for _, path in sorted(list_checkpoints(exp_dir))[::-1][num_keep:]:
        os.unlink(path)
        if os.path.exists(_sidecar(path)):
            os.unlink(_sidecar(path))


def save_experiment(
    exp_dir: str,
    step: int,
    params: Mapping,
    opt_state: Optional[Mapping] = None,
    conf: Optional[Dict] = None,
    loss: Optional[float] = None,
    eval_metric: Optional[float] = None,
    best_eval: Optional[float] = None,
    num_keep: int = 5,
) -> Tuple[str, float]:
    """Write ``checkpoint_{step:08d}.msgpack`` (the flax trees ``params`` and
    ``opt_state``) and its JSON sidecar, copy both to ``checkpoint_best``
    when ``eval_metric`` (else ``loss``) is below ``best_eval`` (smaller is
    better), and keep the ``num_keep`` newest checkpoints. Returns (path,
    the best value so far, inf if none)."""
    os.makedirs(exp_dir, exist_ok=True)
    path = os.path.join(exp_dir, f"checkpoint_{step:08d}.msgpack")
    tree = {"params": params}
    if opt_state is not None:
        tree["opt"] = opt_state
    with open(path, "wb") as f:
        f.write(msgpack_serialize(tree))
    meta = {
        "step": int(step),
        "conf": conf,
        "loss": None if loss is None else float(loss),
        "eval": None if eval_metric is None else float(eval_metric),
    }
    with open(_sidecar(path), "w") as f:
        json.dump(meta, f)
    new_best = best_eval
    metric = eval_metric if eval_metric is not None else loss
    if metric is not None and (best_eval is None or metric < best_eval):
        shutil.copyfile(path, os.path.join(exp_dir, BEST_NAME))
        shutil.copyfile(_sidecar(path), _sidecar(get_best_checkpoint(exp_dir)))
        new_best = float(metric)
    delete_old_checkpoints(exp_dir, num_keep)
    return path, (float("inf") if new_best is None else new_best)


def adam_state_to_jax(optimizer: torch.optim.Optimizer, module: torch.nn.Module) -> Dict:
    """``torch.optim.Adam``'s state over ``module``'s parameters as
    ``optax.adam``'s flax tree: ``{"0": {"count": int32 [], "mu": ..., "nu":
    ...}, "1": {}}`` (zeros before the first step)."""
    from ..weights import module_params_to_jax

    params = dict(module.named_parameters())
    count = 0
    mu, nu = {}, {}
    for name, p in params.items():
        st = optimizer.state.get(p, {})
        count = max(count, int(st["step"]) if "step" in st else 0)
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
    return {"0": {"count": np.array(count, np.int32),
                  "mu": module_params_to_jax(module, mu),
                  "nu": module_params_to_jax(module, nu)},
            "1": {}}


def adam_state_from_jax(tree: Mapping, optimizer: torch.optim.Optimizer,
                        module: torch.nn.Module) -> int:
    """Put ``optax.adam``'s state (the ``"opt"`` tree of a checkpoint) into
    ``optimizer``, an Adam over ``module``'s parameters; returns its count."""
    from ..weights import module_params_from_jax

    state = tree["0"]
    count = int(np.asarray(state["count"]))
    mu = module_params_from_jax(state["mu"], module)
    nu = module_params_from_jax(state["nu"], module)
    for name, p in module.named_parameters():
        optimizer.state[p] = {} if count == 0 else {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[name].to(p.device, p.dtype).clone(),
            "exp_avg_sq": nu[name].to(p.device, p.dtype).clone(),
        }
    return count


def load_checkpoint(path_or_dir: str, get_last: bool = False) -> Tuple[Dict[str, Any], Dict]:
    """(tree, meta) of a checkpoint file, or of an experiment directory's
    ``checkpoint_best`` (the last numbered one with ``get_last``, or where
    no best exists). The tree is the raw msgpack dict tree (numpy leaves),
    as the JAX package returns it without a template: ``tree["params"]``
    loads into the matcher through ``weights.module_params_from_jax`` and
    ``tree["opt"]`` into its Adam through :func:`adam_state_from_jax`."""
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
