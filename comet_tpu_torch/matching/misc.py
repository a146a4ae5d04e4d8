"""Batch plumbing for multi-view prediction dicts.

Counterpart of ``comet_tpu/matching/misc.py``, itself glue-factory's
utils/tensor.py (map_tensor, batch_to_numpy, rbd, index_batch) and
utils/misc.py (to_view, get_view, get_twoview, stack_twoviews,
unstack_twoviews). Leaves are tensors or numpy arrays; ``batch_to_device``
moves every tensor to the device it is given.

The view-suffix convention: per-view keys end in a digit ("keypoints0"),
pairwise keys in "ItoJ" ("matches0to1"); these helpers re-index them so an
N-view batch feeds two-view models (``TripletPipeline`` runs one matcher
over the 0to1, 0to2 and 1to2 pairs in one batched call).
"""

from __future__ import annotations

import numpy as np
import torch

from .viz import _np

__all__ = [
    "map_tensor",
    "batch_to_numpy",
    "batch_to_device",
    "rbd",
    "index_batch",
    "to_view",
    "get_view",
    "get_twoview",
    "stack_twoviews",
    "unstack_twoviews",
]


def map_tensor(input_, func):
    """``func`` of every leaf of a nested dict, list or tuple; strings,
    bytes and None pass through."""
    if isinstance(input_, (str, bytes)):
        return input_
    if isinstance(input_, dict):
        return {k: map_tensor(v, func) for k, v in input_.items()}
    if isinstance(input_, (list, tuple)):
        return type(input_)(map_tensor(v, func) for v in input_)
    if input_ is None:
        return None
    return func(input_)


def batch_to_numpy(batch):
    """Every leaf as a host numpy array."""
    return map_tensor(batch, _np)


def batch_to_device(batch, device, non_blocking: bool = False):
    """Every leaf as a tensor on ``device`` (numpy arrays and numbers
    become tensors first); there is no default device."""
    device = torch.device(device)

    def move(a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
        return t.to(device, non_blocking=non_blocking)

    return map_tensor(batch, move)


def rbd(data: dict) -> dict:
    """The leading batch dimension removed from tensor, array and list
    values."""
    return {k: v[0] if isinstance(v, (np.ndarray, torch.Tensor, list)) else v
            for k, v in data.items()}


def index_batch(tensor_dict):
    """Each example of a batched dict, one after another."""
    batch_size = len(next(iter(tensor_dict.values())))
    for i in range(batch_size):
        yield map_tensor(tensor_dict, lambda t: t[i])


def to_view(data: dict, i) -> dict:
    """Every key suffixed with view index ``i``."""
    return {k + str(i): v for k, v in data.items()}


def get_view(data: dict, i) -> dict:
    """View ``i``: the global keys and view i's keys without their suffix."""
    i = str(i)
    data_g = {k: v for k, v in data.items() if not k[-1].isnumeric()}
    data_i = {k[:-1]: v for k, v in data.items() if k[-1] == i}
    return {**data_g, **data_i}


def get_twoview(data: dict, idx: str) -> dict:
    """An N-view dict as the two-view dict of the pair ``idx`` == "LtoR":
    pairwise LtoR keys become 0to1 (RtoL 1to0), view L's keys *0, view R's
    *1."""
    li, ri = idx[0], idx[-1]
    if idx != f"{li}to{ri}":
        raise ValueError(f"expected 'LtoR' pair index, got {idx!r}")
    data_lr = {k[:-4] + "0to1": v for k, v in data.items() if k[-4:] == f"{li}to{ri}"}
    data_rl = {k[:-4] + "1to0": v for k, v in data.items() if k[-4:] == f"{ri}to{li}"}
    data_l = {k[:-1] + "0": v for k, v in data.items() if k[-1:] == li and k[-3:-1] != "to"}
    data_r = {k[:-1] + "1": v for k, v in data.items() if k[-1:] == ri and k[-3:-1] != "to"}
    return {**data_lr, **data_rl, **data_l, **data_r}


def _concat(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.cat([torch.as_tensor(a), torch.as_tensor(b)], 0)
    return np.concatenate([np.asarray(a), np.asarray(b)], axis=0)


def stack_twoviews(data: dict, indices=("0to1", "0to2", "1to2")) -> dict:
    """The given pairs concatenated along the batch axis, so that one
    two-view model call serves them all (tensors stay tensors)."""
    idx0 = indices[0]
    m_data = dict(data[idx0]) if idx0 in data else get_twoview(data, idx0)
    for idx in indices[1:]:
        data_i = data[idx] if idx in data else get_twoview(data, idx)
        for k, v in data_i.items():
            m_data[k] = _concat(m_data[k], v)
    return m_data


def unstack_twoviews(data: dict, batch_size: int, indices=("0to1", "0to2", "1to2")) -> dict:
    """The inverse of :func:`stack_twoviews`."""
    return {idx: {k: v[i * batch_size: (i + 1) * batch_size] for k, v in data.items()}
            for i, idx in enumerate(indices)}
