"""Experiment-harness helpers: metric accumulators, timing, host RNG state.

Counterpart of ``comet_tpu/matching/tools.py``, itself glue-factory's
utils/tools.py (the metric classes, Timer, get_class, set_num_threads,
set_seed, fork_rng) and utils/benchmark.py (benchmark_model). The
accumulators keep the reference's semantics (NaN-skipping means, nan-median
and quantile, recall as the fraction strictly below a threshold) and take
tensors (on any device), numpy arrays or numbers, fetched to the host once
per update.

``set_seed`` and ``fork_rng`` manage the host generators that drive data
sampling and fixtures (Python's ``random`` and numpy's), as the JAX
package's do. The port's own random draws take explicit
``torch.Generator``s, so there is no torch generator state to seed here.
"""

from __future__ import annotations

import inspect
import os
import random
import time
from collections.abc import Iterable
from contextlib import contextmanager

import numpy as np
import torch

from .eval_pipeline import AUCMetric, cal_error_auc  # noqa: F401  (re-export)
from .misc import map_tensor
from .viz import _np


def _to_1d(values) -> np.ndarray:
    arr = _np(values, np.float64)
    if arr.ndim == 0:
        arr = arr[None]
    if arr.ndim != 1:
        raise ValueError(f"expected a 1-D batch of values, got shape {arr.shape}")
    return arr


class AverageMetric:
    """A streaming mean that skips NaNs."""

    def __init__(self):
        self._sum = 0.0
        self._num_examples = 0

    def update(self, values):
        arr = _to_1d(values)
        arr = arr[~np.isnan(arr)]
        self._sum += float(arr.sum())
        self._num_examples += arr.size

    def compute(self):
        if self._num_examples == 0:
            return np.nan
        return self._sum / self._num_examples


class FAverageMetric(AverageMetric):
    """:class:`AverageMetric` that also keeps every element."""

    def __init__(self):
        super().__init__()
        self._elements = []

    def update(self, values):
        arr = _to_1d(values)
        self._elements += arr.tolist()
        arr = arr[~np.isnan(arr)]
        self._sum += float(arr.sum())
        self._num_examples += arr.size

    @property
    def elements(self):
        return list(self._elements)


class MedianMetric:
    """The NaN-skipping median of every element seen."""

    def __init__(self):
        self._elements = []

    def update(self, values):
        self._elements += _to_1d(values).tolist()

    def compute(self):
        if not self._elements:
            return np.nan
        return np.nanmedian(self._elements)


class QuantileMetric:
    """The NaN-skipping ``q`` quantile of every element seen."""

    def __init__(self, q: float = 0.05):
        self._elements = []
        self.q = q

    def update(self, values):
        self._elements += _to_1d(values).tolist()

    def compute(self):
        if not self._elements:
            return np.nan
        return np.nanquantile(self._elements, self.q)


class RecallMetric:
    """The fraction of elements strictly below the threshold, or each of
    the thresholds."""

    def __init__(self, ths, elements=None):
        self._elements = list(elements) if elements is not None else []
        self.ths = ths

    def update(self, values):
        self._elements += _to_1d(values).tolist()

    def compute(self):
        if isinstance(self.ths, Iterable):
            return [self._compute_one(th) for th in self.ths]
        return self._compute_one(self.ths)

    def _compute_one(self, th):
        if not self._elements:
            return np.nan
        arr = np.asarray(self._elements)
        return float((arr < th).sum() / arr.size)


class PRMetric:
    """(label, prediction) pairs for a precision-recall analysis;
    ``compute()`` returns the two arrays."""

    def __init__(self):
        self.labels = []
        self.predictions = []

    def update(self, labels, predictions, mask=None):
        labels, predictions = _np(labels), _np(predictions)
        if labels.shape != predictions.shape:
            raise ValueError(f"labels {labels.shape} != predictions {predictions.shape}")
        if mask is not None:
            mask = _np(mask).astype(bool)
            labels, predictions = labels[mask], predictions[mask]
        self.labels += labels.reshape(-1).tolist()
        self.predictions += predictions.reshape(-1).tolist()

    def compute(self):
        return np.array(self.labels), np.array(self.predictions)

    def reset(self):
        self.labels = []
        self.predictions = []


class Timer:
    """``with Timer("x"): ...`` prints "[x] Elapsed: s"; ``duration`` holds
    the wall seconds afterwards."""

    def __init__(self, name=None):
        self.name = name
        self.duration = None

    def __enter__(self):
        self.tstart = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.duration = time.perf_counter() - self.tstart
        if self.name is not None:
            print(f"[{self.name}] Elapsed: {self.duration}")


def _sync(out) -> None:
    """Wait for the card where ``out`` holds a CUDA tensor."""
    devices = set()
    map_tensor(out, lambda x: devices.add(x.device)
               if isinstance(x, torch.Tensor) and x.is_cuda else None)
    for device in devices:
        torch.cuda.synchronize(device)


def benchmark_model(fn, data, r: int = 100, warmup: int = 10) -> dict:
    """{"mean": ms, "std": ms} over ``r`` timed calls of ``fn(data)`` after
    ``warmup`` untimed ones, each call timed on the host clock to the end
    of its work: a synchronize where its output holds CUDA tensors, nothing
    more on the CPU. Each time is the launches, the device's work and the
    wait."""
    for _ in range(warmup):
        _sync(fn(data))
    timings = np.zeros((r,))
    for rep in range(r):
        start = time.perf_counter()
        _sync(fn(data))
        timings[rep] = (time.perf_counter() - start) * 1e3
    return {"mean": float(timings.sum() / r), "std": float(np.std(timings))}


def get_class(mod_path: str, base_class):
    """The one subclass of ``base_class`` defined in module ``mod_path``."""
    mod = __import__(mod_path, fromlist=[""])
    classes = [c for _, c in inspect.getmembers(mod, inspect.isclass)
               if c.__module__ == mod_path and issubclass(c, base_class)]
    if len(classes) != 1:
        raise ValueError(f"{mod_path} defines {len(classes)} {base_class} classes")
    return classes[0]


def set_num_threads(nt: int):
    """Cap the host's BLAS and OpenMP thread pools: the environment
    variables the JAX package sets, and torch's intra-op pool."""
    for var in ("OPENBLAS_NUM_THREADS", "NUMEXPR_NUM_THREADS", "OMP_NUM_THREADS",
                "MKL_NUM_THREADS"):
        os.environ[var] = str(nt)
    torch.set_num_threads(nt)


def set_seed(seed: int):
    """Seed the host generators: Python's ``random`` and numpy's."""
    random.seed(seed)
    np.random.seed(seed)


def get_random_state():
    return np.random.get_state(), random.getstate()


def set_random_state(state):
    np_state, py_state = state
    np.random.set_state(np_state)
    random.setstate(py_state)


@contextmanager
def fork_rng(seed=None):
    """Run a block under its own host RNG state, restored afterwards."""
    state = get_random_state()
    if seed is not None:
        set_seed(seed)
    try:
        yield
    finally:
        set_random_state(state)
