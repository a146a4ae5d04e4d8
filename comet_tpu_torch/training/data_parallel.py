"""Batched eval on one device: stacking samples, and the asynchronous metric
fetch.

Counterpart of the eval half of ``comet_tpu/training/data_parallel.py``
(``stack_camera_sets``, ``build_batch``, ``start_metric_fetch``,
``batch_metrics``). The mesh helpers come with the distributed slice.

The metric fetch is asynchronous: :func:`start_metric_fetch` queues the
copies of the few tensors the metric block reads into pinned host buffers
and records a CUDA event, so a caller that dispatches the next step before
reading them hides the copies behind the card's work; :meth:`MetricFetch.wait`
waits on that event only, not on the whole device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.datasets import SequenceSample
from ..data.device_pipeline import wait_ready
from ..geometry.cameras import CameraSet
from .loop import METRIC_FETCH_KEYS, make_gt_cameras, metric_block


def stack_camera_sets(cams: Sequence[CameraSet], device=None) -> CameraSet:
    """[CameraSet([S, ...])] * B -> CameraSet([B, S, ...]) of tensors on
    ``device`` (ratio -> [B])."""
    return CameraSet(*(torch.as_tensor(np.stack([np.asarray(f) for f in fields]), device=device)
                       for fields in zip(*cams)))


def build_batch(
    samples: Sequence[SequenceSample],
    queries: Sequence[np.ndarray],
    device,
) -> Tuple[torch.Tensor, torch.Tensor, CameraSet, List[CameraSet]]:
    """Stack host samples into one batch on ``device``.

    Returns (images [B,S,H,W,3], queries [B,N,2], batched gt CameraSet,
    per-sample gt CameraSets with numpy leaves for the host metric block).
    Images already on the card (``DevicePreprocessDataset`` with
    ``keep_on_device``) stack there, after their stream's event, and never
    pass through the host."""
    for s in samples:
        wait_ready(s)
    if all(isinstance(s.images, torch.Tensor) for s in samples):
        images = torch.stack([s.images.to(device) for s in samples])
    else:
        images = torch.as_tensor(np.stack([np.asarray(s.images) for s in samples]), device=device)
    q = torch.as_tensor(np.stack(queries), device=device)
    gt_list = [make_gt_cameras(s) for s in samples]
    return images, q, stack_camera_sets(gt_list, device), gt_list


class MetricFetch:
    """The metric keys of one step on their way to the host: ``host`` holds
    the tensors (pinned buffers being filled on the card's stream, or the
    step's own CPU tensors), ``ready`` the CUDA event after the copies
    (None on the CPU)."""

    def __init__(self, host: Dict[str, torch.Tensor], ready: Optional[torch.cuda.Event]):
        self.host = host
        self.ready = ready

    def wait(self) -> Dict[str, np.ndarray]:
        """The keys as numpy arrays, once their copies are done."""
        if self.ready is not None:
            self.ready.synchronize()
        return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                for k, v in self.host.items()}


def start_metric_fetch(aux: Dict[str, torch.Tensor]) -> MetricFetch:
    """Begin the device-to-host copy of the ``METRIC_FETCH_KEYS`` of a step's
    output without blocking: each copies ``non_blocking`` into a pinned host
    buffer on the current stream, then one event is recorded."""
    out = {k: aux[k].detach() for k in METRIC_FETCH_KEYS if k in aux}
    on_card = [v for v in out.values() if v.device.type == "cuda"]
    if not on_card:
        return MetricFetch(out, None)
    host = {}
    for k, v in out.items():
        if v.device.type == "cuda":
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
        else:
            host[k] = v
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(on_card[0].device))
    return MetricFetch(host, ready)


def batch_metrics(
    fetch: MetricFetch, gt_list: Sequence[CameraSet],
    seq_names: Optional[Sequence[str]] = None,
) -> List[Dict[str, float]]:
    """Per-sample host metric rows from a batched step's fetched metrics.

    Pairwise metrics must not mix frames across sequences, so the batch is
    sliced per sample before the float64 metric block. ``seq_names`` adds
    the per-scene AUC keys."""
    aux = fetch.wait()
    rows = []
    for b, gt in enumerate(gt_list):
        sample_out = {k: (v[b] if v.ndim >= 2 else v) for k, v in aux.items()}
        name = seq_names[b] if seq_names else ""
        rows.append(metric_block(sample_out, gt, name))
    return rows
