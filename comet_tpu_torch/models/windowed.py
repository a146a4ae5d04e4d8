"""Sliding-window long-sequence inference with pose chaining.

Counterpart of ``comet_tpu/models/windowed.py``: windows of ``window_len``
frames with stride ``window_len // 2`` and a mirror-padded tail, one model
call per window, and pose composition through the uvz codec so that every
window's frame-0-relative encodings chain into one global trajectory.
Each window's track queries are seeded from the previous window's tracks
at its start frame (the reference's overlap initialization,
E2Epose2.py:338-375).

Teacher forcing (``TeacherForcingScheduler``, E2Epose2.py:40-56) is a host
decision: in training the chain's anchor is the ground-truth pose with
probability ``ratio(epoch)``, the model's own stitched estimate otherwise.

Two forms compute the same numbers: :func:`windowed_forward`, the host loop
and semantic reference, and :func:`windowed_forward_scan`, the counterpart
of JAX's ``lax.scan`` form, which keeps the schedule static and its carry
on the device and never waits for the device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..geometry.quaternions import quat_multiply

IDENTITY_ENC = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)

ApplyFn = Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]


class TeacherForcingScheduler:
    """Linear ratio decay start -> end over ``transition_epochs``
    (E2Epose2.py:40-56); the decisions come from a numpy Generator, so a
    seed gives the JAX package's decisions."""

    def __init__(self, start_ratio=1.0, end_ratio=0.2, transition_epochs=300):
        self.start_ratio = start_ratio
        self.end_ratio = end_ratio
        self.transition_epochs = transition_epochs

    def ratio(self, epoch: int) -> float:
        if epoch >= self.transition_epochs:
            return self.end_ratio
        return self.start_ratio - (self.start_ratio - self.end_ratio) * (
            epoch / self.transition_epochs
        )

    def use_teacher_forcing(self, epoch: int, rng: np.random.Generator) -> bool:
        return bool(rng.random() < self.ratio(epoch))


def window_schedule(total: int, window_len: int) -> List[np.ndarray]:
    """Frame-index windows of length window_len, stride window_len // 2, the
    tail mirror-padded (E2Epose2.py:305-316 padding semantics)."""
    step = max(window_len // 2, 1)
    starts = list(range(0, max(total - window_len, 0) + 1, step))
    if not starts:
        starts = [0]
    if starts[-1] + window_len < total:
        starts.append(total - window_len)
    windows = []
    for s in starts:
        idx = np.arange(s, s + window_len)
        over = idx >= total  # mirror-pad past the end
        windows.append(np.where(over, 2 * (total - 1) - idx, idx))
    return windows


def compose_uvz_encodings(
    enc_anchor: torch.Tensor,  # [7] the anchor frame's global encoding (rel frame 0)
    enc_window: torch.Tensor,  # [W, 7] the window's encodings (rel its frame 0)
    ratio,
) -> torch.Tensor:
    """Chain window-relative uvz encodings onto a global anchor: du and dv
    add, dd multiplies in (dd / ratio + 1), and the quaternions compose as
    q_global = q_window * q_anchor."""
    du = enc_window[:, 0] + enc_anchor[0]
    dv = enc_window[:, 1] + enc_anchor[1]
    dd = ratio * ((enc_window[:, 2] / ratio + 1.0) * (enc_anchor[2] / ratio + 1.0) - 1.0)
    q = quat_multiply(enc_window[:, 3:7], enc_anchor[3:7].expand_as(enc_window[:, 3:7]))
    return torch.cat([torch.stack([du, dv, dd], -1), q], dim=-1)


def windowed_forward(
    apply_fn: ApplyFn,  # (images [1, W, H, Wd, 3], queries [1, N, 2]) -> dict
    images: torch.Tensor,  # [1, T, H, W, 3]
    queries: torch.Tensor,  # [1, N, 2] frame-0 query points
    window_len: int,
    ratio,
    gt_enc: Optional[torch.Tensor] = None,  # [T, >= 7] for teacher forcing
    teacher_force: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """COMET over a sequence of any length, window by window on the host.

    Returns (pred_pose_enc [1, T, 7], global frame-0-relative encodings;
    pred_tracks [1, T, N, 2]). One stitching policy for poses and tracks:
    a later window refines the frames it shares with an earlier one, and a
    window's frame 0 never overwrites an estimate (its pose is the identity
    relative to itself, its track the seeded query)."""
    t_total, n = images.shape[1], queries.shape[1]
    windows = window_schedule(t_total, window_len)
    identity = torch.tensor(IDENTITY_ENC, dtype=torch.float32, device=images.device)
    global_enc: List[Optional[torch.Tensor]] = [None] * t_total
    global_tracks: List[Optional[torch.Tensor]] = [None] * t_total
    global_enc[0] = identity
    global_tracks[0] = queries[0]

    win_queries = queries
    for w_idx, idx in enumerate(windows):
        out = apply_fn(images[:, torch.as_tensor(idx, device=images.device)], win_queries)
        enc_w = out["pred_pose_enc"][0].float()  # [W, 7] rel window frame 0
        tracks_w = out.get("pred_track")
        anchor_frame = int(idx[0])
        if teacher_force and gt_enc is not None:
            anchor = gt_enc[anchor_frame, :7].float()
        else:
            anchor = identity if anchor_frame == 0 else global_enc[anchor_frame]
        enc_global = compose_uvz_encodings(anchor, enc_w, ratio)

        for j, frame in enumerate(idx):
            f = int(frame)
            if j > 0 or global_enc[f] is None:
                global_enc[f] = enc_global[j]
            if tracks_w is not None and (j > 0 or global_tracks[f] is None):
                global_tracks[f] = tracks_w[0, j].float()

        # seed the next window's queries from this window's tracks at the
        # next window's start (overlap initialization)
        if tracks_w is not None and w_idx + 1 < len(windows):
            here = [int(i) for i in idx]
            next_start = int(windows[w_idx + 1][0])
            if next_start in here:
                win_queries = tracks_w[:, here.index(next_start)]

    zeros = queries.new_zeros((n, 2), dtype=torch.float32)
    enc = torch.stack([e if e is not None else identity for e in global_enc])
    trk = torch.stack([t.float() if t is not None else zeros for t in global_tracks])
    return enc[None], trk[None]


def windowed_forward_scan(
    apply_fn: ApplyFn,  # (images [1, W, H, Wd, 3], queries [1, N, 2]) -> dict
    images: torch.Tensor,  # [1, T, H, W, 3]
    queries: torch.Tensor,  # [1, N, 2] frame-0 query points
    window_len: int,
    ratio,
    gt_enc: Optional[torch.Tensor] = None,  # [T, >= 7] for teacher forcing
    teacher_force: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The counterpart of JAX's ``lax.scan`` form: the same numbers as
    :func:`windowed_forward`, with the schedule fixed on the host before the
    first window and the carry (stitched encodings, tracks, seeded queries)
    on the device. Nothing here waits for the device: no ``.item()``, no
    tensor read on the host, no index tensor copied from the host.

    Two reformulations, as in JAX, give the same numbers: every window
    scatters all its frames (the model pins a window's frame 0 to the
    identity pose and to the seeded query, so that write repeats the value
    already stored, up to the rounding of composing the anchor with the
    identity), and the next window's queries are read at the precomputed
    position ``j_next``. The scatters are out of place, so a loss on a late
    window's frames differentiates back through the chained anchors.

    A window longer than the sequence holds mirror-padded duplicate frames,
    whose scatter order JAX leaves undefined; this form raises there, and
    :func:`windowed_forward` serves that case."""
    t_total, n = images.shape[1], queries.shape[1]
    windows = window_schedule(t_total, window_len)
    starts = [int(w[0]) for w in windows]
    if any(not np.array_equal(w, np.arange(s, s + window_len)) for s, w in zip(starts, windows)):
        raise ValueError(
            f"windowed_forward_scan: a window of {window_len} frames over a sequence of "
            f"{t_total} repeats frames; use windowed_forward for that case")
    # j_next[w]: the position of window w+1's start inside window w (-1: keep)
    j_next = [starts[w + 1] - starts[w] if w + 1 < len(windows)
              and starts[w + 1] - starts[w] < window_len else -1 for w in range(len(windows))]

    dev = images.device
    enc_out = torch.zeros((t_total, 7), dtype=torch.float32, device=dev)
    enc_out[0, 3].fill_(1.0)  # frame 0: the identity (a fill: no copy from the host)
    trk_out = torch.zeros((t_total, n, 2), dtype=torch.float32, device=dev)
    gt_arr = gt_enc[:, :7].float() if (teacher_force and gt_enc is not None) else None
    win_q = queries
    for s, jn in zip(starts, j_next):
        idx = torch.arange(s, s + window_len, device=dev)
        out = apply_fn(images[:, s:s + window_len], win_q)
        enc_w = out["pred_pose_enc"][0].float()  # [L, 7]
        tracks_w = out["pred_track"].float()  # [1, L, N, 2]
        anchor = gt_arr[s] if gt_arr is not None else enc_out[s]
        enc_out = enc_out.index_copy(0, idx, compose_uvz_encodings(anchor, enc_w, ratio))
        trk_out = trk_out.index_copy(0, idx, tracks_w[0])
        keep = torch.full((), jn >= 0, dtype=torch.bool, device=dev)
        win_q = torch.where(keep, tracks_w[:, max(jn, 0)], win_q)
    return enc_out[None], trk_out[None]
