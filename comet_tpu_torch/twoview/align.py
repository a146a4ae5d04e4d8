"""Camera and trajectory alignment, rotation averaging, and the orderings
that choose query frames.

Counterpart of ``comet_tpu/twoview/align.py`` (the reference's
comet/utils/align.py:109,145 and comet/utils/utils.py:25-332).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.quaternions import (
    matrix_to_quat,
    quat_invert,
    quat_multiply,
    quat_to_matrix,
)


class SimilarityTransform(NamedTuple):
    r: torch.Tensor  # [3, 3]
    t: torch.Tensor  # [3]
    s: torch.Tensor  # []


def corresponding_points_alignment(x: torch.Tensor, y: torch.Tensor, estimate_scale: bool = True,
                                   eps: float = 1e-9) -> SimilarityTransform:
    """Umeyama alignment: (R, t, s) minimizing ||s x R + t - y||^2, in the
    row-vector convention (x @ R) of PyTorch3D's
    corresponding_points_alignment used by align.py:109."""
    n = x.shape[0]
    mu_x = x.mean(dim=0)
    mu_y = y.mean(dim=0)
    xc = x - mu_x
    yc = y - mu_y
    cov = xc.T @ yc / n
    u, s_vals, vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
    diag = torch.cat([torch.ones(2, dtype=x.dtype, device=x.device), d[None]])
    # the column-vector rotation taking x to y is V diag U^T; the row
    # convention applies its transpose as x @ R
    r = (u * diag[None, :]) @ vt
    var_x = (xc ** 2).sum() / n
    if estimate_scale:
        scale = (s_vals * diag).sum() / var_x.clamp_min(eps)
    else:
        scale = torch.ones((), dtype=x.dtype, device=x.device)
    t = mu_y - scale * mu_x @ r
    return SimilarityTransform(r=r, t=t, s=scale)


def align_camera_extrinsics(r_src: torch.Tensor, t_src: torch.Tensor, r_tgt: torch.Tensor,
                            t_tgt: torch.Tensor, estimate_scale: bool = True
                            ) -> Tuple[SimilarityTransform, torch.Tensor, torch.Tensor]:
    """Align two camera trajectories ([S, 3, 3], [S, 3]) by their optical
    centers (align.py:145 capability). Returns the similarity and the
    transformed (R, T) of the source cameras."""
    # centers for the row convention x_cam = x @ R + T: C = -T R^T
    c_src = -torch.einsum("sj,sij->si", t_src, r_src)
    c_tgt = -torch.einsum("sj,sij->si", t_tgt, r_tgt)
    sim = corresponding_points_alignment(c_src, c_tgt, estimate_scale)
    # x_cam = (s x R_sim + t) @ R_src + T_src = s x (R_sim R_src) + (t @ R_src + T_src)
    r_new = torch.einsum("ij,sjk->sik", sim.r, r_src)
    t_new = torch.einsum("j,sjk->sk", sim.t, r_src) + t_src
    return sim, r_new, t_new


def rotation_average(quats: torch.Tensor) -> torch.Tensor:
    """Chordal-L2 rotation averaging: the principal eigenvector of the
    outer-product accumulator (comet/utils/utils.py:25 capability)."""
    q = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    m = torch.einsum("ni,nj->ij", q, q)
    avg = torch.linalg.eigh(m).eigenvectors[:, -1]
    return avg * torch.sign(avg[0] + 1e-12)


def relative_to_first(q: torch.Tensor, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A trajectory relative to its first camera (comet/utils/utils.py:136,190)."""
    return quat_multiply(q, quat_invert(q[0:1])), t - t[0:1]


def average_batch_rotations(rmats: torch.Tensor) -> torch.Tensor:
    """Average B predictions of N rotations (comet/utils/utils.py:136-164):
    to quaternions, each aligned to the hemisphere of the first prediction
    (the reference averages antipodal representations to ~zero where signs
    differ), the mean over the batch, renormalized, back to matrices.

    rmats: [B, N, 3, 3] -> [N, 3, 3]."""
    q = matrix_to_quat(rmats.reshape(-1, 3, 3)).reshape(rmats.shape[0], rmats.shape[1], 4)
    sign = torch.sign(torch.sum(q * q[0:1], dim=-1, keepdim=True) + 1e-12)
    mean = torch.mean(q * sign, dim=0)
    mean = mean / torch.linalg.norm(mean, dim=-1, keepdim=True)
    return quat_to_matrix(mean)


def average_query_predictions(predict_fn, num_frames: int, query_indices=None, rng=None,
                              repeat_times: int = 5, device=None):
    """Multi-query camera-prediction averaging (comet/utils/utils.py:25-127
    average_camera_prediction): run the predictor with several frames
    placed first, undo each reordering, re-express every estimate relative
    to the true first frame, and average: rotations on SO(3), translations
    and focals arithmetically.

    predict_fn(order [S] int64) -> (r [S, 3, 3], t [S, 3], focal [S, ...])
    for the frames in that order. The orders live on ``device`` (the card
    by default). Returns (r_avg [S, 3, 3], t_avg, focal_avg, query_indices)."""
    if query_indices is None:
        rng = rng or np.random.default_rng(0)
        repeat_times = min(repeat_times, num_frames)
        query_indices = list(rng.choice(num_frames, size=repeat_times, replace=False))
        if 0 not in query_indices:
            query_indices.insert(0, 0)
    rs, ts, fs = [], [], []
    for qi in query_indices:
        order = calculate_index_mappings(int(qi), num_frames, device=device)
        r, t, focal = predict_fn(order)
        # the swap is an involution: the order is its own inverse
        r, t, focal = switch_tensor_order([r, t, focal], order, axis=0)
        # relative to the true first frame (utils.py:88-97)
        r0, t0 = r[0], t[0]
        r_rel = torch.einsum("nij,kj->nik", r, r0)  # R_n R_0^T
        rs.append(r_rel)
        ts.append(t - torch.einsum("nij,j->ni", r_rel, t0))
        fs.append(focal)
    r_avg = average_batch_rotations(torch.stack(rs))
    return (r_avg, torch.stack(ts).mean(dim=0), torch.stack(fs).mean(dim=0),
            list(map(int, query_indices)))


def farthest_point_sample(points: torch.Tensor, k: int) -> torch.Tensor:
    """Greedy farthest-point sampling of k indices (comet/utils/utils.py:204)."""
    d2 = torch.full(points.shape[:1], torch.inf, dtype=points.dtype, device=points.device)
    last = torch.zeros((), dtype=torch.int64, device=points.device)
    picked = []
    for _ in range(k):
        picked.append(last)
        dist = torch.sum((points - points.index_select(0, last[None])) ** 2, dim=-1)
        d2 = torch.minimum(d2, dist)
        last = d2.argmax()
    return torch.stack(picked).to(torch.int32)


# Query-frame selection (comet/utils/utils.py:167-332): orderings that pick
# which frames to run or query first, and the swap that puts the query frame
# at position 0.


def calculate_index_mappings(query_index: int, s: int, device=None) -> torch.Tensor:
    """The order that swaps positions 0 and query_index
    (comet/utils/utils.py:167-178), on ``device`` (the card by default)."""
    order = torch.arange(s, device=resolve_device(device, "calculate_index_mappings"))
    order[0].fill_(query_index)  # fill_: no copy from the host
    order[query_index].fill_(0)
    return order


def switch_tensor_order(tensors, order: torch.Tensor, axis: int = 1):
    """Each tensor (or None) reordered along ``axis`` (comet/utils/utils.py:181-189)."""
    return [torch.index_select(t, axis, order.to(t.device)) if t is not None else None
            for t in tensors]


def generate_rank_by_midpoint(n: int):
    """Frame order by recursive interval midpoints, coarse to fine
    (comet/utils/utils.py:234-250): [mid, 0, n-1, quarter points, ...]."""
    mid = (n - 1) // 2
    seq = [mid, 0, n - 1]
    intervals = [(0, mid), (mid, n - 1)]
    while intervals:
        start, end = intervals.pop(0)
        m = start + (end - start) // 2
        if m not in seq:
            seq.append(m)
        if end - start > 1:
            intervals.append((start, m))
            intervals.append((m, end))
    for i in range(n):
        if i not in seq:
            seq.append(i)
    return seq


def generate_rank_by_interval(n: int, k: int):
    """Frame order by stride-k interleaving (comet/utils/utils.py:253-262)."""
    result = []
    for start in range(k):
        result.extend(range(start, n, k))
    return result


def rank_by_feature_similarity(frame_features: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Query-frame ranking by appearance similarity and farthest-point
    sampling (generate_rank_by_dino, comet/utils/utils.py:265-332): the frame
    most similar to all others seeds a farthest-point sweep over the
    100-minus-similarity distances, so the frames picked are mutually
    dissimilar. frame_features: [S, P, C] per-frame patch features."""
    f = frame_features / torch.linalg.norm(frame_features, dim=-1, keepdim=True).clamp_min(1e-8)
    sim = torch.einsum("spc,tpc->pst", f, f).mean(dim=0)  # [S, S]
    dist = 100.0 - sim
    s = sim.shape[0]
    sim_offdiag = sim - 200.0 * torch.eye(s, dtype=sim.dtype, device=sim.device)
    last = sim_offdiag.sum(dim=1).argmax()
    mind = torch.full((s,), torch.inf, dtype=sim.dtype, device=sim.device)
    selected = torch.arange(s, device=sim.device) == last
    picked = []
    for _ in range(num_frames):
        picked.append(last)
        mind = torch.minimum(mind, dist.index_select(0, last[None])[0])
        mind = torch.where(selected, -torch.inf, mind)
        last = mind.argmax()
        selected = selected | (torch.arange(s, device=sim.device) == last)
    return torch.stack(picked).to(torch.int32)


def sample_subrange(n: int, idx: int, length: int):
    """A window of ``length`` frames centered at ``idx``, clamped into
    [0, n) (utils.py:827-848): shifted inward at the sequence's edges so it
    stays ``length`` long whenever n >= length. Returns (start, end), end
    exclusive."""
    start = idx - length // 2
    end = start + length
    if start < 0:
        end -= start
        start = 0
    if end > n:
        start -= end - n
        end = n
        if start < 0:
            start = 0
    if (end - start) < length:
        if end < n:
            end = min(n, start + length)
        elif start > 0:
            start = max(0, end - length)
    return start, end
