"""Whether what the timed path produced is correct: the program's outputs
against the plain reference, step by step from the program's own state.

The reference runs in float32 with TF32 off, one sequence at a time, after
the window has closed and the program is freed. With random weights the
iterating trackers amplify rounding: bf16 against float32 end to end, the
tracks of two correct programs part by pixels, and a pixel decides where a
patch is cut or a score window read. So every step is judged from the
inputs that the program's own earlier step gave it (teacher forcing), and
each number is the widest gap over every element of the judged requests,
but the score's and the pose's:

- ``coarse_in`` / ``fine_in``: each iteration's update input (correlation
  windows, flow embedding, track features, position), rebuilt by the
  reference from the program's coordinates of that iteration and the track
  features the program's updates gave;
- ``coarse_px`` / ``fine_px``: each iteration's coordinate update in pixels,
  the reference's update transformer run on the program's input; and the
  program's tracks against the sum of its own updates (its refined tracks
  against its fine predictions and patch corners);
- ``coarse_feat`` / ``fine_feat``: each iteration's feature update, likewise;
- ``vis``: the visibility from those track features;
- ``score``: the track confidence from the program's fine predictions, with
  the reference's own patch and query features; each track's widest gap
  over its frames, and the 99th percentile of those over the tracks whose
  smallest heatmap spread (the reference's) is at least ``SPREAD_FLOOR``.
  The confidence divides a track's spreads by its smallest; near a one-hot
  heatmap that magnifies rounding at any precision, and the widest gap over
  the tracks reads as high for sound runs as for the control. So a fault
  shows here only where it reaches about one percent of the kept tracks;
- ``pose``: the pose encoding from the images and the program's tracks and
  confidence; each frame's widest element gap, over the larger of that
  frame's gap and the median frame's when the reference's own camera runs
  with bfloat16 operands (what rounding alone moves each frame; some frames
  magnify it several times), and the widest of those over the frames, so
  that one wrong frame counts.

The coarse stage starts from the images and queries, the fine stage from
the program's coarse tracks, so the start and every stage are judged. The
same judge reads the control (``control_outputs``): the reference one
precision lower, run as the program is, from its own outputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .reference import comet as ref
from .reference.precision import ROUNDINGS

NUMBERS = ("coarse_in", "coarse_px", "coarse_feat", "vis", "fine_in", "fine_px", "fine_feat",
           "score", "pose")
# the score's number: this quantile over the tracks whose smallest heatmap
# spread (reference) is at least SPREAD_FLOOR
QUANTILE = 0.99
SPREAD_FLOOR = 0.1
OUTPUTS = ("coarse_track", "track_vis", "pred_track", "track_score", "pred_pose_enc")


class Capture:
    """Forward hooks on the port's COMET that keep, for the requests to be
    judged, each tracker iteration's update input and output and the fine
    tracker's last predictions. Off, they keep nothing. They read internal
    interfaces of the port that ``portbench/README.md`` lists as frozen."""

    def __init__(self, model):
        self.kept: Optional[dict] = None
        model.coarse_tracker.updateformer.register_forward_hook(self._step("coarse"))
        model.fine_tracker.updateformer.register_forward_hook(self._step("fine"))
        model.fine_tracker.register_forward_hook(self._fine)

    def _step(self, part):
        def hook(module, args, out):
            if self.kept is not None:
                self.kept[part].append((args[0], out))
        return hook

    def _fine(self, module, args, out):
        if self.kept is not None:
            self.kept["fine_rel"] = out.coord_preds[-1][..., 0, :]

    def start(self) -> None:
        self.kept = {"coarse": [], "fine": []}

    def stop(self, b: int, s: int, n: int) -> dict:
        kept, self.kept = self.kept, None
        kept["fine_rel"] = kept["fine_rel"].reshape(b, n, s, 2)
        return kept


class _Sources:
    """The score's source patch features, gathered sequence by sequence:
    batch element i reads the patch at flat index i of the (b, s, n) order
    (``reference.comet.score_from_fine``)."""

    def __init__(self, b: int, s: int, n: int):
        flat = torch.arange(b)
        bi, rem = flat // (s * n), flat % (s * n)
        self.where = list(zip(bi.tolist(), (rem % n).tolist(), (rem // n).tolist()))
        self.got: List[Optional[torch.Tensor]] = [None] * b

    def take(self, j: int, pfeat: torch.Tensor) -> None:
        for i, (bi, ni, si) in enumerate(self.where):
            if bi == j:
                self.got[i] = pfeat[0, ni, si]

    def stack(self) -> torch.Tensor:
        return torch.stack(self.got)


@torch.no_grad()
def control_outputs(params, cfg: dict, images, queries, precision: str = "float8_e4m3") -> dict:
    """The control in the program's place: the reference at ``precision``,
    each stage from its own earlier stage, one sequence at a time, the score
    over the whole batch as the released model reads it; with the same
    captures the program's hooks keep."""
    plain = ref.Plain(params, ROUNDINGS[precision])
    spec = ref.tracker_spec(cfg)
    b, s = images.shape[:2]
    n = queries.shape[1]
    psize = 2 * spec["fine"]["pradius"] + 1
    src = _Sources(b, s, n)
    parts, coarse_steps, fine_steps = [], [], []
    for j in range(b):
        im = images[j:j + 1].float()
        cs, fs = [], []
        coarse, vis = plain.coarse(im, queries[j:j + 1].float(), spec, steps=cs)
        refined, fine_rel, qfeat, pfeat = plain.fine(im, coarse, spec, steps=fs)
        src.take(j, pfeat)
        parts.append((coarse, vis, refined, fine_rel, qfeat))
        coarse_steps.append(cs)
        fine_steps.append(fs)
    coarse, vis, refined, fine_rel, qfeat = (torch.cat(p) for p in zip(*parts))
    conf = ref.confidence_from_score(ref.score_from_sources(
        qfeat, src.stack(), fine_rel, spec["fine"]["sradius"], psize, plain.rnd))
    cam = ref.camera_spec(cfg)
    pose = torch.cat([plain.camera(images[j:j + 1].float(), refined[j:j + 1], conf[j:j + 1], cam)
                      for j in range(b)])

    def steps(per_seq):
        return [tuple(torch.cat([seq[k][i] for seq in per_seq]) for i in (0, 1))
                for k in range(len(per_seq[0]))]

    return dict(coarse_track=coarse, track_vis=vis, pred_track=refined, fine_rel=fine_rel,
                track_score=conf, pred_pose_enc=pose, coarse=steps(coarse_steps),
                fine=steps(fine_steps))


@torch.no_grad()
def answers(params, cfg: dict, images, queries, out: dict) -> Dict[str, torch.Tensor]:
    """One request's gaps against the float32 reference, answer by answer:
    each tracker number's widest gap (0-d); ``pose`` [B, S - 1], each frame's
    widest element gap (frame 0, the identity on both sides, left out), and
    ``pose_bf16``, the same of the reference's camera with its product
    operands rounded to bfloat16 against its own float32; ``score`` [B, N],
    each track's widest gap over its frames, and ``spread`` [B, N], the
    track's smallest heatmap spread (reference)."""
    plain = ref.Plain(params)
    rounded = ref.Plain(params, ROUNDINGS["bfloat16"])
    spec = ref.tracker_spec(cfg)
    b, s = images.shape[:2]
    n = queries.shape[1]
    psize = 2 * spec["fine"]["pradius"] + 1
    got: Dict[str, torch.Tensor] = {}

    def widest(key, x, want, scale=1.0):
        gap = (x.float() - want.float()).abs().max() * scale
        got[key] = torch.maximum(got[key], gap) if key in got else gap

    def steps_gaps(part, forced, mine, scale):
        for (x, d), (x_ref, d_ref) in zip(forced, mine):
            widest(f"{part}_in", x, x_ref)
            widest(f"{part}_px", d[..., :2], d_ref[..., :2], scale)
            widest(f"{part}_feat", d[..., 2:], d_ref[..., 2:])

    src = _Sources(b, s, n)
    qfeats = []
    tc = spec["coarse"]
    coarse_scale = float(tc["stride"] * tc["down_ratio"])
    for j in range(b):
        im = images[j:j + 1].float()
        forced = [(x[j:j + 1], d[j:j + 1]) for x, d in out["coarse"]]
        mine: list = []
        coarse, vis = plain.coarse(im, queries[j:j + 1].float(), spec, forced, mine)
        steps_gaps("coarse", forced, mine, coarse_scale)
        widest("coarse_px", out["coarse_track"][j:j + 1], coarse)
        widest("vis", out["track_vis"][j:j + 1], vis)
        prog_coarse = out["coarse_track"][j:j + 1].float()
        forced = [(x[j * n:(j + 1) * n], d[j * n:(j + 1) * n]) for x, d in out["fine"]]
        mine = []
        refined, fine_rel, qfeat, pfeat = plain.fine(im, prog_coarse, spec, forced, mine)
        steps_gaps("fine", forced, mine, 1.0)
        widest("fine_px", out["fine_rel"][j:j + 1], fine_rel)
        widest("fine_px", out["pred_track"][j:j + 1], refined)
        src.take(j, pfeat)
        qfeats.append(qfeat)
        del coarse, vis, refined, pfeat, mine, forced
    qfeat, fine_rel = torch.cat(qfeats), out["fine_rel"].float()
    spread = ref.score_from_sources(qfeat, src.stack(), fine_rel, spec["fine"]["sradius"],
                                    psize)
    conf = ref.confidence_from_score(spread)
    got["score"] = (out["track_score"].float() - conf).abs().amax(dim=1)
    got["spread"] = spread.amin(dim=1)
    cam = ref.camera_spec(cfg)
    pose, pose_bf16 = [], []
    for j in range(b):
        inputs = (images[j:j + 1].float(), out["pred_track"][j:j + 1].float(),
                  out["track_score"][j:j + 1].float(), cam)
        want = plain.camera(*inputs)
        pose.append((out["pred_pose_enc"][j:j + 1].float() - want).abs().amax(-1)[:, 1:])
        pose_bf16.append((rounded.camera(*inputs) - want).abs().amax(-1)[:, 1:])
    got["pose"], got["pose_bf16"] = torch.cat(pose), torch.cat(pose_bf16)
    return got


def numbers(got: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers compared, from :func:`answers` (of one request or several
    joined by :func:`join`)."""
    gaps = {k: got[k].max().item() for k in NUMBERS if k not in ("score", "pose")}
    kept = got["spread"] >= SPREAD_FLOOR
    gaps["score"] = torch.quantile(got["score"][kept] if kept.any() else got["score"],
                                   QUANTILE).item()
    rounding = torch.maximum(got["pose_bf16"], got["pose_bf16"].median()).clamp_min(1e-30)
    gaps["pose"] = (got["pose"] / rounding).max().item()
    return gaps


def join(parts: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Several requests' answers as one: the widest of each 0-d gap, the
    per-frame and per-track gaps side by side."""
    return {k: (torch.stack([p[k] for p in parts]).max() if parts[0][k].dim() == 0
                else torch.cat([p[k].flatten() for p in parts])) for k in parts[0]}


def judge(params, cfg: dict, images, queries, out: dict) -> Dict[str, float]:
    """The numbers of one request's outputs and captures (batch first)."""
    return numbers(answers(params, cfg, images, queries, out))


def judge_requests(params, cfg: dict, judged: list) -> Dict[str, float]:
    """The numbers over the judged requests, [((images, queries), outputs)]."""
    return numbers(join([answers(params, cfg, images, queries, out)
                         for (images, queries), out in judged]))


def reference_params(state: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """The benchmark's state dict in float32 for the reference."""
    return {k: v.to(device=device, dtype=torch.float32) for k, v in state.items()}


def verdict(gaps: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every number is finite and within its limit."""
    return all(v == v and v <= limits[k] for k, v in gaps.items())
