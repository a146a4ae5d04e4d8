"""Whether the timed train step is correct: its first three steps against
the plain reference's (``portbench/reference/train.py``).

Set-up drives the program's own train step from the seed through three
steps on rows that all differ, through the window's call and feed, and
keeps: each step's loss, the norm of each leaf's first gradient as the
optimizer got it (AdamW's first moment after step 1 over 1 - beta1), and the
norm of each leaf's change after step 3. The reference repeats the three
steps from the same float32 weights, in float32 with TF32 off, on the same
images, queries and cameras; the camera predictor it trains takes the
tracks and confidence the program's frozen trackers gave (the trackers are
judged in the inference cells). Numbers:

- ``loss``: the widest relative gap of the three losses;
- ``grad``: the median leaf's gap between the two first-gradient norms, each
  leaf's over the larger of the reference's norm of that leaf and of the
  median leaf (the worst leaf's swings from seed to seed with the noise of
  single leaves; PERF.md gives both);
- ``change``: the worst leaf's gap of the change after three steps, alike.

Leaves whose reference gradient is under a thousandth of the median leaf's
move under Adam by rounding alone; they are left out of ``grad`` and
``change`` by that rule.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .reference import train as reftrain

NUMBERS = ("loss", "grad", "change")
STEPS = 3
QUIET = 1e-3  # a leaf under this share of the median leaf's gradient is left out


class CameraInputs:
    """A forward pre-hook on the port's camera predictor that keeps its
    inputs (images, tracks, confidence) while on."""

    def __init__(self, model):
        self.kept: List[tuple] = []
        self.on = False
        model.camera_predictor.register_forward_pre_hook(self._hook)

    def _hook(self, module, args):
        if self.on:
            self.kept.append(tuple(a.detach() for a in args))


def norms(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.float().norm() for t in tensors])


def leaf_gaps(got: torch.Tensor, want: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Each kept leaf's |got - want| over max(want, median want)."""
    scale = torch.maximum(want, want[keep].median())
    return ((got - want).abs() / scale)[keep]


def reference_steps(params: Dict[str, torch.Tensor], cfg: dict, feed: List[dict],
                    steps_per_epoch: int, rnd=None) -> dict:
    """The reference's three steps: losses, first-gradient norms and
    change norms, by the reference's leaf order."""
    tr = reftrain.Trainer(params, cfg, steps_per_epoch, rnd)
    start = [tr.p[k].detach().clone() for k in tr.names]
    losses, first = [], None
    for k, f in enumerate(feed[:STEPS]):
        out = tr.step(f["images"], f["tracks"], f["confidence"], f["gt"])
        losses.append(out["loss"])
        if k == 0:
            first = norms([out["grads"][n] for n in tr.names])
    change = norms([tr.p[n].detach() - s for n, s in zip(tr.names, start)])
    return {"names": tr.names, "loss": torch.stack(losses), "grad": first, "change": change}


def by_name(steps: dict) -> dict:
    """A side's losses, and its norms by leaf name."""
    return {"loss": steps["loss"], "grad": dict(zip(steps["names"], steps["grad"])),
            "change": dict(zip(steps["names"], steps["change"]))}


def leaf_numbers(side: dict, ref: dict):
    """(kept leaves' names, their first-gradient gaps, their change gaps) of
    a judged side (``by_name``'s form) against the reference's steps."""
    keep = ref["grad"] >= QUIET * ref["grad"].median()

    def ordered(key):
        return torch.stack([side[key][n] for n in ref["names"]]).to(ref[key].device)

    names = [n for n, k in zip(ref["names"], keep.tolist()) if k]
    return (names, leaf_gaps(ordered("grad"), ref["grad"], keep),
            leaf_gaps(ordered("change"), ref["change"], keep))


def judge(side: dict, ref: dict) -> Dict[str, float]:
    """The three numbers of a judged side against the reference's steps."""
    loss = ((side["loss"].float() - ref["loss"]).abs() / ref["loss"].abs()).max().item()
    _, grad, change = leaf_numbers(side, ref)
    return {"loss": loss, "grad": grad.median().item(), "change": change.max().item()}
