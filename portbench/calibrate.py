"""Readings that the check's limits are set from, for one cell, on the card.

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3 [--control-seeds 1,2,3]
        [--dump DIR]

For each seed, in one process: the cell's weights and requests, the program
at the cell's load (its warm-up, then ``check_requests`` requests in a
closed loop), and the judge's numbers for those requests (the lower
readings); for each control seed, the control in the program's place on the
same requests (the reference one precision lower, ``--precision``), judged
the same way (the upper readings). Prints one JSON line per seed and side;
``--dump`` saves each side's gaps answer by answer (``check.answers``), from
which a reduction other than ``check.numbers`` can be read off line.
The train cell's control seeds also read the fault "half of the batch
left out" planted in the program. The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from . import check, check_train
from .run import Cell, _pin_caches


def readings(cell: Cell, seed: int, control: bool, precision: str, device,
             dump: Optional[Path] = None) -> list:
    """The inference cells': the program's numbers on the ``check_requests``
    requests that follow its warm-up, and the control's on the same inputs.
    With ``dump``, each side's answers (``check.answers``) are saved there."""
    from .modes import InferClosed

    loop = InferClosed(cell, seed, device)
    first = cell.mix["warmup"]
    loop.picks = set(range(first, first + cell.mix["check_requests"]))
    for i in range(first + cell.mix["check_requests"]):
        loop.unit(i)
    judged, params = loop.free()
    lines = []
    sides = [("program", None)] + ([("control", precision)] if control else [])
    for side, prec in sides:
        t = time.perf_counter()
        if prec is not None:
            judged = [(inputs, check.control_outputs(params, cell.cfg, *inputs, prec))
                      for inputs, _ in judged]
        got = check.join([check.answers(params, cell.cfg, *inputs, out)
                          for inputs, out in judged])
        if dump is not None:
            torch.save({k: v.cpu() for k, v in got.items()},
                       dump / f"{cell.name}.{seed}.{side}.pt")
        lines.append(dict(workload=cell.name, seed=seed, side=side,
                          precision=prec or cell.cfg["compute_dtype"], gaps=check.numbers(got),
                          seconds=time.perf_counter() - t))
    return lines


def train_readings(cell: Cell, seed: int, control: bool, precision: str, device,
                   dump: Optional[Path] = None) -> list:
    """The train cell's: the program's first steps, the control's, and the
    fault "half of the batch left out, the mean over the rest" planted in
    the program's loss, each judged against the reference's steps; beside
    the numbers, the worst leaf's first-gradient gap and that leaf."""
    import comet_tpu_torch.training.loop as loop_module

    from .modes import TrainClosed
    from .reference.precision import ROUNDINGS

    def side(name, judged, t):
        names, grad, _ = check_train.leaf_numbers(judged, ref)
        at = int(grad.argmax())
        return dict(workload=cell.name, seed=seed, side=name, gaps=check_train.judge(judged, ref),
                    grad_worst=grad[at].item(), grad_worst_leaf=names[at],
                    seconds=time.perf_counter() - t)

    t = time.perf_counter()
    run = TrainClosed(cell, seed, device)
    prog, params = run.free()
    ref = run.reference(params)
    lines = [side("program", prog, t)]
    if control:
        t = time.perf_counter()
        ctl = check_train.by_name(run.reference(params, ROUNDINGS[precision]))
        lines.append(side("control", ctl, t))
        t = time.perf_counter()
        whole = loop_module.pose_loss
        try:
            loop_module.pose_loss = lambda c, pred, gt: whole(c, pred[: len(pred) // 2],
                                                             gt[: len(gt) // 2])
            half, _ = TrainClosed(cell, seed, device).free()
        finally:
            loop_module.pose_loss = whole
        lines.append(side("fault_half_batch", half, t))
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control-seeds", default="", help="comma-separated; a subset of --seeds")
    p.add_argument("--precision", default="float8_e4m3")
    p.add_argument("--dump", type=Path, help="a directory for each side's answers")
    args = p.parse_args(argv)
    _pin_caches()
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from comet_tpu_torch.ops import kernels

    kernels.library()
    cell = Cell(args.workload)
    control = {int(x) for x in args.control_seeds.split(",") if x}
    get = train_readings if cell.mix["mode"] == "train_closed" else readings
    for seed in (int(x) for x in args.seeds.split(",")):
        for line in get(cell, seed, seed in control, args.precision, device, args.dump):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
