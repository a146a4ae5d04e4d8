"""The loops a traffic mix's ``mode`` names. Each builds the program and its
inputs from the seed (set-up, warm-up included), runs one unit of work per
call of ``unit`` in the window, and afterwards frees the program and judges
what it produced.

``infer_closed``: one client sends a request (``batch`` sequences), waits
until its outputs are on the host, and sends the next; ``pool`` distinct
requests drawn from the seed are sent in turn (``portbench/traffic.py``).

``train_closed``: the port's train step (``training.loop.build_train_step``
with ``training.optim.build_optimizer``: float32 masters, bf16 compute,
``ClippedAdamW``, ``LambdaLR``) at ``batch`` sequences, fresh images every
step, queries and ground-truth cameras drawn once; its first three steps
run in set-up and are judged (``portbench/check_train.py``).
"""

from __future__ import annotations

import random
import statistics
import time
from typing import Dict, List

import torch

from . import check, check_train, traffic
from .program import (build_inference, build_training, comet_config, make_state,
                      parameter_shapes)
from .trace import LayerSpans, TrainSpans


class InferClosed:
    def __init__(self, cell, seed: int, device):
        cfg, mix = cell.cfg, cell.mix
        self.cfg, self.mix, self.device = cfg, mix, device
        self.cuda = device.type == "cuda"
        self.marks = []  # (set-up phase, when it ended): printed by the run
        self.state = make_state(parameter_shapes(cfg), seed, device, comet_config(cfg).dtype)
        self._mark("weights")
        self.model = build_inference(cfg, self.state, device)
        self.capture = check.Capture(self.model)
        self._mark("build")
        gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)  # apart from the weights'
        self.pool = traffic.inference_pool(mix, cfg, gen, device)
        self._mark("inputs")
        self.batch = mix["batch"]
        # the judged requests: drawn from the seed among the window's first ones
        self.picks = set(random.Random(seed).sample(range(mix["check_among"]),
                                                    mix["check_requests"]))
        self.outs: List[dict] = []
        for i in range(mix["warmup"]):
            self._request(i, False)
        self.outs.clear()
        self._mark("warmup")

    def _mark(self, name: str) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.marks.append((name, time.perf_counter()))

    def spans(self):
        return LayerSpans(self.model)

    def _request(self, i: int, judged: bool) -> None:
        images, queries = self.pool[i % len(self.pool)]
        if judged:
            self.capture.start()
        with torch.inference_mode():
            out = self.model(images, queries)
        kept = {k: out[k] for k in check.OUTPUTS}
        if judged:
            kept.update(self.capture.stop(self.batch, self.cfg["seqlen"], self.cfg["track_num"]))
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.outs.append(kept)

    def unit(self, i: int) -> None:
        self._request(i, i in self.picks)

    def finish(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def failed(self) -> int:
        return sum(1 for o in self.outs
                   if not all(bool(torch.isfinite(o[k]).all()) for k in check.OUTPUTS))

    def free(self):
        """Frees the program; returns the judged requests' (inputs, outputs)
        and the reference's float32 weights."""
        n = len(self.outs)
        judged = [(self.pool[i % len(self.pool)], self.outs[i]) for i in sorted(self.picks)
                  if i < n]
        self.model = self.outs = self.capture = None
        if self.cuda:
            torch.cuda.empty_cache()
        params = check.reference_params(self.state, self.device)
        self.state = None
        return judged, params

    def judge(self):
        """(gaps, whether every judged request was there); frees the program."""
        judged, params = self.free()
        gaps = check.judge_requests(params, self.cfg, judged)
        return gaps, len(judged) == len(self.picks)

    def values(self, units: int, window_s: float, lat: List[float]) -> Dict[str, float]:
        frames = units * self.batch * self.cfg["seqlen"]
        return {"infer_fps": frames / window_s, "infer_p90_ms": p90(lat) * 1e3}


class TrainClosed:
    def __init__(self, cell, seed: int, device):
        from comet_tpu_torch.geometry.cameras import CameraSet
        from comet_tpu_torch.training.loop import build_train_step
        from comet_tpu_torch.training.optim import build_optimizer, camera_only_mask

        cfg, mix = cell.cfg, cell.mix
        self.cfg, self.mix, self.device = cfg, mix, device
        self.cuda = device.type == "cuda"
        self.marks = []  # (set-up phase, when it ended): printed by the run
        self.state = make_state(parameter_shapes(cfg), seed, device, torch.float32)
        self._mark("weights")
        self.model = build_training(cfg, self.state, device)
        self.optimizer, scheduler = build_optimizer(self.model, cfg["train"]["lr"],
                                                    steps_per_epoch=mix["steps_per_epoch"])
        self.step = build_train_step(self.model, comet_config(cfg), self.optimizer, scheduler)
        self._mark("build")
        self.batch = b = mix["batch"]
        s, hw, n = cfg["seqlen"], cfg["img_size"], cfg["track_num"]
        self.gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
        g = self.gen
        m = mix["query_margin"]
        self.queries = torch.rand((b, n, 2), generator=g, device=device) * (hw - 2 * m) + m
        q = torch.randn((b, s, 4), generator=g, device=device)
        t_uvz = torch.randn((b, s, 3), generator=g, device=device)
        t_uvz[..., :2] *= torch.tensor(mix["gt_uv_px"], device=device)[:, None, None]
        t_uvz[..., 2] = 3.0
        self.gt = dict(q=q / q.norm(dim=-1, keepdim=True), t_uvz=t_uvz,
                       focal=torch.full((b, s, 2), 1745.0, device=device),
                       ratio=torch.full((b,), 0.5, device=device))
        self.cams = CameraSet(q=self.gt["q"], t_xyz=torch.randn((b, s, 3), generator=g,
                                                                device=device),
                              t_uvz=t_uvz, focal=self.gt["focal"],
                              pp=torch.full((b, s, 2), hw / 2.0, device=device),
                              ratio=self.gt["ratio"])
        self.shape = (b, s, hw, hw, 3)
        mask = camera_only_mask(self.model)
        self.names = [k for k, _ in self.model.named_parameters() if mask[k]]
        params = dict(self.model.named_parameters())
        # the first steps, through the window's own call and feed
        inputs = check_train.CameraInputs(self.model)
        inputs.on = True
        self.feed, losses = [], []
        for k in range(check_train.STEPS):
            images = self._images()
            losses.append(self.step(images, self.queries, self.cams)["loss"])
            self.feed.append({"images": images})
            if k == 0:
                self.first = check_train.norms(
                    [self.optimizer.state[params[n]]["exp_avg"] for n in self.names]
                ) / (1.0 - check_train.reftrain.ADAMW["betas"][0])
        inputs.on = False
        self._mark("first_steps")
        self.change = check_train.norms([params[n].detach() - self.state[n] for n in self.names])
        for f, (_, tracks, conf) in zip(self.feed, inputs.kept):
            f.update(tracks=tracks.float(), confidence=conf.float(), gt=self.gt)
        self.losses = torch.stack(losses)
        self.window_losses: List[torch.Tensor] = []
        self.finish()

    _mark = InferClosed._mark

    def _images(self):
        return torch.randn(self.shape, generator=self.gen, device=self.device)

    def spans(self):
        return TrainSpans(self.model)

    def unit(self, i: int) -> None:
        self.window_losses.append(self.step(self._images(), self.queries, self.cams)["loss"])

    def finish(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def failed(self) -> int:
        return sum(1 for v in self.window_losses if not bool(torch.isfinite(v)))

    def free(self):
        """Frees the program; returns its first steps' numbers (``by_name``'s
        form) and the reference's float32 weights."""
        prog = check_train.by_name({"names": self.names, "loss": self.losses,
                                    "grad": self.first, "change": self.change})
        self.model = self.optimizer = self.step = None
        if self.cuda:
            torch.cuda.empty_cache()
        params = check.reference_params(self.state, self.device)
        self.state = None
        for f in self.feed:
            f["images"] = f["images"].float()
        return prog, params

    def reference(self, params, rnd=None) -> dict:
        return check_train.reference_steps(params, self.cfg, self.feed,
                                           self.mix["steps_per_epoch"], rnd)

    def judge(self):
        """(gaps, True); frees the program, then the reference's three steps."""
        prog, params = self.free()
        return check_train.judge(prog, self.reference(params)), True

    def values(self, units: int, window_s: float, lat: List[float]) -> Dict[str, float]:
        return {"train_seq_per_s": units * self.batch / window_s}


MODES = {"infer_closed": InferClosed, "train_closed": TrainClosed}


def p90(values: List[float]) -> float:
    return (statistics.quantiles(values, n=10, method="inclusive")[-1] if len(values) > 1
            else values[0])
