"""Prediction-inspection frames: a registry of two-view plots and a
cross-experiment scatter of per-pair metrics.

Counterpart of ``comet_tpu/matching/inspect_frames.py``, itself
glue-factory's visualization/two_view_frame.py (TwoViewFrame: plot
selection by required keys), global_frame.py (GlobalFrame: the metric
scatter, diff mode, opening a pair) and visualization/tools.py (the plot
classes). Each plot is a function ``data, pred -> uint8 RGB image`` drawn by
the port's ``viz``; ``save`` writes PNGs headless, ``show`` opens a
matplotlib window where a GUI backend is live. Predictions may be tensors
on any device or numpy arrays; they are read on the host. Where cv2 (the
drawing) or matplotlib (the figures) is missing, the call raises.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from . import viz
from .viz import _np

__all__ = [
    "PairPlot", "ImagePlot", "KeypointPlot", "KeypointRankingPlot", "MatchesPlot",
    "GtMatchesPlot", "EpipolarMatchesPlot", "HeatmapPlot", "LinePlot", "LineMatchesPlot",
    "PLOT_REGISTRY", "TwoViewFrame", "GlobalFrame",
]


class PairPlot:
    """A named two-view rendering. A subclass declares the keys it needs
    (met by data and pred together) and renders them."""

    name: str = "?"
    required_keys: Sequence[str] = ()

    @classmethod
    def available(cls, keys) -> bool:
        return set(cls.required_keys).issubset(keys)

    def render(self, data: dict, pred: dict) -> np.ndarray:
        raise NotImplementedError


def _imgs(data):
    return _np(data["image0"]), _np(data["image1"])


def _valid_matches(pred):
    """(matched keypoints of image 0, their partners in image 1, the mask
    of matched keypoints)."""
    kp0, kp1 = _np(pred["keypoints0"]), _np(pred["keypoints1"])
    m0 = _np(pred["matches0"]).astype(np.int64)
    valid = m0 >= 0
    tgt = np.clip(m0[valid], 0, max(len(kp1) - 1, 0))
    return kp0[valid], kp1[tgt] if len(kp1) else kp1, valid


class ImagePlot(PairPlot):
    name = "image"
    required_keys = ()

    def render(self, data, pred):
        return viz.side_by_side(*_imgs(data))[0]


class KeypointPlot(PairPlot):
    name = "keypoints"
    required_keys = ("keypoints0", "keypoints1")

    def render(self, data, pred):
        i0, i1 = _imgs(data)

        def norm(s):
            if s is None:
                return None
            s = _np(s, np.float64)
            return s / max(float(s.max()), 1e-12)

        a = viz.draw_keypoints(i0, _np(pred["keypoints0"]), scores=norm(pred.get("keypoint_scores0")))
        b = viz.draw_keypoints(i1, _np(pred["keypoints1"]), scores=norm(pred.get("keypoint_scores1")))
        return viz.side_by_side(a, b)[0]


class KeypointRankingPlot(PairPlot):
    """Keypoints colored by rank: the strongest green, the weakest red."""

    name = "keypoint_ranking"
    required_keys = ("keypoints0", "keypoints1", "keypoint_scores0", "keypoint_scores1")

    def render(self, data, pred):
        i0, i1 = _imgs(data)

        def ranked(img, kpts, scores):
            order = np.argsort(np.argsort(_np(scores, np.float64)))  # rank in [0, n)
            return viz.draw_keypoints(img, _np(kpts), scores=order / max(len(order) - 1, 1))

        a = ranked(i0, pred["keypoints0"], pred["keypoint_scores0"])
        b = ranked(i1, pred["keypoints1"], pred["keypoint_scores1"])
        return viz.side_by_side(a, b)[0]


class MatchesPlot(PairPlot):
    name = "matches"
    required_keys = ("keypoints0", "keypoints1", "matches0")

    def render(self, data, pred):
        kp0, kp1, valid = _valid_matches(pred)
        correct = None
        if "matching_scores0" in pred:
            correct = _np(pred["matching_scores0"], np.float64)[valid]
        return viz.draw_matches(*_imgs(data), kp0, kp1, correct=correct)


class GtMatchesPlot(PairPlot):
    """Predicted matches colored by agreement with the ground truth."""

    name = "gt_matches"
    required_keys = ("keypoints0", "keypoints1", "matches0", "gt_matches0")

    def render(self, data, pred):
        kp0, kp1 = _np(pred["keypoints0"]), _np(pred["keypoints1"])
        m0 = _np(pred["matches0"]).astype(np.int64)
        gt = _np(pred["gt_matches0"]).astype(np.int64)
        valid = m0 >= 0
        correct = (m0 == gt)[valid].astype(np.float64)
        tgt = np.clip(m0[valid], 0, max(len(kp1) - 1, 0))
        return viz.draw_matches(*_imgs(data), kp0[valid], kp1[tgt], correct=correct)


class EpipolarMatchesPlot(PairPlot):
    """Matches and the epipolar lines of image 0's keypoints in image 1;
    the loader item holds the fundamental matrix ``F_0to1``."""

    name = "epipolar_matches"
    required_keys = ("keypoints0", "keypoints1", "matches0", "F_0to1")

    def render(self, data, pred):
        i0, i1 = _imgs(data)
        kp0, kp1, _ = _valid_matches(pred)
        canvas = viz.draw_epipolar_lines(i0, i1, _np(data["F_0to1"]), kp0)
        # the matched points in image 1, offset by image 0's width
        off = canvas.shape[1] - viz._as_u8(i1).shape[1]
        shifted = np.asarray(kp1, np.float64).copy()
        if len(shifted):
            shifted[:, 0] += off
        return viz.draw_keypoints(canvas, shifted, color=(0, 255, 0))


class HeatmapPlot(PairPlot):
    name = "heatmap"
    required_keys = ("heatmap0", "heatmap1")

    def render(self, data, pred):
        i0, i1 = _imgs(data)
        h0, h1 = _np(pred["heatmap0"], np.float64), _np(pred["heatmap1"], np.float64)
        if h0.ndim == 3:  # [1, H, W]
            h0, h1 = h0[0], h1[0]
        return viz.side_by_side(viz.heatmap_overlay(i0, h0), viz.heatmap_overlay(i1, h1))[0]


class LinePlot(PairPlot):
    name = "lines"
    required_keys = ("lines0", "lines1")

    def render(self, data, pred):
        i0, i1 = _imgs(data)
        a = viz.draw_lines(i0, _np(pred["lines0"]))
        b = viz.draw_lines(i1, _np(pred["lines1"]))
        return viz.side_by_side(a, b)[0]


class LineMatchesPlot(PairPlot):
    name = "line_matches"
    required_keys = ("lines0", "lines1", "line_matches0")

    def render(self, data, pred):
        l0, l1 = _np(pred["lines0"]), _np(pred["lines1"])
        m0 = _np(pred["line_matches0"]).astype(np.int64)
        valid = m0 >= 0
        tgt = np.clip(m0[valid], 0, max(len(l1) - 1, 0))
        return viz.draw_line_matches(*_imgs(data), l0[valid], l1[tgt] if len(l1) else l1)


PLOT_REGISTRY: Dict[str, type] = {p.name: p for p in (
    ImagePlot, KeypointPlot, KeypointRankingPlot, MatchesPlot, GtMatchesPlot,
    EpipolarMatchesPlot, HeatmapPlot, LinePlot, LineMatchesPlot,
)}


class TwoViewFrame:
    """One pair, one rendering per experiment.

    data: a loader item with image0 and image1 (and H_0to1, F_0to1, ...);
    preds: {experiment name: prediction dict}."""

    def __init__(self, data: dict, preds: Dict[str, dict], default: str = "matches",
                 title: Optional[str] = None):
        self.data = data
        self.preds = dict(preds)
        self.names = list(preds)
        self.title = title
        keys = None
        for pred in preds.values():
            keys = set(pred) if keys is None else keys & set(pred)
        keys = (keys or set()) | set(data)
        self.options = [n for n, p in PLOT_REGISTRY.items() if p.available(keys)]
        self.current = default if default in self.options else "image"

    def draw(self, plot: Optional[str] = None) -> Dict[str, np.ndarray]:
        """The selected plot for every experiment."""
        if plot is not None:
            if plot not in self.options:
                raise KeyError(f"plot {plot!r} not available; options: {self.options}")
            self.current = plot
        renderer = PLOT_REGISTRY[self.current]()
        return {n: renderer.render(self.data, self.preds[n]) for n in self.names}

    def cycle(self) -> str:
        """The next available plot."""
        i = self.options.index(self.current)
        self.current = self.options[(i + 1) % len(self.options)]
        return self.current

    def save(self, out_dir: str, plots: Optional[Sequence[str]] = None) -> List[str]:
        """One PNG per (plot, experiment), headless."""
        import cv2

        os.makedirs(out_dir, exist_ok=True)
        written = []
        for plot in (plots or [self.current]):
            for name, img in self.draw(plot).items():
                path = os.path.join(out_dir, f"{plot}_{name}.png")
                cv2.imwrite(path, img[..., ::-1])
                written.append(path)
        return written

    def show(self, block: bool = True):  # pragma: no cover - GUI only
        """A figure of the renderings: 'r' cycles the plots."""
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(len(self.names), 1, squeeze=False,
                                 figsize=(10, 5 * len(self.names)))
        ims = {}
        for ax, (name, img) in zip(axes[:, 0], self.draw().items()):
            ims[name] = ax.imshow(img)
            ax.set_ylabel(name)
            ax.set_xticks([])
            ax.set_yticks([])
        if self.title:
            fig.suptitle(f"{self.title} [{self.current}]")

        def on_key(event):
            if event.key == "r":
                self.cycle()
                for name, img in self.draw().items():
                    ims[name].set_data(img)
                if self.title:
                    fig.suptitle(f"{self.title} [{self.current}]")
                fig.canvas.draw_idle()

        fig.canvas.mpl_connect("key_press_event", on_key)
        plt.show(block=block)
        return fig


class GlobalFrame:
    """Per-pair metrics of several experiments as a scatter.

    results: {experiment name: {metric name: per-pair values}}, the eval
    pipeline's summaries; pair_opener: an optional callable(pair index) ->
    (data, preds) that builds the pair's :class:`TwoViewFrame`."""

    def __init__(self, results: Dict[str, Dict[str, Sequence[float]]],
                 x: Optional[str] = None, y: Optional[str] = None, diff: bool = False,
                 pair_opener: Optional[Callable] = None):
        self.results = {name: {m: _np(v, np.float64) for m, v in metrics.items()}
                        for name, metrics in results.items()}
        self.names = list(self.results)
        metrics = set()
        for v in self.results.values():
            metrics |= set(v)
        self.metrics = sorted(metrics)
        if len(self.metrics) < 2:
            raise ValueError("need at least two per-pair metrics to scatter")
        self.x = x or self.metrics[0]
        self.y = y or self.metrics[1]
        for m in (self.x, self.y):
            if m not in self.metrics:
                raise KeyError(f"unknown metric {m!r}; have {self.metrics}")
        self.diff = diff and len(self.names) > 1
        self.pair_opener = pair_opener

    def _xy(self, name):
        xs, ys = self.results[name][self.x], self.results[name][self.y]
        if self.diff:
            base = self.results[self.names[0]]
            xs, ys = xs - base[self.x], ys - base[self.y]
        return xs, ys

    def worst_pairs(self, metric: Optional[str] = None, k: int = 4,
                    experiment: Optional[str] = None, largest: bool = True) -> List[int]:
        """Pair indices ranked by a metric, largest first (or smallest)."""
        vals = self.results[experiment or self.names[0]][metric or self.y]
        order = np.argsort(vals)
        if largest:
            order = order[::-1]
        return [int(i) for i in order[:k]]

    def open_pair(self, index: int, **kwargs) -> TwoViewFrame:
        if self.pair_opener is None:
            raise RuntimeError("no pair_opener wired")
        data, preds = self.pair_opener(index)
        return TwoViewFrame(data, preds, title=f"pair {index}", **kwargs)

    def figure(self):
        """(the scatter figure, {scatter artist: its pair indices}), on
        matplotlib's own backend (Agg where there is no display)."""
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 6))
        art_to_pair = {}
        for name in self.names:
            xs, ys = self._xy(name)
            sc = ax.scatter(xs, ys, s=14, alpha=0.7, label=name, picker=True)
            art_to_pair[sc] = np.arange(len(xs))
        prefix = "Δ" if self.diff else ""
        ax.set_xlabel(prefix + self.x)
        ax.set_ylabel(prefix + self.y)
        ax.legend()
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        return fig, art_to_pair

    def save(self, path: str) -> str:
        import matplotlib.pyplot as plt

        fig, _ = self.figure()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path

    def show(self, block: bool = True):  # pragma: no cover - GUI only
        """The scatter; picking a point opens its pair's frame."""
        import matplotlib.pyplot as plt

        fig, art_to_pair = self.figure()

        def on_pick(event):
            pairs = art_to_pair.get(event.artist)
            if pairs is None or self.pair_opener is None:
                return
            self.open_pair(int(pairs[event.ind[0]])).show(block=False)

        fig.canvas.mpl_connect("pick_event", on_pick)
        plt.show(block=block)
        return fig
