"""Shared pieces of the tests that hold the port's line experiments and
cached-prediction pipelines to ``comet_tpu`` through the ``match`` CLI.

- :func:`jit_jax_matching` puts the JAX side's SuperPoint, SIFT, line
  detectors, DeepLSD, GlueStick, metrics, DLT and RANSACs under ``jax.jit``
  (the same functions, each compiled once per shape for the process: the
  RANSACs take their threshold as an argument), and its Sobel in the port's
  tap order (``jax_sobel``: XLA's convolution sums the taps in an order no
  sequence of adds reproduces, and the flat regions' rounding residues
  decide their orientation's sign; ``test_torch_port_lines.py`` holds the
  detector itself to JAX through its fields and its march).
- :func:`jax_draws` makes the port's RANSACs draw JAX's samples of
  ``PRNGKey(0)``.
- :func:`line_experiment` gives both packages' line experiment the same
  SuperPoint (a ``.msgpack``), GlueStick (a JAX ``save_experiment``
  directory, for ``--load-experiment``) and DeepLSD weights, cut to 64
  keypoints, 8 lines, depth 2 and width 32.
- :func:`same_pipeline_row` compares printed ``--pipeline`` rows.
- :func:`one_torch_thread`, a module fixture for the modules that import it.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu.matching import benchmarks as jbench
from comet_tpu.matching import configs as jconfigs
from comet_tpu.matching import deeplsd as jdl
from comet_tpu.matching import eval as jeval
from comet_tpu.matching import lines as jlines
from comet_tpu.matching import matchers as jmatchers
from comet_tpu.matching import sift as jsift
from comet_tpu.twoview import estimators as jest
from comet_tpu_torch.matching import configs as tconfigs
from comet_tpu_torch.matching import deeplsd as tdl
from comet_tpu_torch.matching import lines as tlines
from comet_tpu_torch.twoview import estimators as test_
from test_torch_port_match_cli import _Jitted as Jitted
from test_torch_port_twoview import _jax_samples

GS = dict(depth=2, dim=32, filter_threshold=0.0)
FIT_RTOL = 1e-3
_MARCH = ("max_lines", "n_steps", "step", "mag_threshold", "angle_tol", "min_length",
          "nms_radius")


class JittedGlueStick(Jitted):
    """``Jitted`` whose call signature names the lines, so that
    ``wrap_flax_matcher`` passes them."""

    def __call__(self, kpts0, desc0, kpts1, desc1, lines0, ldesc0, lines1, ldesc1,
                 valid0=None, valid1=None, lvalid0=None, lvalid1=None):
        raise TypeError("call through apply")


def jax_sobel(gray):
    """The port's Sobel (``lines._correlate3``'s taps in its order) in jnp."""
    h, w = gray.shape
    xp = jnp.pad(gray, 1)

    def corr(k):
        out = None
        for i in range(3):
            for j in range(3):
                if k[i][j] != 0.0:
                    term = xp[i:i + h, j:j + w] * (k[i][j] / 8.0)
                    out = term if out is None else out + term
        return out

    return corr(tlines._SOBEL_X), corr(tuple(zip(*tlines._SOBEL_X)))


_JITTED = {
    (jsift, "extract_sift"): jax.jit(jsift.extract_sift,
                                     static_argnames=("max_keypoints", "threshold")),
    (jlines, "detect_line_segments"): jax.jit(jlines.detect_line_segments,
                                              static_argnames=_MARCH),
    (jdl, "extract_lines_from_fields"): jax.jit(jdl.extract_lines_from_fields,
                                                static_argnames=("tau",) + _MARCH),
    (jmatchers, "mutual_nearest_neighbor"): jax.jit(jmatchers.mutual_nearest_neighbor,
                                                    static_argnames="threshold"),
    (jeval, "eval_matches_homography"): jax.jit(jeval.eval_matches_homography,
                                                static_argnames="threshold"),
    (jbench, "eval_matches_homography"): jax.jit(jbench.eval_matches_homography,
                                                 static_argnames="threshold"),
    (jest, "run_homography_dlt"): jax.jit(jest.run_homography_dlt),
    (jbench, "homography_corner_error"): jax.jit(jbench.homography_corner_error,
                                                 static_argnames="hw"),
    (jest, "estimate_homography_ransac"): jax.jit(jest.estimate_homography_ransac,
                                                  static_argnames="num_hypotheses"),
    (jest, "estimate_essential_ransac"): jax.jit(jest.estimate_essential_ransac,
                                                 static_argnames="num_hypotheses"),
}
_MODULES = {}  # jitted flax modules by (class name, conf), kept for the process


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module that imports this fixture: its
    tensors are small, and the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cached(name, make, **kw):
    key = (name, tuple(sorted(kw.items())))
    if key not in _MODULES:
        _MODULES[key] = make(**kw)
    return _MODULES[key]


def jit_jax_matching(monkeypatch):
    from comet_tpu.matching import extractors as jext
    from comet_tpu.matching.registry import get_model as raw_get_model
    from comet_tpu.models import superpoint as jsp
    from comet_tpu.models.superpoint import SuperPoint

    for module in (jext, jsp):
        monkeypatch.setattr(module, "SuperPoint", lambda **kw: _cached(
            "SuperPoint", lambda **k: Jitted(SuperPoint(**k)), **kw))
    net = jdl.DeepLSDNet
    monkeypatch.setattr(jdl, "DeepLSDNet", lambda **kw: _cached(
        "DeepLSDNet", lambda **k: Jitted(net(**k)), **kw))
    monkeypatch.setattr(jlines, "image_gradients", jax_sobel)
    for (module, name), fn in _JITTED.items():
        monkeypatch.setattr(module, name, fn)
    previous = jconfigs.get_model

    def get_jitted(name, **conf):
        if name == "matcher_gluestick":
            return _cached(name, lambda **k: JittedGlueStick(raw_get_model(name, **k)), **conf)
        return previous(name, **conf)

    monkeypatch.setattr(jconfigs, "get_model", get_jitted)


@functools.lru_cache(maxsize=None)
def _samples(n, num_hypotheses, sample_size):
    return _jax_samples(jax.random.PRNGKey(0), n, num_hypotheses, sample_size)


def jax_draws(monkeypatch):
    def draw(n, num_hypotheses, sample_size, generator, device, p=None):
        return torch.tensor(_samples(n, num_hypotheses, sample_size), dtype=torch.long,
                            device=device)

    monkeypatch.setattr(test_, "ransac_samples", draw)


@functools.lru_cache(maxsize=None)
def _sp_variables():
    from comet_tpu.models.superpoint import SuperPoint

    return jax.jit(SuperPoint(max_keypoints=8).init)(jax.random.PRNGKey(5),
                                                     np.zeros((16, 16), np.float32))


@functools.lru_cache(maxsize=None)
def _gluestick_variables():
    from comet_tpu.matching import gluestick as jgs

    z = jnp.zeros
    return jax.jit(jgs.GlueStickMatcher(**GS).init)(
        jax.random.PRNGKey(4), z((64, 2)), z((64, 256)), z((64, 2)), z((64, 256)),
        z((8, 2, 2)), z((8, 5, 3)), z((8, 2, 2)), z((8, 5, 3)))


@functools.lru_cache(maxsize=None)
def _deeplsd_variables(size):
    return jax.jit(jdl.DeepLSDNet(base=32).init)(jax.random.PRNGKey(0),
                                                 jnp.zeros((size, size)))


def make_sp_params(path):
    """A SuperPoint ``.msgpack`` at ``path`` (the variables drawn once per
    process)."""
    from comet_tpu.utils.serialization import save_params_msgpack

    save_params_msgpack(path, _sp_variables())
    return path


def line_experiment(monkeypatch, tmp_path, name, size=64):
    """Both packages' ``name`` experiment cut to size, with one SuperPoint,
    and the port's DeepLSD given the variables JAX's wireframe draws from
    ``PRNGKey(0)``; returns a GlueStick checkpoint directory. The weights
    are drawn once per process."""
    from comet_tpu.matching import experiments as jexp

    sp = make_sp_params(str(tmp_path / "superpoint.msgpack"))
    for configs in (jconfigs, tconfigs):
        exp = copy.deepcopy(configs.EXPERIMENTS[name])
        exp["extractor"].update(point_conf={"params_path": sp, "max_keypoints": 64}, max_lines=8)
        exp["matcher"].update(GS)
        monkeypatch.setitem(configs.EXPERIMENTS, name, exp)
    ckpt = str(tmp_path / "gluestick")
    jexp.save_experiment(ckpt, 1, _gluestick_variables())
    if "deeplsd" in name:
        variables = _deeplsd_variables(size)

        def init(self, generator=None):
            self.params = variables
            return self.net

        monkeypatch.setattr(tdl.DeepLSDDetector, "init", init)
    return ckpt


# a pose error from the f32 8-point fit: the port's and JAX's SVDs of the
# same system put the synthetic relpose pair 0's error 3.4e-3 degrees apart
POSE_ATOL_DEG = 1e-2


def same_pipeline_row(got, want, skip=()):
    """Printed ``--pipeline`` rows: the same keys; the homography errors'
    medians within 1e-3 relative (an f32 SVD fit), the pose errors' within
    that or POSE_ATOL_DEG, the other medians (rounded to 3 decimals) within a
    unit of the last; an AUC at threshold t moves by at most (error change)
    / t for the errors under t, so the AUCs and mAAs within that bound (t 1
    px, 5 degrees) and a unit of their 4th decimal."""
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if key in skip:
            continue
        pose = "pose" in key
        if w is None or g is None or isinstance(w, str):
            assert g == w, key
        elif "@" in key or "mAA" in key:
            bound = POSE_ATOL_DEG / 5.0 if pose else FIT_RTOL
            np.testing.assert_allclose(g, w, rtol=0, atol=bound + 1.01e-4, err_msg=key)
        elif "error" in key:
            np.testing.assert_allclose(g, w, rtol=FIT_RTOL,
                                       atol=POSE_ATOL_DEG if pose else 1.01e-3, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1.01e-3, err_msg=key)
