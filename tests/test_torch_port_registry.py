"""The port's registry and named experiments against ``comet_tpu``'s: the
same 18 registered names with equal default configurations (the repair of
the placeholders that stood for the line stack), and each of the 11
experiments, cut to the tests' size (64 keypoints, 8 lines, matchers at
depth 2, width 32), built and run by ``match`` on a 64 x 64 pair on the CPU,
printing the keys of JAX's row.
"""

import copy
import json

import jax.numpy as jnp
import pytest

from comet_tpu.matching import benchmarks as jbench
from comet_tpu.matching import registry as jreg
from comet_tpu_torch import cli as tcli
from comet_tpu_torch.matching import configs as tconfigs
from comet_tpu_torch.matching import registry as treg
from torch_port_line_helpers import one_torch_thread  # noqa: F401

SIZE = 64


def test_registry_matches_jax():
    """The same 18 registered names with equal default configurations."""
    assert sorted(treg._REGISTRY) == sorted(jreg._REGISTRY)
    assert len(treg._REGISTRY) == 18
    assert treg._DEFAULTS == jreg._DEFAULTS


@pytest.fixture(scope="module")
def jax_row_keys():
    """The keys of JAX's ``match`` row (its benchmark over a stand-in
    pipeline: four fixed matches)."""
    kp = jnp.asarray([[8.0, 8.0], [50.0, 10.0], [12.0, 52.0], [40.0, 44.0]])

    def pipe(image0, image1):
        return {"feats0": {"keypoints": kp}, "feats1": {"keypoints": kp},
                "matches0": jnp.arange(4)}

    img = jnp.zeros((SIZE, SIZE, 1))
    row = jbench.run_homography_benchmark(pipe, [(img, img, jnp.eye(3))], estimator="dlt")
    return ["experiment", *row]


@pytest.mark.parametrize("name", sorted(tconfigs.EXPERIMENTS))
def test_every_experiment_runs_on_the_cpu(name, jax_row_keys, capsys, monkeypatch):
    """Each of the 11 named experiments, cut to the tests' size (64
    keypoints, 8 lines, matchers at depth 2, width 32), builds through
    ``build_pipeline(name, image_hw=(64, 64))`` (as ``match`` builds it) and
    runs a 64 x 64 pair: ``match`` prints JAX's keys, each a number or null."""
    exp = copy.deepcopy(tconfigs.EXPERIMENTS[name])
    if exp["extractor"]["name"] == "extractor_wireframe":
        exp["extractor"].update(point_conf={"max_keypoints": 64}, max_lines=8)
    else:
        exp["extractor"]["max_keypoints"] = 64
    if "depth" in exp["matcher"]:
        exp["matcher"].update(depth=2, dim=32)
    monkeypatch.setitem(tconfigs.EXPERIMENTS, name, exp)
    tcli.main(["match", "--device", "cpu", "--experiment", name, "--n-pairs", "1",
               "--image-size", str(SIZE)])
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert list(row) == jax_row_keys and row.pop("experiment") == name
    assert all(v is None or isinstance(v, float) for v in row.values())
