"""Resuming a training run of the JAX package in the port, on the CPU.

The JAX package trains the tiny configuration of
tests/test_torch_port_train.py for 2 steps and saves ``{"params", "opt"}``
with its own ``save_checkpoint`` (orbax); ``tools/orbax_to_msgpack.py``
converts the directory; the port's ``auto_resume`` restores it into a model
of other weights, ``ClippedAdamW`` and its ``LambdaLR``. The parameters and
Adam's moments are held to JAX's bit for bit, the step count and the
schedule's count exactly, the learning rate within 1e-5 relative (JAX
computes its schedule in f32); the third step in both packages at
tests/test_torch_port_train.py's tolerances for a train step (the loss within
1e-4 relative, each camera parameter within 1e-2 of the step's learning
rate, elements whose gradient is under 1e-5 of their tensor's largest
within the step's learning rate). The converted file is flax's layout of
JAX's tree, leaf for leaf, and ``chip_smoke.jax_train_state`` (which writes
that layout on the card's machine, where there is no orbax) gives the same
tree from the restored port state.
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import chip_smoke  # noqa: E402
from comet_tpu.geometry import cameras as jcam
from comet_tpu.models import COMET as JaxCOMET
from comet_tpu.training import checkpoints as jck
from comet_tpu.training import loop as jloop
from comet_tpu.training import optim as joptim
from comet_tpu_torch.models import build_comet
from comet_tpu_torch.training import (
    auto_resume, build_optimizer, build_train_step, camera_only_mask, restore_checkpoint,
)
from comet_tpu_torch.utils.serialization import read_msgpack
from comet_tpu_torch.weights import params_from_jax, state_dict_from_flax
from test_torch_port_models import _jax_params
from test_torch_port_train import _OPT, _batch, _configs, _one_torch_thread  # noqa: F401
from test_torch_port_train import _torch_batch

_TOOLS = os.path.join(_REPO, "tools")


def _converter():
    import importlib.util

    spec = importlib.util.spec_from_file_location("orbax_to_msgpack",
                                                  os.path.join(_TOOLS, "orbax_to_msgpack.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's 2 steps saved with orbax and converted, its third step, and the
    flax layout of the saved tree."""
    from flax import serialization

    jc, tc = _configs()
    batch = _batch(jc, seed=3)
    images, queries, cams = batch
    params = _jax_params(jc, images, queries, seed=5)
    tx, schedule = joptim.build_optimizer({"params": params}, **_OPT)
    step = jloop.build_train_step(JaxCOMET(jc), jc, tx)
    state = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    opt_state = tx.init(state)
    gt = jax.tree_util.tree_map(lambda f: f[None], jcam.make_camera_set(**cams))
    for _ in range(2):
        state, opt_state, _ = step(state, opt_state, jnp.asarray(images), jnp.asarray(queries), gt)
    ckpt_dir = str(tmp_path_factory.mktemp("jax_ckpt"))
    saved = {"params": state, "opt": opt_state}
    jck.save_checkpoint(ckpt_dir, 1, saved)
    flax_tree = _np_tree(serialization.to_state_dict(saved))
    path = os.path.join(ckpt_dir, "ckpt_000001")
    orbax_only = str(tmp_path_factory.mktemp("orbax_only") / "ckpt_000001")
    shutil.copytree(path, orbax_only)
    _converter().main([path])
    after2 = _np_tree(state["params"])
    state, opt_state, aux = step(state, opt_state, jnp.asarray(images), jnp.asarray(queries), gt)
    return dict(jc=jc, tc=tc, batch=batch, ckpt_dir=ckpt_dir, path=path, orbax_only=orbax_only,
                flax_tree=flax_tree, after2=after2, after3=_np_tree(state["params"]),
                loss3=float(aux["loss"]), lrs=[float(schedule(i)) for i in range(3)])


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        if not tree:
            out[prefix] = "{}"
        return out
    return {prefix: np.asarray(tree)}


def _same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, str):
            assert isinstance(got[k], str), k
        else:
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=str(k))


def test_converter_writes_flax_layout_of_the_saved_tree(jax_run):
    """``state.msgpack`` is flax's ``to_state_dict`` of the tree JAX saved,
    leaf for leaf (optax's states as maps of their fields, tuples as
    {"0": ...}, masked-out leaves and empty states as {})."""
    _same_tree(read_msgpack(os.path.join(jax_run["path"], "state.msgpack")), jax_run["flax_tree"])


def _port_state(tc, seed=9):
    model = build_comet(tc, device="cpu", seed=seed)  # other weights until restored
    optimizer, scheduler = build_optimizer(model, **_OPT)
    return model, optimizer, scheduler


@pytest.fixture(scope="module")
def resumed(jax_run):
    model, optimizer, scheduler = _port_state(jax_run["tc"])
    start, state = auto_resume(jax_run["ckpt_dir"], {"model": model, "optimizer": optimizer,
                                                     "scheduler": scheduler, "epoch": -1})
    return dict(model=model, optimizer=optimizer, scheduler=scheduler, start=start, state=state)


def test_restore_is_jax_state_bit_for_bit(jax_run, resumed):
    """Every parameter and both Adam moments of every camera parameter as
    JAX's after 2 steps, bit for bit; the step and the schedule's count 2,
    the epoch the directory's, the learning rate JAX's schedule at 2."""
    model, optimizer, scheduler = resumed["model"], resumed["optimizer"], resumed["scheduler"]
    assert resumed["start"] == 2 and resumed["state"]["epoch"] == 1
    want = params_from_jax({"params": jax_run["after2"]}, jax_run["tc"])
    for name, p in model.state_dict().items():
        assert torch.equal(p, want[name]), name
    opt = jax_run["flax_tree"]["opt"]["inner_states"]["train"]["inner_state"]["1"]
    names = {id(p): n for n, p in model.named_parameters()}
    held = [p for g in optimizer.param_groups for p in g["params"]]
    shapes = {names[id(p)]: tuple(p.shape) for p in held}
    mask = camera_only_mask(model)
    assert set(shapes) == {n for n, m in mask.items() if m}
    for key, moment in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        want = state_dict_from_flax(opt["0"][moment], shapes)
        for p in held:
            assert torch.equal(optimizer.state[p][key], want[names[id(p)]]), (key, names[id(p)])
    assert {float(optimizer.state[p]["step"]) for p in held} == {2.0}
    assert int(opt["0"]["count"]) == int(opt["2"]["count"]) == 2
    assert scheduler.last_epoch == 2
    lr = optimizer.param_groups[0]["lr"]
    assert lr == scheduler.get_last_lr()[0]
    assert lr == pytest.approx(jax_run["lrs"][2], rel=1e-5)


def test_the_state_written_back_is_the_converted_tree(jax_run, resumed):
    """``chip_smoke.jax_train_state`` of the restored state is the converted
    file's tree, leaf for leaf: the inverse of the mapping."""
    got = chip_smoke.jax_train_state(resumed["model"], resumed["optimizer"], resumed["scheduler"])
    _same_tree(got, read_msgpack(os.path.join(jax_run["path"], "state.msgpack")))


def test_third_step_after_resume_matches_jax(jax_run):
    """The step after the resume in both packages: the loss within 1e-4
    relative; camera parameters within 1e-2 x the step's learning rate, and
    those whose gradient is under 1e-5 of their tensor's largest (rounding
    noise that Adam's normalized step scales up) within the learning rate."""
    tc = jax_run["tc"]
    model, optimizer, scheduler = _port_state(tc)
    restore_checkpoint(jax_run["path"], {"model": model, "optimizer": optimizer,
                                         "scheduler": scheduler})
    step = build_train_step(model, tc, optimizer, scheduler)
    unresolved = {}

    def mark(part):
        if part == "backward":
            unresolved.update({n: p.grad.abs() < 1e-5 * p.grad.abs().max()
                               for n, p in model.named_parameters() if p.grad is not None})

    aux = step(*_torch_batch(jax_run["batch"]), mark=mark)
    assert float(aux["loss"]) == pytest.approx(jax_run["loss3"], rel=1e-4)
    want = params_from_jax({"params": jax_run["after3"]}, tc)
    before = params_from_jax({"params": jax_run["after2"]}, tc)
    lr = jax_run["lrs"][2]
    mask = camera_only_mask(model)
    for name, p in model.state_dict().items():
        if not mask[name]:
            assert torch.equal(p, want[name]), name
            continue
        off = unresolved[name]
        np.testing.assert_allclose(p[~off].numpy(), want[name][~off].numpy(), atol=1e-2 * lr,
                                   rtol=0, err_msg=name)
        for moved in (p[off], want[name][off]):
            assert ((moved - before[name][off]).abs() <= 1.01 * lr).all(), name


def test_params_only_restore_and_the_cli_checkpoint(jax_run):
    """A target of the model alone takes the parameters (``cli.py
    --checkpoint ckpt_NNNNNN`` restores so)."""
    from comet_tpu_torch import cli

    model = build_comet(jax_run["tc"], device="cpu", seed=4)
    restore_checkpoint(jax_run["path"], {"model": model})
    want = params_from_jax({"params": jax_run["after2"]}, jax_run["tc"])
    assert all(torch.equal(p, want[n]) for n, p in model.state_dict().items())
    got = cli._init_model(jax_run["tc"], seed=4, checkpoint=jax_run["path"], inference=False,
                          device="cpu")
    assert all(torch.equal(p, want[n]) for n, p in got.state_dict().items())
    with pytest.raises(KeyError):
        restore_checkpoint(jax_run["path"], {"model": model, "stats": {}})


def test_an_unconverted_orbax_directory_raises_with_the_tool(jax_run, tmp_path):
    """A directory with orbax's files and no ``state.msgpack`` raises,
    naming the converter's command line; auto_resume too; an empty
    directory has no checkpoint."""
    model, optimizer, scheduler = _port_state(jax_run["tc"])
    assert not os.path.exists(os.path.join(jax_run["orbax_only"], "state.msgpack"))
    with pytest.raises(ValueError, match="python tools/orbax_to_msgpack.py .*ckpt_000001"):
        restore_checkpoint(jax_run["orbax_only"], {"model": model})
    with pytest.raises(ValueError, match="orbax_to_msgpack"):
        auto_resume(os.path.dirname(jax_run["orbax_only"]),
                    {"model": model, "optimizer": optimizer, "scheduler": scheduler})
    os.makedirs(tmp_path / "ckpt_000003")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "ckpt_000003"), {"model": model})
