"""The port's reader of flax ``.msgpack`` weight files, without JAX.

Files are written by this host's flax (``comet_tpu.utils.serialization.
save_params_msgpack``, ``flax.serialization.msgpack_serialize``) and read
by ``comet_tpu_torch.utils.serialization``'s own decoder; every comparison
is exact: f32 leaves bit for bit, bf16 leaves bit for bit as bf16 (and so
after the exact widening into the port's f32 parameters), and flax's
chunked form of an array over its ``MAX_CHUNK_SIZE`` (lowered here by
``monkeypatch`` so that a tiny tree holds one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fser

import comet_tpu.config as jcfg
import comet_tpu_torch.config as tcfg
from comet_tpu.utils.serialization import save_params_msgpack
from comet_tpu_torch.models import build_comet
from comet_tpu_torch.utils import serialization as tser
from comet_tpu_torch.weights import params_from_jax
from test_torch_port_models import _jax_params, _tiny


@pytest.fixture(scope="module")
def tree():
    """The tiny COMET's flax parameter tree (random numpy values)."""
    jc = _tiny(jcfg)
    s, hw, n = jc.seqlen, jc.img_size, jc.track_num
    params = _jax_params(jc, np.zeros((1, s, hw, hw, 3), np.float32),
                         np.full((1, n, 2), hw / 2.0, np.float32), seed=23)
    return {"params": params}


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return jnp.asarray(tree, dtype) if dtype == "bfloat16" else np.asarray(tree, dtype)


def _bf16(tree):
    return _cast(tree, "bfloat16")


def _as_torch(tree):
    """A flax tree's leaves as torch tensors (bfloat16 through f32, exact)."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_jax_weight_file_loads_bit_for_bit(tree, tmp_path, dtype):
    saved = _cast(tree, dtype)
    path = str(tmp_path / "w.msgpack")
    save_params_msgpack(path, saved)
    tc = _tiny(tcfg)
    want = params_from_jax(_as_torch(saved), tc)
    got = tser.load_params_msgpack(path, tc)
    assert got.keys() == want.keys() and len(got) > 100
    for k in want:
        assert got[k].dtype == getattr(torch, dtype) and torch.equal(got[k], want[k]), k
    model = tser.load_params(path, build_comet(tc, device="cpu"))
    for k, p in model.state_dict().items():
        assert p.dtype == torch.float32 and torch.equal(p, want[k].float()), k


def test_a_chunked_leaf_loads(tree, tmp_path, monkeypatch):
    """With flax's chunk size lowered to 4 KiB, every leaf over it is
    written in chunks and read back whole."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 4096)
    path = str(tmp_path / "w.msgpack")
    saved = {"params": dict(_cast(tree, "float32")["params"])}
    saved["params"]["bf16_probe"] = _bf16({"x": np.arange(5000, dtype=np.float32)})
    save_params_msgpack(path, saved)
    with open(path, "rb") as f:
        raw = f.read()
    assert raw.count(b"__msgpack_chunked_array__") > 10
    got = tser.read_msgpack(path)
    want = fser.msgpack_restore(raw)
    probe = got["params"].pop("bf16_probe")["x"]
    assert probe.dtype == torch.bfloat16 and torch.equal(
        probe, torch.arange(5000, dtype=torch.float32).to(torch.bfloat16))
    want["params"].pop("bf16_probe")
    flat = params_from_jax(got, _tiny(tcfg))
    for k, v in params_from_jax(want, _tiny(tcfg)).items():
        assert torch.equal(flat[k], v), k


def test_the_decoder_reads_what_flax_writes():
    """Every type flax's msgpack_serialize writes, against flax's own
    msgpack_restore: ints of every width, floats, strings, booleans,
    lists, complex numbers, numpy scalars and arrays of every dtype the
    port reads, including an empty one."""
    src = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -129, -40000,
                 -2 ** 40],
        "floats": [0.5, -1e300, float("inf")], "text": "é" * 40, "long": "x" * 70000,
        "flag": True, "z": 1.5 - 2j, "scalar": np.float32(2.5), "i64": np.int64(-7),
        "nested": {str(i): {"leaf": np.full((i + 1, 2), i, np.int16)} for i in range(20)},
        "arrays": {d: np.arange(6).reshape(2, 3).astype(d) for d in
                   ("bool", "int8", "int32", "uint8", "uint64", "float16", "float64",
                    "complex64")},
        "empty": np.zeros((0, 3), np.float32),
    }
    raw = fser.msgpack_serialize(src)
    got, want = tser.msgpack_restore(raw), fser.msgpack_restore(raw)

    def same(a, b, where):
        if isinstance(b, dict):
            assert isinstance(a, dict) and a.keys() == b.keys(), where
            for k in b:
                same(a[k], b[k], f"{where}/{k}")
        elif isinstance(b, (list, tuple)):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}/{i}")
        elif isinstance(b, (np.ndarray, np.generic)):
            b = np.asarray(b)
            assert np.asarray(a).dtype == b.dtype and np.array_equal(a, b), where
        else:
            assert type(a) is type(b) and a == b, where

    same(got, want, "")


@pytest.mark.parametrize("fault", ["truncated", "trailing", "foreign", "ext", "dtype", "not a map",
                                   "nil", "bad size"])
def test_a_damaged_or_foreign_file_raises(tree, tmp_path, fault):
    raw = fser.msgpack_serialize({"a": np.ones((2, 2), np.float32), "b": 1})
    if fault == "truncated":
        raw = raw[:-5]
    elif fault == "trailing":
        raw = raw + b"\x00"
    elif fault == "foreign":
        path = str(tmp_path / "w.pt")
        torch.save({"a": torch.ones(2)}, path)
        with open(path, "rb") as f:
            raw = f.read()
    elif fault == "ext":
        raw = b"\x81\xa1a\xd4\x05\x00"  # {"a": ext type 5}
    elif fault == "dtype":
        inner = b"\x93\x91\x01\xa6object\xc4\x08" + b"\x00" * 8
        raw = b"\x81\xa1a\xc7" + bytes([len(inner)]) + b"\x01" + inner
    elif fault == "not a map":
        raw = b"\x92\x01\x02"
    elif fault == "nil":
        raw = b"\x81\xa1a\xc0"
    else:
        inner = b"\x93\x91\x03\xa7float32\xc4\x08" + b"\x00" * 8  # 3 floats in 8 bytes
        raw = b"\x81\xa1a\xc7" + bytes([len(inner)]) + b"\x01" + inner
    with pytest.raises(ValueError):
        tser.msgpack_restore(raw, "w.msgpack")


def test_a_tree_of_another_model_raises(tree, tmp_path):
    path = str(tmp_path / "w.msgpack")
    params = dict(tree["params"])
    params["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    save_params_msgpack(path, {"params": params})
    with pytest.raises(KeyError, match="extra.weight"):
        tser.load_params_msgpack(path, _tiny(tcfg))
    del params["extra"], params["camera_predictor"]
    save_params_msgpack(path, {"params": params})
    with pytest.raises(KeyError, match="not filled"):
        tser.load_params_msgpack(path, build_comet(_tiny(tcfg), device="cpu"))


def test_the_port_writes_no_msgpack(tmp_path):
    with pytest.raises(ValueError, match=r"\.pt"):
        tser.save_params(str(tmp_path / "w.msgpack"), torch.nn.Linear(2, 2))
