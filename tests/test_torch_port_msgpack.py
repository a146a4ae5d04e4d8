"""The port's reader and writer of flax ``.msgpack`` files, without JAX.

Files are written by this host's flax (``comet_tpu.utils.serialization.
save_params_msgpack``, ``flax.serialization.msgpack_serialize``) and read
by ``comet_tpu_torch.utils.serialization``'s own decoder; every comparison
is exact: f32 leaves bit for bit, bf16 leaves bit for bit as bf16 (and so
after the exact widening into the port's f32 parameters), and flax's
chunked form of an array over its ``MAX_CHUNK_SIZE`` (lowered here by
``monkeypatch`` so that a tiny tree holds one). What the port writes
(``msgpack_serialize``, ``save_params_msgpack``) is byte for byte what
flax's ``to_bytes`` writes for the same tree, and reads back in flax.
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


def _encoder_tree():
    rng = np.random.default_rng(3)
    return {
        "params": {"dense": {"kernel": rng.normal(size=(3, 5)).astype(np.float32),
                             "bias": np.zeros(5, np.float32)},
                   "b_0": {"idx": np.arange(300, dtype=np.int64), "flag": np.array([True, False])},
                   "half": jnp.asarray(rng.normal(size=(2, 3)), jnp.bfloat16)},
        "opt": {"0": {"count": np.array(7, np.int32), "mu": {}, "scalar": np.float32(2.5)},
                "1": {}},
        "meta": {"name": "x" * 40, "ints": [0, 1, -5, -33, 127, 200, 300, -200, 70000, -70000,
                                             2 ** 40, -(2 ** 40)],
                 "pi": 3.25, "on": True, "off": False, "z": 1 + 2j,
                 "empty": np.zeros((0, 3), np.float32), "f64": np.ones((2, 2))},
    }


def _as_port(tree):
    """bfloat16 leaves as the torch tensors the port holds them in."""
    if isinstance(tree, dict):
        return {k: _as_port(v) for k, v in tree.items()}
    if hasattr(tree, "dtype") and tree.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(tree, np.float32)).to(torch.bfloat16)
    return tree


@pytest.mark.parametrize("chunk", [None, 512], ids=["whole", "chunked"])
def test_the_encoder_writes_what_flax_writes(monkeypatch, chunk):
    """``msgpack_serialize`` gives flax's bytes for the same tree: its
    ``msgpack_serialize`` of the tree as it is (maps in their order, every
    leaf type flax writes, bf16 from a torch tensor, lists, flax's chunked
    form over MAX_CHUNK_SIZE), and its ``to_bytes`` of a tree of maps and
    arrays (``to_bytes`` turns a list into a map); flax and the port's
    decoder read it back."""
    import copy

    tree = _encoder_tree()
    if chunk:
        monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(tser, "MAX_CHUNK_SIZE", chunk)
    want = fser.msgpack_serialize(copy.deepcopy(tree), in_place=True)
    got = tser.msgpack_serialize(_as_port(tree))
    assert got == want
    state = {k: v for k, v in tree.items() if k != "meta"}
    assert tser.msgpack_serialize(_as_port(state)) == fser.to_bytes(state)
    if chunk:
        assert got.count(b"__msgpack_chunked_array__") >= 1
    back = tser.msgpack_restore(got)
    np.testing.assert_array_equal(back["params"]["dense"]["kernel"], tree["params"]["dense"]["kernel"])
    assert back["opt"]["0"]["count"].dtype == np.int32 and int(back["opt"]["0"]["count"]) == 7
    assert back["meta"]["ints"] == tree["meta"]["ints"] and back["meta"]["z"] == 1 + 2j
    assert fser.msgpack_restore(got)["meta"]["name"] == "x" * 40
    for leaf in (object(), None):
        with pytest.raises(TypeError, match="not a leaf flax writes"):
            tser.msgpack_serialize({"x": leaf})
    with pytest.raises(ValueError, match="not a string"):
        tser.msgpack_serialize({1: np.zeros(2)})


def test_save_params_msgpack_writes_a_file_jax_loads(tmp_path):
    """A port module's weights written by ``save_params_msgpack``: JAX's
    ``load_params_msgpack`` restores them onto its own template bit for bit,
    and the port's ``load_params`` reads them back."""
    import jax

    from comet_tpu.matching.superglue import SuperGlueMatcher as JaxSuperGlue
    from comet_tpu.utils.serialization import load_params_msgpack
    from comet_tpu_torch.matching.superglue import SuperGlueMatcher
    from comet_tpu_torch.models.blocks import init_params

    port = SuperGlueMatcher(depth=1, dim=32, in_dim=16)
    init_params(port, torch.Generator().manual_seed(2))
    path = tser.save_params_msgpack(str(tmp_path / "sub" / "sg.msgpack"), port)
    x = jnp.zeros((4, 16))
    template = jax.eval_shape(JaxSuperGlue(depth=1, dim=32).init, jax.random.PRNGKey(0),
                              x[:, :2], x, x[:, :2], x)
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), template)
    restored = load_params_msgpack(path, template)
    from comet_tpu_torch.weights import module_params_from_jax

    sd = module_params_from_jax(jax.tree_util.tree_map(np.asarray, restored), port)
    for k, v in port.state_dict().items():
        assert torch.equal(sd[k], v), k
    again = SuperGlueMatcher(depth=1, dim=32, in_dim=16)
    tser.load_params(path, again)
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(),
                                                 port.state_dict().values()))
