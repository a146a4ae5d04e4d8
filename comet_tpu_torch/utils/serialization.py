"""Weight files and the one-time inference cast.

Counterpart of ``comet_tpu/utils/serialization.py``. The port writes its
weights as a ``torch.save``d state dict (``.pt``). It also reads the JAX
package's weight file, a flax ``.msgpack`` (``save_params_msgpack``), without
JAX, flax or the ``msgpack`` package: :func:`msgpack_restore` decodes the
subset of msgpack that ``flax.serialization.msgpack_serialize`` writes, and
:func:`load_params_msgpack` maps the tree onto the port's names through
``weights.state_dict_from_flax``. :func:`msgpack_serialize` writes that
subset, byte for byte as flax does for the same tree, so the JAX package
reads what the port writes: :func:`save_params_msgpack` (a module's weights as
the flax tree of its JAX counterpart) and the matcher checkpoints of
``matching.experiments``.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Union

import numpy as np
import torch
import torch.nn as nn

def cast_params_for_inference(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating parameter and buffer of ``model`` to ``dtype``
    once, in place; returns the model.

    The modules keep f32 masters and cast each weight at every use; for
    inference and its benchmarks the cast is done once here, with the same
    numbers (a cast of a cast is the cast), so each use's cast is a no-op.
    Training keeps the f32 masters."""
    for t in list(model.parameters()) + list(model.buffers()):
        if t.is_floating_point() and t.dtype != dtype:
            t.data = t.data.to(dtype)
    return model


def is_msgpack(path: str) -> bool:
    return path.endswith(".msgpack")


def check_gathered(model: nn.Module) -> None:
    """Raise if tensor parallelism left ``model`` a shard of its weights
    (``parallel.shard_params_tp``): a file of one rank's shards is no
    model's weights. ``training.save_checkpoint`` gathers them."""
    if any(getattr(m, "tp", None) is not None for m in model.modules()):
        raise ValueError("the model holds tensor-parallel shards (parallel.shard_params_tp); "
                         "training.save_checkpoint gathers them whole, or gather the whole "
                         "weights into an unsharded model first")


def save_params(path: str, model: nn.Module) -> str:
    """Save ``model``'s state dict to ``path`` (a ``.pt`` file), whole or not
    at all; returns the path. A ``.msgpack`` path (JAX's format:
    :func:`save_params_msgpack` writes one) and a tensor-parallel model
    raise."""
    if is_msgpack(path):
        raise ValueError(f"{path}: save_params writes its weights as .pt; save_params_msgpack "
                         "writes the JAX package's .msgpack")
    check_gathered(model)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(model.state_dict(), tmp)
    os.replace(tmp, path)
    return path


def load_params(path: str, model: nn.Module) -> nn.Module:
    """Load a state dict saved by :func:`save_params`, or the JAX package's
    ``.msgpack`` (:func:`load_params_msgpack`), into ``model`` in place (each
    tensor keeps the model's device and dtype); returns the model."""
    if is_msgpack(path):
        return load_params_msgpack(path, model)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return model


# ---------------------------------------------------------------------------
# flax's msgpack, read without JAX. msgpack_serialize writes maps with string
# keys, arrays, strings, binaries, booleans, integers, floats and three
# extension types: 1 an ndarray, itself a msgpack (shape, dtype name, C-order
# bytes); 2 a complex (real, imag); 3 a numpy scalar, as an ndarray of shape
# (). An array over flax's MAX_CHUNK_SIZE (2**30 bytes) is a map
# {"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
# {"0": flat part, ...}}. Everything else raises.
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30
_DTYPES = frozenset({"bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
                     "uint64", "float16", "float32", "float64", "complex64", "complex128"})
# fixed-size headers: tag -> (struct format of the length or value, kind)
_FIXED = {
    0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
    0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
    0xca: (">f", "value"), 0xcb: (">d", "value"),
    0xcc: (">B", "value"), 0xcd: (">H", "value"), 0xce: (">I", "value"), 0xcf: (">Q", "value"),
    0xd0: (">b", "value"), 0xd1: (">h", "value"), 0xd2: (">i", "value"), 0xd3: (">q", "value"),
    0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
    0xdc: (">H", "array"), 0xdd: (">I", "array"),
    0xde: (">H", "map"), 0xdf: (">I", "map"),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    """A cursor over the bytes of one msgpack document."""

    def __init__(self, data: memoryview, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated msgpack (needs {n} bytes at offset "
                             f"{self.pos} of {len(self.data)})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, allow_ext: bool = True) -> Any:
        tag = self.take(1)[0]
        if tag <= 0x7f:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8f:
            return self.map(tag & 0x0f, allow_ext)
        if 0x90 <= tag <= 0x9f:
            return [self.value(allow_ext) for _ in range(tag & 0x0f)]
        if 0xa0 <= tag <= 0xbf:
            return self.string(tag & 0x1f)
        if tag in (0xc2, 0xc3):
            return tag == 0xc3
        if tag in _FIXEXT and allow_ext:
            return self.ext(_FIXEXT[tag])
        if tag in _FIXED:
            fmt, kind = _FIXED[tag]
            n = self.unpack(fmt)
            if kind == "value":
                return n
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.string(n)
            if kind == "array":
                return [self.value(allow_ext) for _ in range(n)]
            if kind == "map":
                return self.map(n, allow_ext)
            if allow_ext:
                return self.ext(n)
        raise ValueError(f"{self.what}: msgpack type 0x{tag:02x} at offset {self.pos - 1} is not "
                         "one flax writes")

    def string(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int, allow_ext: bool) -> dict:
        out = {}
        for _ in range(n):
            key = self.value(allow_ext=False)
            if not isinstance(key, str):
                raise ValueError(f"{self.what}: a map key {key!r} is not a string")
            out[key] = self.value(allow_ext)
        return out

    def ext(self, n: int) -> Any:
        code = struct.unpack(">b", self.take(1))[0]
        payload = _Reader(self.take(n), self.what)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            out = payload.ndarray()
            return out.reshape(()) if code == _EXT_NPSCALAR else out
        if code == _EXT_COMPLEX:
            parts = payload.value(allow_ext=False)
            payload.end()
            if not (isinstance(parts, list) and len(parts) == 2):
                raise ValueError(f"{self.what}: a complex ext holds {parts!r}")
            return complex(*parts)
        raise ValueError(f"{self.what}: msgpack ext type {code} is not one flax writes")

    def ndarray(self) -> Union[np.ndarray, torch.Tensor]:
        """An ext-1 payload: a numpy array, or a torch bfloat16 tensor for
        flax's ``bfloat16`` (numpy has no such dtype without ml_dtypes)."""
        fields = self.value(allow_ext=False)
        self.end()
        if not (isinstance(fields, list) and len(fields) == 3):
            raise ValueError(f"{self.what}: an ndarray ext holds {len(fields)} fields, not 3")
        shape, name, buf = fields
        if isinstance(name, memoryview):
            name = bytes(name).decode("ascii")
        if not (isinstance(shape, list) and all(isinstance(d, int) and d >= 0 for d in shape)
                and isinstance(buf, memoryview)):
            raise ValueError(f"{self.what}: a malformed ndarray ext (shape {shape!r})")
        if name == "bfloat16":
            raw = np.frombuffer(buf, np.uint16).reshape(shape)
            return torch.from_numpy(raw.copy()).view(torch.bfloat16)
        if name not in _DTYPES:
            raise ValueError(f"{self.what}: ndarray dtype {name!r} is not one the port reads")
        dtype = np.dtype(name)
        if len(buf) != dtype.itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{self.what}: an ndarray of shape {shape} {name} holds "
                             f"{len(buf)} bytes")
        return np.frombuffer(buf, dtype).reshape(shape)

    def end(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} bytes after the msgpack "
                             "value")


def _packed_header(n: int, small: int, small_limit: int, tags: tuple) -> bytes:
    """A length header: ``small | n`` below ``small_limit``, else the first
    of ``tags`` (8-, 16-, 32-bit length; a tag of None is skipped) that holds n."""
    if small is not None and n < small_limit:
        return bytes([small | n])
    for tag, fmt in zip(tags, (">B", ">H", ">I")):
        if tag is not None and n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: a length of {n} is too long")


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for tag, fmt in ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"), (0xcf, ">Q")):
            if n < 1 << (8 * struct.calcsize(fmt)):
                return bytes([tag]) + struct.pack(fmt, n)
    else:
        for tag, fmt in ((0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"), (0xd3, ">q")):
            if n >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: the integer {n} is out of range")


def _pack_ext(code: int, payload: bytes) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    n = len(payload)
    head = bytes([fixed[n]]) if n in fixed else _packed_header(n, None, 0, (0xc7, 0xc8, 0xc9))
    return head + struct.pack(">b", code) + payload


def _ndarray_payload(arr: Union[np.ndarray, torch.Tensor]) -> bytes:
    """An ext-1 payload: msgpack of (shape, dtype name, C-order bytes)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().contiguous()
        if arr.dtype == torch.bfloat16:
            shape, name, buf = list(arr.shape), "bfloat16", arr.view(torch.int16).numpy().tobytes()
        else:
            return _ndarray_payload(arr.numpy())
    else:
        if arr.dtype.name not in _DTYPES:
            raise ValueError(f"msgpack: ndarray dtype {arr.dtype.name!r} is not one flax writes")
        shape, name, buf = list(arr.shape), arr.dtype.name, arr.tobytes("C")
    out = bytearray([0x93])
    _pack_value([int(d) for d in shape], out)
    _pack_value(name, out)
    out += _packed_header(len(buf), None, 0, (0xc4, 0xc5, 0xc6)) + buf
    return bytes(out)


def _pack_value(x: Any, out: bytearray) -> None:
    if x is True or x is False:
        out.append(0xc3 if x else 0xc2)
    elif type(x) is int:
        out += _pack_int(x)
    elif type(x) is float:
        out += b"\xcb" + struct.pack(">d", x)
    elif type(x) is str:
        raw = x.encode("utf-8")
        out += _packed_header(len(raw), 0xa0, 32, (0xd9, 0xda, 0xdb)) + raw
    elif type(x) is bytes:
        out += _packed_header(len(x), None, 0, (0xc4, 0xc5, 0xc6)) + x
    elif type(x) is list:
        out += _packed_header(len(x), 0x90, 16, (None, 0xdc, 0xdd))
        for v in x:
            _pack_value(v, out)
    elif type(x) is dict:
        if not all(isinstance(k, str) for k in x):
            raise ValueError(f"msgpack: a map key of {sorted(map(repr, x))} is not a string")
        out += _packed_header(len(x), 0x80, 16, (None, 0xde, 0xdf))
        for k, v in x.items():
            _pack_value(k, out)
            _pack_value(v, out)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        out += _pack_ext(_EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        out += _pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif type(x) is complex:
        payload = bytearray([0x92])
        _pack_value(x.real, payload)
        _pack_value(x.imag, payload)
        out += _pack_ext(_EXT_COMPLEX, bytes(payload))
    else:
        raise TypeError(f"msgpack: a {type(x).__name__} is not a leaf flax writes")


def _chunked(tree: Any) -> Any:
    """flax's chunked form of every array over MAX_CHUNK_SIZE bytes."""
    if isinstance(tree, dict):
        return {k: _chunked(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        flat = tree.reshape(-1)
        step = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        chunks = [flat[i:i + step] for i in range(0, flat.size, step)]
        return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def msgpack_serialize(tree: Dict[str, Any]) -> bytes:
    """A tree of dicts with string keys and array, scalar or string leaves as
    ``flax.serialization.to_bytes`` writes it (the same bytes): maps in
    their order, numpy arrays and torch tensors (bf16 too) as ext type 1, numpy scalars
    as ext 3, arrays over flax's MAX_CHUNK_SIZE in its chunked form. Raises
    on anything else."""
    out = bytearray()
    _pack_value(_chunked(tree), out)
    return bytes(out)


def save_params_msgpack(path: str, params) -> str:
    """Write a flax tree, or a module's weights as the flax variables of its
    JAX counterpart (``weights.module_params_to_jax``), as the JAX package's
    ``save_params_msgpack`` writes them (``flax.serialization.to_bytes``'s
    bytes, streamed), whole or not at all; returns the path."""
    if isinstance(params, nn.Module):
        from ..weights import module_params_to_jax

        check_gathered(params)
        params = module_params_to_jax(params)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _pack_value(_chunked(params), _FileSink(f))
    os.replace(tmp, path)
    return path


class _FileSink:
    """The ``+=`` and ``append`` of the packer's bytearray, onto a file: the
    document streams out and is never held whole (a full-width COMET's is
    1 GB)."""

    def __init__(self, f):
        self.f = f

    def __iadd__(self, data):
        self.f.write(data)
        return self

    def append(self, byte: int) -> None:
        self.f.write(bytes((byte,)))


def _unchunk(tree: Any, what: str) -> Any:
    """flax's chunked form of an oversized array back to the array."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED not in tree:
        return {k: _unchunk(v, what) for k, v in tree.items()}
    if set(tree) != {_CHUNKED, "shape", "chunks"}:
        raise ValueError(f"{what}: a chunked array holds {sorted(tree)}")
    shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
    chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
    if all(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def msgpack_restore(data: bytes, what: str = "msgpack") -> Dict[str, Any]:
    """The tree a flax ``msgpack_serialize`` wrote (``flax.serialization.
    msgpack_restore``'s result): nested dicts whose leaves are numpy arrays
    (bfloat16: torch tensors), numbers and strings. Raises ``ValueError``
    on a truncated document, bytes after it, and anything flax does not
    write; ``what`` names the source in the messages."""
    reader = _Reader(memoryview(data), what)
    tree = reader.value()
    reader.end()
    if not isinstance(tree, dict):
        raise ValueError(f"{what}: the document is a {type(tree).__name__}, not a flax tree")
    return _unchunk(tree, what)


def read_msgpack(path: str) -> Dict[str, Any]:
    """:func:`msgpack_restore` of a file."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read(), path)


def load_params_msgpack(path: str, model_or_cfg) -> Union[nn.Module, Dict[str, torch.Tensor]]:
    """The JAX package's weight file (``save_params_msgpack``: a flax tree
    of the COMET's parameters) mapped onto the port's names by
    ``weights.state_dict_from_flax``, which raises on a leaf of no port
    parameter, a shape that differs or a parameter left unfilled. Given a
    model, loads the weights into it in place and returns it; given a
    config, returns the state dict."""
    from ..weights import module_params_from_jax, state_dict_from_flax

    tree = read_msgpack(path)
    if isinstance(model_or_cfg, nn.Module):
        model_or_cfg.load_state_dict(module_params_from_jax(tree, model_or_cfg))
        return model_or_cfg
    from ..models.comet import build_comet

    return state_dict_from_flax(tree, build_comet(model_or_cfg, device="meta").state_dict())
