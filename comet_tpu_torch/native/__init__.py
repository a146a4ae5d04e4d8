"""ctypes bindings of the native (C++) IO core, built at first use.

Counterpart of ``comet_tpu/native/__init__.py``, with its functions and
their contract. ``cometio.cpp`` (libjpeg/libpng decode, PIL-bit-exact
8-bit Lanczos crop-resample, threaded mask and sequence loaders) is host
code, not a kernel: it is compiled with ``g++`` the first time it is needed
into ``comet_tpu_torch/_build/`` under a name that carries a digest of the
source and the flags, so a library built from another source is never
loaded. Each process compiles to a file of its own and publishes it with
``os.replace``, so ranks that race on the first build never open a half
written library.

``available()`` is False when the compiler or the codec headers and
libraries are missing, and ``build_error()`` then says why. Every other
function raises ``RuntimeError`` with that reason: nothing here falls back
to PIL (``data/native_loader.py`` and the CLI's ``--loader native`` raise
too).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "cometio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-lz")
BUILD_TIMEOUT_S = 300

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_C = ctypes.c_char_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)
_PU8 = ctypes.POINTER(ctypes.c_uint8)
_PF = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "cometio_image_size": [_C, _PI, _PI],
    "cometio_decode_rgb": [_C, _PU8, _LL, _PI, _PI],
    "cometio_crop_resize_lanczos": [_PU8, _I, _I, _I, _PI, _I, _PU8],
    "cometio_decode_gray": [_C, _PU8, _LL, _PI, _PI],
    "cometio_load_masks": [ctypes.POINTER(_C), _I, _I, _PI, _PU8, _LL, _PI, _PI],
    "cometio_load_sequence": [ctypes.POINTER(_C), _I, _PI, _I, _PF, _PF, _I, _PF],
    "cometio_decode_frames": [ctypes.POINTER(_C), _I, _I, _I, _I, _PU8],
}


def library_path() -> Path:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, *LIBS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcometio-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> Optional[str]:
    """Compile the source to ``lib``; the error's text, or None."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"{CXX} invocation failed: {exc!r}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{CXX} failed ({proc.returncode}): {proc.stderr[-2000:]}"
    os.replace(tmp, lib)
    return None


def _open(lib: Path) -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    try:
        return ctypes.CDLL(str(lib)), None
    except OSError as exc:
        return None, f"dlopen failed: {exc!r}"


@functools.lru_cache(maxsize=None)
def _load() -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    """(the loaded library, None) or (None, why it is not there). A library
    that is there but does not load (built on another machine, against codec
    libraries this one lacks) is built again."""
    lib = library_path()
    handle, err = _open(lib) if lib.exists() else (None, None)
    if handle is None:
        build_err = _build(lib)
        if build_err is not None:
            return None, build_err if err is None else f"{err}; built again: {build_err}"
        handle, err = _open(lib)
        if handle is None:
            return None, err
    handle.cometio_version.restype = ctypes.c_char_p
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle, None


def _lib() -> ctypes.CDLL:
    lib, err = _load()
    if lib is None:
        raise RuntimeError(f"cometio unavailable: {err}")
    return lib


def available() -> bool:
    """True when the native library is built (or builds now) and loads."""
    return _load()[0] is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (None when it is available)."""
    return _load()[1]


def version() -> str:
    return _lib().cometio_version().decode()


def _size(lib: ctypes.CDLL, path: str) -> Tuple[int, int]:
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.cometio_image_size(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"cometio_image_size({path}) -> {rc}")
    return w.value, h.value


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_PU8)


def _paths(paths: Sequence[str]):
    return (_C * len(paths))(*[p.encode() for p in paths])


def decode_rgb(path: str) -> np.ndarray:
    """Decode a JPEG/PNG file to an RGB uint8 array [H, W, 3]."""
    lib = _lib()
    w, h = _size(lib, path)
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.cometio_decode_rgb(path.encode(), _u8(out), out.nbytes,
                                ctypes.byref(ctypes.c_int(w)), ctypes.byref(ctypes.c_int(h)))
    if rc != 0:
        raise IOError(f"cometio_decode_rgb({path}) -> {rc}")
    return out


def crop_resize_lanczos(img: np.ndarray, box: Sequence[int], out_size: int) -> np.ndarray:
    """PIL-bit-exact ``img.crop(box).resize((out, out), LANCZOS)`` on uint8
    [H, W] or [H, W, C]."""
    lib = _lib()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    box_arr = np.ascontiguousarray(box, np.int32)
    if box_arr.shape != (4,):
        raise ValueError(f"crop_resize_lanczos: box {box} is not (x0, y0, x1, y1)")
    out = np.empty((out_size, out_size, ch), np.uint8)
    rc = lib.cometio_crop_resize_lanczos(_u8(img), h, w, ch, box_arr.ctypes.data_as(_PI),
                                         out_size, _u8(out))
    if rc != 0:
        raise ValueError(f"cometio_crop_resize_lanczos -> {rc}")
    return out[..., 0] if ch == 1 else out


def _pool_size(n_threads: int) -> int:
    """``n_threads``, or with 0 the CPUs this process may run on (the
    affinity mask, not the machine's count: oversubscribing a small
    container is slower than running serially)."""
    if n_threads > 0:
        return n_threads
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # not Linux
        return os.cpu_count() or 1


def decode_gray(path: str) -> np.ndarray:
    """Decode to 8-bit luma (PIL ``convert("L")`` parity) -> [H, W] uint8."""
    lib = _lib()
    w, h = _size(lib, path)
    out = np.empty((h, w), np.uint8)
    rc = lib.cometio_decode_gray(path.encode(), _u8(out), out.nbytes,
                                 ctypes.byref(ctypes.c_int(w)), ctypes.byref(ctypes.c_int(h)))
    if rc != 0:
        raise IOError(f"cometio_decode_gray({path}) -> {rc}")
    return out


def load_masks(paths: List[str], n_threads: int = 0):
    """Threaded mask decode: each mask's nonzero bbox and mask 0's pixels.

    Returns ``(bboxes [n, 4] float64, mask0 [H0, W0] uint8)`` with the bbox
    convention of ``datasets.mask_bbox`` (xmax and ymax exclusive, the whole
    image for an empty mask)."""
    lib = _lib()
    w0, h0 = _size(lib, paths[0])
    mask0 = np.empty((h0, w0), np.uint8)
    bboxes = np.empty((len(paths), 4), np.int32)
    rc = lib.cometio_load_masks(_paths(paths), len(paths), _pool_size(n_threads),
                                bboxes.ctypes.data_as(_PI), _u8(mask0), mask0.nbytes,
                                ctypes.byref(ctypes.c_int(w0)), ctypes.byref(ctypes.c_int(h0)))
    if rc != 0:
        raise IOError(f"cometio_load_masks -> {rc}")
    return bboxes.astype(np.float64), mask0


def decode_frames(paths: List[str], n_threads: int = 0) -> np.ndarray:
    """Threaded raw decode of same-sized frames -> uint8 [S, H, W, 3], no
    resampling: the host half of ``DevicePreprocessDataset(decode="native")``.
    Every frame must have frame 0's size."""
    lib = _lib()
    w, h = _size(lib, paths[0])
    out = np.empty((len(paths), h, w, 3), np.uint8)
    rc = lib.cometio_decode_frames(_paths(paths), len(paths), w, h, _pool_size(n_threads),
                                   _u8(out))
    if rc != 0:
        raise IOError(f"cometio_decode_frames -> {rc}")
    return out


def load_sequence(paths: List[str], box: Sequence[int], crop_size: int,
                  mean: np.ndarray = _IMAGENET_MEAN, std: np.ndarray = _IMAGENET_STD,
                  n_threads: int = 0) -> np.ndarray:
    """Threaded decode + crop + LANCZOS + normalize of a frame sequence ->
    float32 [S, crop, crop, 3], equal to the host PIL path
    (``datasets.VideoPoseDataset.load_sequence``) bit for bit."""
    lib = _lib()
    box_arr = np.ascontiguousarray(box, np.int32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.empty((len(paths), crop_size, crop_size, 3), np.float32)
    rc = lib.cometio_load_sequence(_paths(paths), len(paths), box_arr.ctypes.data_as(_PI),
                                   crop_size, mean.ctypes.data_as(_PF), std.ctypes.data_as(_PF),
                                   _pool_size(n_threads), out.ctypes.data_as(_PF))
    if rc != 0:
        raise IOError(f"cometio_load_sequence -> {rc}")
    return out
