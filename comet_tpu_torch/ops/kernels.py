"""Build and load the port's hand-written CUDA kernels.

The sources under ``comet_tpu_torch/csrc`` are compiled with ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together) and linked into
one shared library with a plain C interface, which is loaded with ``ctypes``.
The build runs at first use, from the checkout's sources only, into
``comet_tpu_torch/_build/`` (listed in ``.gitignore``); the library's name
carries a hash of the sources and flags, so an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("attn.cu", "block.cu", "short_attn.cu", "cross_block.cu", "norm.cu")
HEADERS = ("mma.cuh", "block_common.cuh", "hopper.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "comet_attn_fwd": (
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _LL, _LL, _LL, _LL,
         ctypes.c_float, _P],
        _I,
    ),
    "comet_attn_form_fwd": (
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _LL, _LL, _LL, _LL,
         ctypes.c_float, _I, _P],
        _I,
    ),
    "comet_attn_block_fwd": (
        [_P] * 10 + [_I] * 6 + [_P, _P],
        _I,
    ),
    "comet_short_attn_fwd": (
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _LL, _LL, _LL, _LL,
         ctypes.c_float, _I, _I, _I, _P],
        _I,
    ),
    "comet_short_attn_resident": ([_I] * 4, _I),
    "comet_cross_block_fwd": (
        [_P] * 16 + [_I] * 8 + [_P, _P],
        _I,
    ),
    "comet_cross_block_clusters": ([_I, _I], _I),
    "comet_layer_norm_fwd": (
        [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _I, _I, _P],
        _I,
    ),
    "comet_layer_norm_resident": ([_I] * 5, _I),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if the library for these sources is missing, and
    return the library's path. The compiler's output is printed on failure,
    and kept beside the library (``ptxas_report``) on success."""
    lib = BUILD_DIR / f"libcomet_kernels-{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed, report = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            report.append(out)
            if proc.returncode:
                print(f"[nvcc {src}]\n{out}", flush=True)
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}")
        tmp_lib = Path(tmp) / lib.name
        subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)],
            check=True,
        )
        lib.with_suffix(".ptxas.txt").write_text("".join(report))
        os.replace(tmp_lib, lib)
    return lib


def ptxas_report() -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of every
    kernel in the built library, from ptxas's report of the build."""
    text = build().with_suffix(".ptxas.txt").read_text()
    rows, name, spills = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return rows


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream(index: int) -> int:
    """The handle of the current stream on CUDA card ``index``, for a launch
    (without building a ``torch.cuda.Stream`` object on every call)."""
    return torch._C._cuda_getCurrentRawStream(index)


def check_launch(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a failed launch."""
    if rc == -1:
        raise ValueError(f"{name}: the kernel does not take these arguments")
    if rc == -2:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled refused a TMA tensor map")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
