"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so`` (the hash is of the
source, so an edited kernel is rebuilt), then loaded with ``ctypes``. Nothing
is built or loaded at import time: the first launch builds its library, and
``build_all`` builds every kernel at once, one ``nvcc`` process per source,
all started together.

Flags: ``-fmad=false`` and no ``--use_fast_math``. The NMS keep-mask must
round its IoU exactly like the JAX kernel (``inter / max(union, 1e-7)`` with
``union = area_i + area_j - inter``); a contracted FMA in the union changes
ties at the IoU threshold. The auction's bids and RoIAlign's blends are
held to their plain versions bit for bit on the same ground. ``-Xptxas -v``
reports registers and shared memory per kernel; the report is kept in
``BUILD_LOG``.

There is no fallback: a missing ``nvcc``, a failed build or a failed launch
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
KERNELS = ("nms", "auction", "topk", "roi_align")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin); the CUDA kernels "
            "are built from source at first use"
        )
    return path


def _source(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _lib_path(name: str) -> str:
    with open(_source(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _build(names: Sequence[str]) -> None:
    """Start one nvcc per source, all at once; wait for all; raise on any
    failure. Each writes a temporary file renamed into place when done, so
    another process building at the same time never loads half a library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _source(name)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_all(names: Sequence[str] = KERNELS) -> None:
    """Compile every kernel not yet built, all ``nvcc`` processes in parallel."""
    with _LOCK:
        _build([n for n in names
                if n not in _LIBS and not os.path.exists(_lib_path(n))])


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(_lib_path(name))
        return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


def stream_handle(device) -> int:
    """The current PyTorch CUDA stream on ``device``, as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
