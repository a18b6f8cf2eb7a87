"""Build and load the host-side C++ shims of ``native/`` (the JPEG decode
pool and the TFRecord scanner) for the port.

Each shim is compiled from its source in ``native/`` by ``g++`` into
``waymo_2d_tracking_tpu_torch/_build/<name>-<hash>.so`` at first use (the
hash is of the source and the flags, so an edited source is rebuilt), then
loaded with ``ctypes``. Nothing is built under ``native/``, and no ``make``
runs there. A build writes a temporary file renamed into place when done, so
another process building at the same time never loads half a library.

There is no fallback: a missing compiler or library, a failed build or a
failed ``dlopen`` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
# shim name -> (source in native/, link flags), as native/Makefile builds them
SHIMS = {
    "w2t_jpeg": ("jpeg_decode.cpp", ("-ljpeg", "-lpthread")),
    "w2t_tfrecord": ("tfrecord_reader.cpp", ()),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def lib_path(name: str) -> str:
    source, libs = SHIMS[name]
    with open(os.path.join(NATIVE_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXXFLAGS + libs).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile shim ``name`` into ``_build/`` unless built; returns the path."""
    out = lib_path(name)
    if os.path.exists(out):
        return out
    source, libs = SHIMS[name]
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++) to build native/{source}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXXFLAGS, os.path.join(NATIVE_DIR, source), "-o", tmp, *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        needs = f" (it needs {' '.join(libs)} and their headers)" if libs else ""
        raise RuntimeError(f"building native/{source} failed{needs}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, configure: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build (if needed), ``dlopen`` and configure shim ``name``; cached."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build(name)
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:    # e.g. a library it links against is missing
                raise RuntimeError(f"loading {path} failed: {e}") from e
            configure(lib)
            _LIBS[name] = lib
        return lib
