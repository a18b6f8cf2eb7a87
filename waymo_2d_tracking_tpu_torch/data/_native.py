"""Build and load the host-side C++ shims of ``native/`` (the JPEG decode
pool and the TFRecord scanner) for the port.

Each shim is compiled from its source in ``native/`` by ``g++`` into
``waymo_2d_tracking_tpu_torch/_build/<name>-<hash>.so`` at first use (the
hash is of the source and the flags, so an edited source is rebuilt), then
loaded with ``ctypes``. Nothing is built under ``native/``, and no ``make``
runs there. A build writes a temporary file renamed into place when done, so
another process building at the same time never loads half a library.

The JPEG shim finds libjpeg in one of two places (``jpeg_route``): the
system's (``jpeglib.h`` on the compiler's include path, ``-ljpeg``) or,
only where the system has none, the libjpeg-turbo that the installed Pillow
carries in its ``pillow.libs/`` directory, linked by its full path and
compiled against the 62-ABI headers vendored in ``csrc/jpeg62/``. Both are
the same library (libjpeg-turbo, ABI 62); ``data/jpeg.py`` checks the
loaded shim's bytes on a known JPEG before it decodes anything.

There is no fallback to other code: a missing compiler or library, a failed
build or a failed ``dlopen`` raises.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.util
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
JPEG62_HEADERS = os.path.join(_PKG_DIR, "csrc", "jpeg62")

CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
# shim name -> (source in native/, link flags), as native/Makefile builds them
SHIMS = {
    "w2t_jpeg": ("jpeg_decode.cpp", ("-ljpeg", "-lpthread")),
    "w2t_tfrecord": ("tfrecord_reader.cpp", ()),
}
# where the compiler looks for a system jpeglib.h (besides $CPATH and
# $CPLUS_INCLUDE_PATH)
SYSTEM_INCLUDE_DIRS = ("/usr/local/include", "/usr/include",
                       "/usr/include/x86_64-linux-gnu", "/usr/include/aarch64-linux-gnu")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def system_jpeg_header() -> Optional[str]:
    """The system ``jpeglib.h`` the compiler would include, or None."""
    env = [d for var in ("CPATH", "CPLUS_INCLUDE_PATH")
           for d in os.environ.get(var, "").split(os.pathsep) if d]
    for d in env + list(SYSTEM_INCLUDE_DIRS):
        if os.path.exists(os.path.join(d, "jpeglib.h")):
            return os.path.join(d, "jpeglib.h")
    return None


def pillow_libjpeg() -> Optional[str]:
    """The libjpeg-turbo shared library bundled with the installed Pillow
    (``pillow.libs/libjpeg-<hash>.so.62*``), found without importing PIL."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.submodule_search_locations:
        return None
    site = os.path.dirname(list(spec.submodule_search_locations)[0])
    for libs in ("pillow.libs", "Pillow.libs"):
        hits = sorted(glob.glob(os.path.join(site, libs, "libjpeg*.so.62*")))
        if hits:
            return hits[0]
    return None


def jpeg_route() -> Tuple[str, Tuple[str, ...], Tuple[str, ...]]:
    """(route, compile flags, link flags) of the JPEG shim: the system
    libjpeg where its header is present, else Pillow's by full path."""
    source, libs = SHIMS["w2t_jpeg"]
    if system_jpeg_header() is not None:
        return "system", (), libs
    lib = pillow_libjpeg()
    if lib is None:
        raise RuntimeError(
            f"building native/{source} needs libjpeg: there is no jpeglib.h on "
            f"{', '.join(SYSTEM_INCLUDE_DIRS)} and no Pillow with a bundled libjpeg")
    return "pillow", ("-I", JPEG62_HEADERS), (
        lib, f"-Wl,-rpath,{os.path.dirname(lib)}", "-lpthread")


def _flags(name: str) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    if name == "w2t_jpeg":
        return jpeg_route()[1:]
    return (), SHIMS[name][1]


def lib_path(name: str) -> str:
    source = SHIMS[name][0]
    cflags, libs = _flags(name)
    with open(os.path.join(NATIVE_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXXFLAGS + cflags + libs).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile shim ``name`` into ``_build/`` unless built; returns the path."""
    out = lib_path(name)
    if os.path.exists(out):
        return out
    source = SHIMS[name][0]
    cflags, libs = _flags(name)
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++) to build native/{source}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXXFLAGS, *cflags, os.path.join(NATIVE_DIR, source),
                           "-o", tmp, *libs], capture_output=True, text=True)
    if proc.returncode != 0:
        needs = f" (it needs {' '.join(libs)} and their headers)" if libs else ""
        raise RuntimeError(f"building native/{source} failed{needs}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, configure: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build (if needed), ``dlopen`` and configure shim ``name``; cached.
    ``configure`` may raise to refuse the library (it is then not cached)."""
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
