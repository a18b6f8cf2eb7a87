"""Where the CUDA kernels are built (counterpart of
``utils/compile_cache.py``).

The JAX package keeps a persistent XLA compilation cache so that a restarted
process, the serving daemon's failover above all, skips recompiling. The
port compiles nothing at run time except its hand-written kernels, which
``ops/_cuda.py`` builds with ``nvcc`` into ``BUILD_DIR`` as
``<name>-<hash of source and flags>.so``. A process whose ``BUILD_DIR``
already holds a kernel's library loads it and runs no ``nvcc``; this module
chooses that directory, in the JAX package's order (first hit wins):

  1. the explicit ``path`` argument (CLI ``--compile-cache``),
  2. the ``W2T_COMPILE_CACHE`` environment variable,
  3. the package's ``_build/`` (listed in ``.gitignore``).

``off`` (from any source) gives a temporary directory of this process's own,
removed at exit, so every kernel is built anew.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Optional

from waymo_2d_tracking_tpu_torch.ops import _cuda

_ENV_VAR = "W2T_COMPILE_CACHE"
DEFAULT_DIR = _cuda.BUILD_DIR


def resolve_cache_dir(path: Optional[str] = None) -> Optional[str]:
    """The build directory per the module docstring; None means 'off'."""
    raw = path or os.environ.get(_ENV_VAR) or DEFAULT_DIR
    if raw.strip().lower() == "off":
        return None
    return os.path.abspath(os.path.expanduser(raw))


def enable_compile_cache(path: Optional[str] = None) -> str:
    """Point ``ops/_cuda.py`` at the resolved build directory and return it.
    Call it before the first kernel launch: a library already loaded stays
    loaded from where it was built."""
    cache_dir = resolve_cache_dir(path)
    if cache_dir is None:
        cache_dir = tempfile.mkdtemp(prefix="w2t-kernels-")
        atexit.register(shutil.rmtree, cache_dir, True)
    os.makedirs(cache_dir, exist_ok=True)
    _cuda.BUILD_DIR = cache_dir
    return cache_dir


def built_kernels(cache_dir: Optional[str] = None) -> list:
    """Names of the kernels whose current source has a library in
    ``cache_dir`` (default: the active ``BUILD_DIR``)."""
    cache_dir = cache_dir or _cuda.BUILD_DIR
    return [n for n in _cuda.KERNELS
            if os.path.exists(os.path.join(cache_dir, os.path.basename(_cuda._lib_path(n))))]
