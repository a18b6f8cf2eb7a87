"""Batched JPEG decode on the host (counterpart of ``data/jpeg.py``): a ctypes
binding to ``native/jpeg_decode.cpp``, a persistent libjpeg thread pool that
decodes a whole chunk without the GIL into one (N, H, W, 3) uint8 RGB array,
built by ``data/_native.py``.

``scale_denom`` 2, 4 or 8 asks for libjpeg's DCT-scaled decode at 1/denom
(the output is ceil(src / denom)): a 1280x1920 Waymo frame decoded at 1/2
does about a quarter of the IDCT work. A frame that fails to decode or has
other dimensions stays zero.

There is no cv2 fallback (the port does not depend on cv2): where the shim
cannot be built or loaded, ``BatchJpegDecoder`` raises. A shim whose headers
and library disagree (a struct size or version mismatch makes libjpeg refuse
every frame, which the shim reports as frames left zero) would pass for a
stream of black frames, so a freshly loaded shim first decodes the committed
probe ``fixtures/jpeg_probe.jpg`` and is refused unless it gives the
probe's committed bytes.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
from typing import Sequence, Tuple

import numpy as np

from waymo_2d_tracking_tpu_torch.data import _native

SCALE_DENOMS = (1, 2, 4, 8)


def _configure(lib: ctypes.CDLL) -> None:
    lib.w2t_decoder_create.restype = ctypes.c_void_p
    lib.w2t_decoder_create.argtypes = [ctypes.c_int]
    lib.w2t_decoder_destroy.argtypes = [ctypes.c_void_p]
    lib.w2t_decode_batch_scaled.restype = ctypes.c_int
    lib.w2t_decode_batch_scaled.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]


def _check_probe(lib: ctypes.CDLL) -> None:
    """Decode the committed probe JPEG through ``lib``; raise unless it
    decodes to the committed bytes."""
    from waymo_2d_tracking_tpu_torch.weights import FIXTURES_DIR

    with open(os.path.join(FIXTURES_DIR, "ingest_fixture.json")) as f:
        probe = json.load(f)["probe"]
    with open(os.path.join(FIXTURES_DIR, probe["file"]), "rb") as f:
        blob = f.read()
    h, w = probe["height_width"]
    out = np.zeros((1, h, w, 3), np.uint8)
    handle = lib.w2t_decoder_create(1)
    try:
        ok = lib.w2t_decode_batch_scaled(
            handle, 1, (ctypes.c_char_p * 1)(blob), (ctypes.c_size_t * 1)(len(blob)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h * w * 3, h, w, 1, 1)
    finally:
        lib.w2t_decoder_destroy(handle)
    got = hashlib.sha256(out.tobytes()).hexdigest()
    if ok != 1 or got != probe["decoded_sha256"]:
        raise RuntimeError(
            f"the JPEG shim {_native.lib_path('w2t_jpeg')} does not decode the probe "
            f"{probe['file']} to its committed bytes (decoded {ok} of 1, SHA-256 {got[:16]} "
            f"against {probe['decoded_sha256'][:16]}): its libjpeg headers and library "
            "disagree")


def _configure_checked(lib: ctypes.CDLL) -> None:
    _configure(lib)
    _check_probe(lib)


def _load() -> ctypes.CDLL:
    return _native.load("w2t_jpeg", _configure_checked)


def jpeg_dims(blob: bytes) -> Tuple[int, int]:
    """Full-resolution (height, width) from the JPEG header, without a
    decode: a walk of the marker segments to the first start-of-frame.
    Raises ValueError on a non-JPEG or truncated stream."""
    if len(blob) < 4 or blob[0] != 0xFF or blob[1] != 0xD8:
        raise ValueError("not a JPEG stream (missing SOI marker)")
    i, n = 2, len(blob)
    while i + 3 < n:
        if blob[i] != 0xFF:          # stray byte between segments
            i += 1
            continue
        marker = blob[i + 1]
        if marker == 0xFF:           # fill byte
            i += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:   # standalone markers
            i += 2
            continue
        if marker == 0xDA:           # start of scan: a SOF comes before it
            break
        length = (blob[i + 2] << 8) | blob[i + 3]
        # SOF0..SOF15 carry the dimensions, except DHT (C4), JPG (C8), DAC (CC)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if i + 9 > n:
                break
            return ((blob[i + 5] << 8) | blob[i + 6], (blob[i + 7] << 8) | blob[i + 8])
        i += 2 + length
    raise ValueError("no SOF marker found in JPEG stream")


class BatchJpegDecoder:
    """Decode a list of JPEG byte strings into (N, height, width, 3) uint8 RGB
    in one call. ``(height, width)`` are the output dimensions, after the
    ``scale_denom`` scaled decode: ceil(source / denom)."""

    def __init__(self, height: int, width: int, n_threads: int = 0, scale_denom: int = 1):
        if scale_denom not in SCALE_DENOMS:
            raise ValueError(f"scale_denom must be one of {SCALE_DENOMS}, got {scale_denom}")
        self.height = height
        self.width = width
        self.scale_denom = scale_denom
        self._lib = _load()
        self._handle = self._lib.w2t_decoder_create(n_threads)

    def decode(self, jpegs: Sequence[bytes]) -> np.ndarray:
        n = len(jpegs)
        out = np.zeros((n, self.height, self.width, 3), np.uint8)
        if n == 0:
            return out
        if self._handle is None:
            raise RuntimeError("BatchJpegDecoder is closed")
        jpegs = [bytes(b) for b in jpegs]
        srcs = (ctypes.c_char_p * n)(*jpegs)
        lens = (ctypes.c_size_t * n)(*[len(b) for b in jpegs])
        self._lib.w2t_decode_batch_scaled(
            self._handle, n, ctypes.cast(srcs, ctypes.POINTER(ctypes.c_char_p)), lens,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.height * self.width * 3, self.height, self.width, 1, self.scale_denom,
        )
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.w2t_decoder_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
