"""ctypes binding to the native TFRecord scanner (``native/tfrecord_reader.cpp``,
built by ``data/_native.py``; counterpart of ``data/tfrecord_native.py``):
the framing index, per-record metadata (timestamp and camera presence) and
one camera's image bytes from a record, without Python touching the record
bytes. The schema's field numbers come from ``data/waymo.py``.

There is no Python fallback here: a shim that cannot be built raises, and so
does a failed read.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np

from waymo_2d_tracking_tpu_torch.data import _native


def _configure(lib: ctypes.CDLL) -> None:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.w2t_tfr_index.restype = ctypes.c_longlong
    lib.w2t_tfr_index.argtypes = [ctypes.c_char_p, u64p, u64p, ctypes.c_longlong]
    lib.w2t_tfr_meta.restype = ctypes.c_longlong
    lib.w2t_tfr_meta.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
    ]
    lib.w2t_tfr_extract.restype = ctypes.c_longlong
    lib.w2t_tfr_extract.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
    ]


def _load() -> ctypes.CDLL:
    return _native.load("w2t_tfrecord", _configure)


def index(path: str, cap: int = 1 << 20) -> List[Tuple[int, int]]:
    """Framing-only (payload offset, length) per record."""
    offsets = np.zeros(cap, np.uint64)
    lengths = np.zeros(cap, np.uint64)
    n = _load().w2t_tfr_index(
        path.encode(),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        cap,
    )
    if n < 0:
        raise OSError(f"TFRecord scanner could not read {path}")
    n = min(int(n), cap)
    return [(int(offsets[i]), int(lengths[i])) for i in range(n)]


def meta(path: str, n_records: int, f_ts: int, f_images: int, f_cam: int, f_img: int,
         cam_ids: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """One pass: (timestamps (n,) int64, present (n, n_cams) bool)."""
    n_cams = len(cam_ids)
    cams = (ctypes.c_int * n_cams)(*cam_ids)
    ts = np.zeros(n_records, np.int64)
    present = np.zeros(n_records * max(n_cams, 1), np.uint8)
    n = _load().w2t_tfr_meta(
        path.encode(), f_ts, f_images, f_cam, f_img, cams, n_cams,
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        present.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_records,
    )
    if n != n_records:
        raise OSError(f"TFRecord scanner read {n} of {n_records} records of {path}")
    return ts, present.reshape(n_records, n_cams).astype(bool)


def extract(path: str, offset: int, length: int, f_images: int, f_cam: int, cam_id: int,
            f_img: int) -> bytes:
    """Camera ``cam_id``'s image bytes from the record at ``offset``; b"" when
    the record has no image for it. One call: the destination is sized at the
    record's length, which an embedded field cannot exceed."""
    buf = np.empty(int(length), np.uint8)
    got = _load().w2t_tfr_extract(
        path.encode(), offset, length, f_images, f_cam, cam_id, f_img,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), int(length),
    )
    if got == -1:
        return b""
    if got < 0:
        raise OSError(f"TFRecord scanner could not read the record at {offset} of {path}")
    return buf[: int(got)].tobytes()
