"""Video-file frame source for the streaming tracker (a copy of the JAX
package's ``data/video.py``).

``track --online --video clip.mp4`` streams a local video through the online
serving path one frame at a time. Decoding needs OpenCV, imported when a
video is opened; where ``cv2`` is absent that raises ``ImportError``.
"""
from __future__ import annotations

import importlib
import os
from typing import Iterator, Tuple

import numpy as np


def import_cv2():
    """OpenCV, imported on demand; raises ``ImportError`` naming what needs it."""
    try:
        return importlib.import_module("cv2")
    except ImportError as e:
        raise ImportError(
            "OpenCV (cv2) is not installed: reading or writing video files "
            "(`track --video`, `draw`) needs it; the tracking paths do not"
        ) from e


def iter_video_frames(path: str, stride: int = 1) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (timestamp_micros, RGB uint8 frame) from a video file.

    Timestamps are synthesized from the container FPS (frame_index / fps),
    what the tracker's constant-velocity model expects of a constant-rate
    source. stride > 1 subsamples (every stride-th frame).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    cv2 = import_cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"cv2 cannot open video: {path}")
    fps = cap.get(cv2.CAP_PROP_FPS)
    if not fps or fps <= 0:
        fps = 30.0
    try:
        idx = 0
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            if idx % stride == 0:
                yield int(idx * 1e6 / fps), bgr[:, :, ::-1].copy()
            idx += 1
    finally:
        cap.release()
