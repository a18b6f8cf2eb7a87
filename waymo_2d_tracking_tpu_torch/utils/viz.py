"""Per-frame track visualization (a copy of the JAX package's
``utils/viz.py``): track boxes with per-id stable colours and id / score
labels drawn onto the source frames, one JPEG per frame and optionally one
video. Host-side debugging tooling on OpenCV, imported when drawing; where
``cv2`` is absent that raises ``ImportError``.

CLI: ``draw --tracks tracks.jsonl --segments-dir DATA --out-dir viz/``
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from waymo_2d_tracking_tpu_torch.data.video import import_cv2


def id_color(object_id: str) -> Tuple[int, int, int]:
    """Stable, saturated BGR color from a track id (golden-ratio hue walk)."""
    h = (hash(object_id) % 360) / 360.0
    i = int(h * 6.0)
    f = h * 6.0 - i
    v, p, q, t = 255, 40, int(255 * (1 - 0.85 * f)), int(255 * (1 - 0.85 * (1 - f)))
    rgb = [
        (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)
    ][i % 6]
    return (rgb[2], rgb[1], rgb[0])  # BGR for cv2


def draw_frame(
    frame: np.ndarray,                   # (H, W, 3) uint8 RGB
    records: Iterable,                   # TrackRecords for this frame
    show_score: bool = True,
) -> np.ndarray:
    """Returns a BGR uint8 copy with boxes/labels drawn (cv2 convention)."""
    cv2 = import_cv2()

    img = np.ascontiguousarray(frame[:, :, ::-1])  # RGB -> BGR copy
    for r in records:
        x1, y1, x2, y2 = (int(round(v)) for v in r.to_xyxy())
        color = id_color(r.object_id)
        cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
        label = str(r.object_id)
        if show_score and r.score is not None:
            label += f" {r.score:.2f}"
        (tw, th), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv2.rectangle(img, (x1, max(y1 - th - 6, 0)), (x1 + tw + 4, y1), color, -1)
        cv2.putText(img, label, (x1 + 2, max(y1 - 4, th)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1, cv2.LINE_AA)
    return img


def render_segment(
    segment,                             # pipeline.run.SegmentFrames
    records: List,                       # TrackRecords (any order)
    out_dir: str,
    max_frames: Optional[int] = None,
    video_path: Optional[str] = None,
    fps: float = 10.0,
) -> int:
    """Draw every frame of one (segment, camera); returns frames written.

    video_path: additionally (or, with out_dir=None, instead) encode the
    annotated frames into one video file (container by extension; mp4
    default codec) at ``fps`` — the shareable demo artifact.
    """
    cv2 = import_cv2()

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    by_ts: Dict[int, List] = {}
    for r in records:
        if (r.context_name, r.camera_name) == (
            segment.context_name, segment.camera_name
        ):
            by_ts.setdefault(r.timestamp_micros, []).append(r)

    n = 0
    writer = None
    it = segment.chunk_iter(1)
    try:
        for t, ts in enumerate(segment.timestamps):
            if max_frames is not None and t >= max_frames:
                break
            frame = next(it)[0]
            img = draw_frame(frame, by_ts.get(ts, []))
            if out_dir:
                name = (f"{segment.context_name}_{segment.camera_name}"
                        f"_{t:05d}.jpg")
                cv2.imwrite(os.path.join(out_dir, name), img)
            if video_path:
                if writer is None:
                    fourcc = cv2.VideoWriter_fourcc(
                        *("mp4v" if video_path.endswith(".mp4") else "MJPG"))
                    writer = cv2.VideoWriter(
                        video_path, fourcc, fps,
                        (img.shape[1], img.shape[0]))
                    if not writer.isOpened():
                        raise RuntimeError(
                            f"cv2.VideoWriter could not open {video_path!r} "
                            "(codec unavailable?) — use a .avi extension "
                            "for the MJPG fallback")
                writer.write(img)
            n += 1
    finally:
        it.close()
        if writer is not None:
            writer.release()
    return n
