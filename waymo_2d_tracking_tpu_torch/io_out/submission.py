"""Track records and their JSONL form (the part of ``io_out/submission.py``
on the port's paths; the Waymo protobuf writer is a later slice).

Record schema (2D camera tracking): context_name, timestamp_micros,
camera_name (enum int), object_id (str), type (1=vehicle, 2=pedestrian,
4=cyclist), box center_x/center_y/length/width (axis-aligned), score.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List, Sequence

import numpy as np

# Waymo label.proto Label.Type enum values
TYPE_VEHICLE = 1
TYPE_PEDESTRIAN = 2
TYPE_SIGN = 3
TYPE_CYCLIST = 4
# internal class ids (0, 1, 2) -> Waymo types
CLASS_TO_WAYMO_TYPE = (TYPE_VEHICLE, TYPE_PEDESTRIAN, TYPE_CYCLIST)


@dataclasses.dataclass
class TrackRecord:
    context_name: str
    timestamp_micros: int
    camera_name: int
    object_id: str
    object_type: int
    center_x: float
    center_y: float
    length: float     # box extent along x (image convention)
    width: float      # box extent along y
    score: float

    @classmethod
    def from_xyxy(cls, context_name, timestamp_micros, camera_name, object_id,
                  object_type, box_xyxy, score):
        x1, y1, x2, y2 = (float(v) for v in box_xyxy)
        return cls(
            context_name=context_name,
            timestamp_micros=int(timestamp_micros),
            camera_name=int(camera_name),
            object_id=str(object_id),
            object_type=int(object_type),
            center_x=(x1 + x2) / 2,
            center_y=(y1 + y2) / 2,
            length=x2 - x1,
            width=y2 - y1,
            score=float(score),
        )

    def to_xyxy(self):
        hx, hy = self.length / 2, self.width / 2
        return (self.center_x - hx, self.center_y - hy,
                self.center_x + hx, self.center_y + hy)


def write_jsonl(path: str, records: Iterable[TrackRecord]) -> int:
    n = 0
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(dataclasses.asdict(r), sort_keys=True) + "\n")
            n += 1
    return n


def read_jsonl(path: str) -> List[TrackRecord]:
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(TrackRecord(**json.loads(line)))
    return out


def _waymo_type(cls: int) -> int:
    """Internal class id -> Waymo type; raises on ids with no mapping."""
    if not 0 <= cls < len(CLASS_TO_WAYMO_TYPE):
        raise ValueError(
            f"class id {cls} has no Waymo type mapping (tracked classes are "
            f"0..{len(CLASS_TO_WAYMO_TYPE) - 1}: vehicle/pedestrian/cyclist)"
        )
    return CLASS_TO_WAYMO_TYPE[cls]


def records_from_detections(
    dets, context_name: str, timestamps: Sequence[int], camera_name: int,
    scale: float = 1.0,
) -> List[TrackRecord]:
    """Stacked numpy Detections (T, D, ...) -> flat records; object_id is the
    per-frame detection index (no identity across frames)."""
    valid = np.asarray(dets.valid)
    boxes = np.asarray(dets.boxes) / scale
    scores = np.asarray(dets.scores)
    classes = np.asarray(dets.classes)
    recs = []
    for t in range(valid.shape[0]):
        for i in np.flatnonzero(valid[t]):
            recs.append(TrackRecord.from_xyxy(
                context_name, timestamps[t], camera_name,
                object_id=f"det_{t}_{int(i)}",
                object_type=_waymo_type(int(classes[t, i])),
                box_xyxy=boxes[t, i], score=scores[t, i],
            ))
    return recs


def records_from_track_outputs(
    outputs, context_name: str, timestamps: Sequence[int], camera_name: int,
    scale: float = 1.0, interp_max_gap: int = 0,
) -> List[TrackRecord]:
    """Stacked numpy TrackOutputs (T, S) -> flat records (valid slots only).

    ``scale`` maps network boxes back to source pixels. ``interp_max_gap`` >
    0 fills per-track gaps of up to that many frames by linear interpolation
    on the exact ``timestamps`` grid (``io_out/postprocess.py``).
    """
    valid = np.asarray(outputs.valid)
    ids = np.asarray(outputs.track_id)
    boxes = np.asarray(outputs.boxes) / scale
    scores = np.asarray(outputs.scores)
    classes = np.asarray(outputs.classes)
    recs = []
    for t in range(valid.shape[0]):
        for s in np.flatnonzero(valid[t]):
            recs.append(TrackRecord.from_xyxy(
                context_name, timestamps[t], camera_name,
                object_id=f"{camera_name}_{int(ids[t, s])}",
                object_type=_waymo_type(int(classes[t, s])),
                box_xyxy=boxes[t, s], score=scores[t, s],
            ))
    if interp_max_gap > 0:
        from waymo_2d_tracking_tpu_torch.io_out.postprocess import interpolate_gaps

        recs = interpolate_gaps(recs, timestamps, interp_max_gap)
    return recs
