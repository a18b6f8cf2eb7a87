"""Track records, their JSONL form and the Waymo ``metrics.Objects``
protobuf (counterpart of ``io_out/submission.py``; the protobuf is
hand-encoded with ``utils/protolite.py`` from the field-number table ``_F``,
the JAX package's, so both packages write the same bytes).

Record schema (2D camera tracking): context_name, timestamp_micros,
camera_name (enum int), object_id (str), type (1=vehicle, 2=pedestrian,
4=cyclist), box center_x/center_y/length/width (axis-aligned), score.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List, Sequence

import numpy as np

from waymo_2d_tracking_tpu_torch.utils import protolite as pb

# Waymo label.proto Label.Type enum values
TYPE_VEHICLE = 1
TYPE_PEDESTRIAN = 2
TYPE_SIGN = 3
TYPE_CYCLIST = 4
# internal class ids (0, 1, 2) -> Waymo types
CLASS_TO_WAYMO_TYPE = (TYPE_VEHICLE, TYPE_PEDESTRIAN, TYPE_CYCLIST)
WAYMO_TYPE_NAMES = {
    TYPE_VEHICLE: "VEHICLE", TYPE_PEDESTRIAN: "PEDESTRIAN",
    TYPE_SIGN: "SIGN", TYPE_CYCLIST: "CYCLIST",
}

# protobuf field numbers (metrics.Objects / Object, label.proto Label / Box)
_F = {
    "objects.objects": 1,
    "object.label": 1,
    "object.score": 2,
    "object.overlap_nlz": 3,
    "object.context_name": 4,
    "object.timestamp": 5,
    "object.camera_name": 6,
    "label.box": 1,
    "label.metadata": 2,
    "label.type": 3,
    "label.id": 4,
    "box.center_x": 1,
    "box.center_y": 2,
    "box.center_z": 3,
    "box.length": 5,
    "box.width": 4,
    "box.height": 6,
    "box.heading": 7,
}


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


def _encode_object(r: TrackRecord) -> bytes:
    box = (
        pb.field_double(_F["box.center_x"], r.center_x)
        + pb.field_double(_F["box.center_y"], r.center_y)
        + pb.field_double(_F["box.length"], r.length)
        + pb.field_double(_F["box.width"], r.width)
    )
    label = (
        pb.field_message(_F["label.box"], box)
        + pb.field_varint(_F["label.type"], r.object_type)
        + pb.field_string(_F["label.id"], r.object_id)
    )
    return (
        pb.field_message(_F["object.label"], label)
        + pb.field_float(_F["object.score"], r.score)
        + pb.field_string(_F["object.context_name"], r.context_name)
        + pb.field_varint(_F["object.timestamp"], r.timestamp_micros)
        + pb.field_varint(_F["object.camera_name"], r.camera_name)
    )


def write_waymo_pb(path: str, records: Iterable[TrackRecord]) -> int:
    n = 0
    with open(path, "wb") as f:
        for r in records:
            f.write(pb.field_message(_F["objects.objects"], _encode_object(r)))
            n += 1
    return n


def read_waymo_pb(path: str) -> List[TrackRecord]:
    with open(path, "rb") as f:
        data = f.read()
    out = []
    for field, _w, raw in pb.iter_fields(data):
        if field != _F["objects.objects"]:
            continue
        obj = pb.parse_message(raw)
        label = pb.parse_message(obj[_F["object.label"]][0])
        box = pb.parse_message(label[_F["label.box"]][0])
        out.append(TrackRecord(
            context_name=obj[_F["object.context_name"]][0].decode(),
            timestamp_micros=pb.as_sint(obj[_F["object.timestamp"]][0]),
            camera_name=obj[_F["object.camera_name"]][0],
            object_id=label[_F["label.id"]][0].decode(),
            object_type=label[_F["label.type"]][0],
            center_x=pb.as_double(box[_F["box.center_x"]][0]),
            center_y=pb.as_double(box[_F["box.center_y"]][0]),
            length=pb.as_double(box[_F["box.length"]][0]),
            width=pb.as_double(box[_F["box.width"]][0]),
            score=pb.as_float(obj[_F["object.score"]][0]),
        ))
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
