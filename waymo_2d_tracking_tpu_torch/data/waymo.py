"""Waymo segment ingestion (counterpart of ``data/waymo.py``).

Two sources, each yielding one ``pipeline.run.SegmentFrames`` per (segment,
camera) whose ``jpeg_frames`` stream lazily, a chunk at a time:

1. Waymo Open Dataset ``.tfrecord`` segment files. The TFRecord framing
   (length, masked CRC32C, payload) is read without TensorFlow; the index,
   the per-record metadata and a camera's JPEG bytes come from the native
   scanner (``data/tfrecord_native.py``), and ``parse_frame`` walks a Frame
   proto with ``utils/protolite`` against the schema table below (the field
   numbers as the JAX package recalls them, in one place).
2. Directory segments: a directory with ``meta.json`` ({context_name,
   cameras: {name: camera_id}, timestamps}) and frames as
   ``frames/<t>_<cam>.jpg``. ``materialize_directory_segment`` writes one
   from uint8 frames, encoding the JPEGs with cv2, which it imports when
   called (the reading paths never need it).
"""
from __future__ import annotations

import json
import logging
import os
import struct
from typing import Dict, Iterator, List, Optional, Sequence


from waymo_2d_tracking_tpu_torch.data import tfrecord_native
from waymo_2d_tracking_tpu_torch.utils import protolite as pb

logger = logging.getLogger(__name__)

# Waymo camera name enum (CameraName.Name)
CAMERA_NAMES = {"FRONT": 1, "FRONT_LEFT": 2, "FRONT_RIGHT": 3,
                "SIDE_LEFT": 4, "SIDE_RIGHT": 5}

# [RECALLED] dataset.proto field numbers — single correction point.
_FRAME_SCHEMA = {
    "frame.context": 1,          # Context
    "frame.timestamp": 2,        # int64 micros
    "frame.images": 4,           # repeated CameraImage
    "frame.camera_labels": 8,    # repeated CameraLabels
    "context.name": 1,           # string
    "camera_image.name": 1,      # enum
    "camera_image.image": 2,     # bytes (JPEG)
    "camera_labels.name": 1,     # enum
    "camera_labels.labels": 2,   # repeated Label
    "label.box": 1,
    "label.type": 3,
    "label.id": 4,
    "box.center_x": 1,
    "box.center_y": 2,
    "box.length": 5,
    "box.width": 4,
}


# --------------------------------------------------------- TFRecord framing

def _masked_crc32c(data: bytes) -> int:
    """TFRecord masked CRC32c."""
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def read_tfrecord(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (crc,) = struct.unpack("<I", header[8:])
                if crc != _masked_crc32c(header[:8]):
                    raise ValueError("length CRC mismatch")
            data = f.read(length)
            f.read(4)  # data CRC
            yield data


def write_tfrecord(path: str, records: Sequence[bytes]) -> None:
    """Write a TFRecord file (for synthetic fixtures / tests)."""
    with open(path, "wb") as f:
        for rec in records:
            header = struct.pack("<Q", len(rec))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc32c(header)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc32c(rec)))


# --------------------------------------------------------- Frame proto walk

def parse_frame(data: bytes, want_labels: bool = True) -> Dict:
    """One Frame proto -> {context_name, timestamp, images: {cam: jpeg},
    labels: {cam: [ {id, type, box xyxy-able fields} ]}}."""
    s = _FRAME_SCHEMA
    frame = pb.parse_message(data)
    ctx_name = ""
    if s["frame.context"] in frame:
        ctx = pb.parse_message(frame[s["frame.context"]][0])
        if s["context.name"] in ctx:
            ctx_name = ctx[s["context.name"]][0].decode()
    ts = pb.as_sint(frame.get(s["frame.timestamp"], [0])[0])

    images = {}
    for raw in frame.get(s["frame.images"], []):
        ci = pb.parse_message(raw)
        cam = ci.get(s["camera_image.name"], [0])[0]
        images[cam] = ci.get(s["camera_image.image"], [b""])[0]

    labels: Dict[int, List[dict]] = {}
    if want_labels:
        for raw in frame.get(s["frame.camera_labels"], []):
            cl = pb.parse_message(raw)
            cam = cl.get(s["camera_labels.name"], [0])[0]
            out = []
            for lraw in cl.get(s["camera_labels.labels"], []):
                lab = pb.parse_message(lraw)
                box = pb.parse_message(lab[s["label.box"]][0])
                cx = pb.as_double(box[s["box.center_x"]][0])
                cy = pb.as_double(box[s["box.center_y"]][0])
                ln = pb.as_double(box[s["box.length"]][0])
                w = pb.as_double(box[s["box.width"]][0])
                out.append({
                    "id": lab.get(s["label.id"], [b""])[0].decode(),
                    "type": lab.get(s["label.type"], [0])[0],
                    "xyxy": (cx - ln / 2, cy - w / 2, cx + ln / 2, cy + w / 2),
                })
            labels[cam] = out
    return {"context_name": ctx_name, "timestamp": ts,
            "images": images, "labels": labels}


def encode_frame(context_name: str, timestamp: int,
                 images: Dict[int, bytes], labels: Optional[Dict] = None) -> bytes:
    """Inverse of parse_frame (synthetic fixtures / round-trip tests)."""
    s = _FRAME_SCHEMA
    out = pb.field_message(
        s["frame.context"], pb.field_string(s["context.name"], context_name)
    )
    out += pb.field_varint(s["frame.timestamp"], timestamp)
    for cam, jpeg in images.items():
        ci = pb.field_varint(s["camera_image.name"], cam) + pb.field_bytes(
            s["camera_image.image"], jpeg
        )
        out += pb.field_message(s["frame.images"], ci)
    for cam, labs in (labels or {}).items():
        enc = pb.field_varint(s["camera_labels.name"], cam)
        for lab in labs:
            x1, y1, x2, y2 = lab["xyxy"]
            box = (
                pb.field_double(s["box.center_x"], (x1 + x2) / 2)
                + pb.field_double(s["box.center_y"], (y1 + y2) / 2)
                + pb.field_double(s["box.length"], x2 - x1)
                + pb.field_double(s["box.width"], y2 - y1)
            )
            enc += pb.field_message(
                s["camera_labels.labels"],
                pb.field_message(s["label.box"], box)
                + pb.field_varint(s["label.type"], lab["type"])
                + pb.field_string(s["label.id"], lab["id"]),
            )
        out += pb.field_message(s["frame.camera_labels"], enc)
    return out


def index_tfrecord(path: str) -> List[tuple]:
    """One pass over the TFRecord framing only: (payload offset, length) per
    record, through the native scanner; no record bytes are read or kept."""
    return tfrecord_native.index(path)


def read_record_at(path: str, offset: int, length: int) -> bytes:
    with open(path, "rb") as f:
        f.seek(offset)
        return f.read(length)


class TfrecordCameraJpegs:
    """Lazy list of ONE camera's JPEG bytes inside a TFRecord segment. Holds
    only (offset, length) record positions; ``[i]`` / ``[a:b]`` re-read just
    those records (the native scanner copies out this camera's bytes), so the
    bytes held at once are bounded by the consumer's chunk."""

    def __init__(self, path: str, camera_id: int, positions: List[tuple]):
        self.path = path
        self.camera_id = camera_id
        self.positions = positions
        self.records_read = 0   # observability + bounded-buffering tests

    def __len__(self):
        return len(self.positions)

    def _fetch(self, pos) -> bytes:
        offset, length = pos
        self.records_read += 1
        s = _FRAME_SCHEMA
        return tfrecord_native.extract(
            self.path, offset, length, s["frame.images"],
            s["camera_image.name"], self.camera_id, s["camera_image.image"],
        )

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self._fetch(p) for p in self.positions[idx]]
        return self._fetch(self.positions[idx])


class DirectoryCameraJpegs:
    """Lazy list of one camera's JPEG bytes in a directory segment: holds only
    file paths; ``[i]`` / ``[a:b]`` read just those files."""

    def __init__(self, paths: List[str]):
        self.paths = paths
        self.files_read = 0   # observability + bounded-buffering tests

    def __len__(self):
        return len(self.paths)

    def _fetch(self, path: str) -> bytes:
        self.files_read += 1
        with open(path, "rb") as f:
            return f.read()

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self._fetch(p) for p in self.paths[idx]]
        return self._fetch(self.paths[idx])


# --------------------------------------------------------- segment sources

def iter_segments(path: str, cameras: Sequence[str] = ("FRONT",)):
    """Yield pipeline.run.SegmentFrames from a data directory.

    Supports: *.tfrecord files (Waymo format) and directory segments.
    One SegmentFrames per (segment, camera).
    """
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames

    cam_ids = [CAMERA_NAMES[c] for c in cameras]
    entries = sorted(os.listdir(path))
    for entry in entries:
        full = os.path.join(path, entry)
        if entry.endswith(".tfrecord"):
            # memory-lean ingestion: ONE metadata pass records timestamps +
            # per-camera presence (+ record offsets) but retains NO image
            # bytes; each camera then streams its JPEGs lazily per chunk
            positions = index_tfrecord(full)
            if not positions:
                continue
            s = _FRAME_SCHEMA
            ts_arr, present_mat = tfrecord_native.meta(
                full, len(positions), s["frame.timestamp"], s["frame.images"],
                s["camera_image.name"], s["camera_image.image"], cam_ids,
            )
            stamps = [int(t) for t in ts_arr]
            present = {c: [bool(v) for v in present_mat[:, k]] for k, c in enumerate(cam_ids)}
            # the context name from record 0 (constant across a segment)
            fr0 = parse_frame(read_record_at(full, *positions[0]), want_labels=False)
            ctx = fr0["context_name"] or entry
            for c in cam_ids:
                # a record may carry only a subset of cameras; empty JPEG
                # bytes would crash the decoder downstream — keep only the
                # frames (and their timestamps) this camera actually has
                keep = [i for i, p in enumerate(present[c]) if p]
                if len(keep) < len(stamps):
                    logger.warning(
                        "%s camera %d: %d/%d frames missing image data",
                        entry, c, len(stamps) - len(keep), len(stamps),
                    )
                if not keep:
                    continue
                yield SegmentFrames(
                    context_name=ctx, camera_name=c,
                    timestamps=[stamps[i] for i in keep],
                    jpeg_frames=TfrecordCameraJpegs(
                        full, c, [positions[i] for i in keep]
                    ),
                )
        elif os.path.isdir(full) and os.path.exists(os.path.join(full, "meta.json")):
            meta = json.load(open(os.path.join(full, "meta.json")))
            for cam_name, cam_id in meta["cameras"].items():
                if cam_id not in cam_ids:
                    continue
                paths = [
                    os.path.join(full, "frames", f"{t}_{cam_id}.jpg")
                    for t in range(len(meta["timestamps"]))
                ]
                yield SegmentFrames(
                    context_name=meta["context_name"], camera_name=cam_id,
                    timestamps=meta["timestamps"],
                    jpeg_frames=DirectoryCameraJpegs(paths),
                )


def materialize_directory_segment(
    out_dir: str, context_name: str, frames, timestamps: Sequence[int],
    camera_id: int = 1, labels=None, jpeg_quality: int = 90,
) -> str:
    """Write a directory segment from (T, H, W, 3) uint8 RGB frames; one call
    per camera builds a multi-camera context (``meta.json`` is merged, and
    every camera of a context must carry the same timestamps). ``labels``
    (track records) go to ``labels.jsonl``. Returns the segment directory."""
    from waymo_2d_tracking_tpu_torch.data.video import import_cv2

    cv2 = import_cv2()
    seg_dir = os.path.join(out_dir, context_name)
    os.makedirs(os.path.join(seg_dir, "frames"), exist_ok=True)
    for t in range(frames.shape[0]):
        cv2.imwrite(
            os.path.join(seg_dir, "frames", f"{t}_{camera_id}.jpg"),
            frames[t][:, :, ::-1],
            [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality],
        )
    meta_path = os.path.join(seg_dir, "meta.json")
    cam_name = {v: k for k, v in CAMERA_NAMES.items()}.get(camera_id, f"CAM_{camera_id}")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if meta["timestamps"] != list(map(int, timestamps)):
            # the JAX package's assertion, kept under python -O
            raise AssertionError("all cameras of a context must share timestamps")
        meta["cameras"][cam_name] = camera_id
    else:
        meta = {
            "context_name": context_name,
            "cameras": {cam_name: camera_id},
            "timestamps": list(map(int, timestamps)),
        }
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    if labels is not None:
        from waymo_2d_tracking_tpu_torch.io_out import submission

        submission.write_jsonl(os.path.join(seg_dir, "labels.jsonl"), labels)
    return seg_dir
