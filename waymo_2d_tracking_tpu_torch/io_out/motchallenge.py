"""MOTChallenge-format interop, a copy of the JAX package's
``io_out/motchallenge.py`` (host-only; the port keeps its own).

Bridges ``TrackRecord`` JSONL and the MOT16/17/20 text format, one CSV line
per box: ``frame, id, bb_left, bb_top, bb_width, bb_height, conf, X, Y, Z``;
for ground truth the trailing fields are ``(class_id, visibility)`` and
``conf`` is the "consider" flag (0 = ignore region); detection files carry
``id = -1``. Frames are 1-based, one file per camera sequence.

Mapping:
- frame N  <->  ``timestamp_micros = N * 100_000`` (the 10 Hz camera
  period);
- sequence name <-> ``context_name``; ``camera_name`` is fixed (FRONT=1);
- MOT gt classes 1 -> PEDESTRIAN, 3 -> VEHICLE, 4/5 -> CYCLIST;
- distractor classes (2, 7, 8, 12) and conf == 0 rows become ignore
  regions, returned in ``MotImportStats.ignore`` (``eval/mot.py
  suppress_ignored`` removes predictions on them from the FP penalty set);
- occluder classes (9, 10, 11) and other unmapped ids are dropped
  (``skipped_class``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence, Tuple

from waymo_2d_tracking_tpu_torch.io_out.postprocess import infer_frame_grid
from waymo_2d_tracking_tpu_torch.io_out.submission import (
    TYPE_CYCLIST,
    TYPE_PEDESTRIAN,
    TYPE_VEHICLE,
    TrackRecord,
)

# 10 Hz camera period in microseconds; MOT frame numbers are 1-based
FRAME_PERIOD_US = 100_000

# MOTChallenge gt class id -> Waymo label type (scored GT)
MOT_CLASS_TO_TYPE = {
    1: TYPE_PEDESTRIAN,   # pedestrian
    3: TYPE_VEHICLE,      # car
    4: TYPE_CYCLIST,      # bicycle
    5: TYPE_CYCLIST,      # motorbike
}
# "don't care" targets (TrackEval MOT17 distractor set): predictions on
# these must not count as FPs — imported as ignore regions, NOT as GT
MOT_DISTRACTOR_CLASSES = frozenset({2, 7, 8, 12})
_TYPE_TO_MOT_CLASS = {
    TYPE_PEDESTRIAN: 1,
    TYPE_VEHICLE: 3,
    TYPE_CYCLIST: 4,
}


@dataclasses.dataclass
class MotImportStats:
    kept: int = 0
    skipped_ignore: int = 0    # rows imported as ignore regions instead
    skipped_class: int = 0     # occluder / unmapped class id (dropped)
    # conf==0 and distractor-class GT rows as records (boxes are what
    # matters; object_type/score carry debug value only) — feed their
    # boxes to eval/mot.suppress_ignored
    ignore: List[TrackRecord] = dataclasses.field(default_factory=list)


def frame_to_timestamp(frame: int) -> int:
    return int(frame) * FRAME_PERIOD_US


def read_mot(
    path: str,
    context_name: str | None = None,
    camera_name: int = 1,
    gt: bool = False,
    default_type: int = TYPE_PEDESTRIAN,
) -> Tuple[List[TrackRecord], MotImportStats]:
    """Parse one MOT sequence file into TrackRecords.

    ``gt=True`` applies ground-truth semantics: column 7 is the consider
    flag (0 -> skip), column 8 the class id (mapped or skipped). Otherwise
    column 7 is the detection/track confidence and class is
    ``default_type``. ``id == -1`` rows (detection files) get unique
    synthetic ids ``det_<n>`` so downstream code never aliases them.
    """
    if context_name is None:
        context_name = os.path.splitext(os.path.basename(path))[0]
    records: List[TrackRecord] = []
    stats = MotImportStats()
    det_n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(" ", ",").split(",")
            parts = [p for p in parts if p != ""]
            try:
                frame, tid = int(float(parts[0])), int(float(parts[1]))
                left, top, w, h = (float(v) for v in parts[2:6])
            except (ValueError, IndexError) as e:
                raise ValueError(
                    f"{path}:{lineno}: not a MOT line (need "
                    f"frame,id,left,top,w,h[,conf,...]): {line!r}") from e
            conf = float(parts[6]) if len(parts) > 6 else 1.0
            if gt:
                cls = int(float(parts[7])) if len(parts) > 7 else 1
                if conf == 0 or cls in MOT_DISTRACTOR_CLASSES:
                    # "do not consider": an ignore region, not scored GT —
                    # and not silently dropped either (predictions on it
                    # must be removable from the FP penalty set)
                    stats.skipped_ignore += 1
                    stats.ignore.append(TrackRecord.from_xyxy(
                        context_name=context_name,
                        timestamp_micros=frame_to_timestamp(frame),
                        camera_name=camera_name,
                        object_id=f"ignore_{tid}",
                        object_type=MOT_CLASS_TO_TYPE.get(cls, default_type),
                        box_xyxy=(left, top, left + w, top + h),
                        score=0.0,
                    ))
                    continue
                otype = MOT_CLASS_TO_TYPE.get(cls)
                if otype is None:
                    stats.skipped_class += 1
                    continue
                score = 1.0
            else:
                # result/det files: honor the class column ONLY for our
                # own export signature (exactly 9 fields ending in -1,
                # what write_mot emits) so the round trip preserves
                # types. Third-party det/result files carry world X/Y/Z
                # in columns 8-10 (MOT15 det, 3D results) — a 10-field
                # row is never class-bearing, integral-looking or not.
                cls = -1
                if (len(parts) == 9 and float(parts[8]) == -1.0):
                    raw = float(parts[7])
                    if raw == int(raw):
                        cls = int(raw)
                otype = MOT_CLASS_TO_TYPE.get(cls, default_type)
                score = conf
            if tid < 0:
                object_id = f"det_{det_n}"
                det_n += 1
            else:
                object_id = str(tid)
            records.append(TrackRecord.from_xyxy(
                context_name=context_name,
                timestamp_micros=frame_to_timestamp(frame),
                camera_name=camera_name,
                object_id=object_id,
                object_type=otype,
                box_xyxy=(left, top, left + w, top + h),
                score=score,
            ))
            stats.kept += 1
    return records, stats


def read_mot_tree(
    path: str, gt: bool = False, camera_name: int = 1
) -> Tuple[List[TrackRecord], MotImportStats]:
    """Read a single .txt file, or a directory of per-sequence files.

    Directory layouts accepted: ``dir/<seq>.txt`` (results layout) and
    ``dir/<seq>/gt/gt.txt`` / ``dir/<seq>/det/det.txt`` (the official
    train-split layout); sequence name becomes ``context_name``.
    """
    if os.path.isfile(path):
        return read_mot(path, gt=gt, camera_name=camera_name)
    records: List[TrackRecord] = []
    stats = MotImportStats()
    found = False
    for name in sorted(os.listdir(path)):
        sub = os.path.join(path, name)
        if os.path.isfile(sub) and name.endswith(".txt"):
            srcs = [(sub, os.path.splitext(name)[0])]
        elif os.path.isdir(sub):
            inner = os.path.join(sub, "gt", "gt.txt") if gt else \
                os.path.join(sub, "det", "det.txt")
            srcs = [(inner, name)] if os.path.isfile(inner) else []
        else:
            srcs = []
        for src, seq in srcs:
            found = True
            recs, st = read_mot(src, context_name=seq, gt=gt,
                                camera_name=camera_name)
            records.extend(recs)
            stats.kept += st.kept
            stats.skipped_ignore += st.skipped_ignore
            stats.skipped_class += st.skipped_class
            stats.ignore.extend(st.ignore)
    if not found:
        raise FileNotFoundError(
            f"no MOT .txt files under {path!r} (expected <seq>.txt or "
            f"<seq>/{'gt/gt' if gt else 'det/det'}.txt)")
    return records, stats


def write_mot(
    records: Sequence[TrackRecord], out_dir: str
) -> Dict[str, int]:
    """Write TrackRecords as MOT result files, one per (context, camera).

    File name: ``<context>.txt`` when the context appears with a single
    camera (the MOT norm), else ``<context>_cam<k>.txt``. Returns
    {filename: line count}. Track ids are re-issued as dense positive
    integers per sequence (MOT requires ints; ours are strings). Frame
    numbers are positions on the sequence's INFERRED frame grid
    (postprocess.infer_frame_grid, 1-based): order-preserving and
    collision-free for any timestamp convention (frame indices, 10 Hz
    ticks, epoch micros with jitter), and a frame where no track emitted
    output keeps its slot — so numbers may skip (e.g. 1,2,4).
    """
    by_key: Dict[Tuple[str, int], List[TrackRecord]] = {}
    for r in records:
        by_key.setdefault((r.context_name, r.camera_name), []).append(r)
    cams_per_ctx: Dict[str, set] = {}
    for ctx, cam in by_key:
        cams_per_ctx.setdefault(ctx, set()).add(cam)
    os.makedirs(out_dir, exist_ok=True)
    written: Dict[str, int] = {}
    for (ctx, cam), rows in sorted(by_key.items()):
        name = f"{ctx}.txt" if len(cams_per_ctx[ctx]) == 1 \
            else f"{ctx}_cam{cam}.txt"
        ids: Dict[str, int] = {}
        rows.sort(key=lambda r: (r.timestamp_micros, r.object_id))
        # full inferred grid, not just observed timestamps: a frame where
        # no track emitted output must still occupy its frame number, or
        # every box after the gap lands one GT frame early in external
        # scorers (infer_frame_grid synthesizes the holes from the
        # smallest observed period)
        grid = infer_frame_grid([r.timestamp_micros for r in rows])
        frame_of = {ts: i + 1 for i, ts in enumerate(grid)}
        with open(os.path.join(out_dir, name), "w") as f:
            for r in rows:
                x1, y1, x2, y2 = r.to_xyxy()
                tid = ids.setdefault(r.object_id, len(ids) + 1)
                f.write(
                    f"{frame_of[r.timestamp_micros]},{tid},"
                    f"{x1:.2f},{y1:.2f},{x2 - x1:.2f},{y2 - y1:.2f},"
                    f"{r.score:.4f},{_TYPE_TO_MOT_CLASS.get(r.object_type, -1)},-1\n"
                )
        written[name] = len(rows)
    return written
