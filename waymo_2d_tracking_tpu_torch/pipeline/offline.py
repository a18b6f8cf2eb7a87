"""Tracker-only runs over precomputed detections (counterpart of
``pipeline/offline.py``, BASELINE config 1).

Detection records (``TrackRecord`` rows, e.g. a detector's JSONL) are grouped
per (context, camera), laid on each segment's frame grid and tracked; on the
card every association stage goes through the auction kernel. Detection
files carry no embeddings, so an appearance-using tracker config is refused.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from waymo_2d_tracking_tpu_torch import resolve_device
from waymo_2d_tracking_tpu_torch.io_out import submission as subm
from waymo_2d_tracking_tpu_torch.io_out.postprocess import infer_frame_grid
from waymo_2d_tracking_tpu_torch.tracker import Tracker
from waymo_2d_tracking_tpu_torch.types import Detections

# Waymo object type -> internal class id (vehicle, pedestrian, cyclist)
_TYPE_TO_CLASS = {1: 0, 2: 1, 4: 2}


def check_no_appearance(cfg) -> None:
    """Fail fast when a from-detections run would feed zero embeddings into
    an appearance-using tracker (its output silently collapses)."""
    uses_appearance = cfg.tracker.embed_dim > 0 and (
        cfg.tracker.appearance_weight > 0.0 or cfg.tracker.reid_recovery
    )
    if uses_appearance:
        raise ValueError(
            "track --from-detections: detection files have no embeddings, "
            "but the tracker config enables appearance association "
            f"(embed_dim={cfg.tracker.embed_dim}, appearance_weight="
            f"{cfg.tracker.appearance_weight}, reid_recovery="
            f"{cfg.tracker.reid_recovery}) over zero vectors. "
            "Add --set tracker.embed_dim=0 (IoU-only, config-1 semantics)."
        )


def group_rows_by_segment(rows) -> Dict[Tuple[str, int], list]:
    """Detection/track records -> {(context_name, camera_name): rows}."""
    by_seg: Dict[Tuple[str, int], list] = {}
    for r in rows:
        by_seg.setdefault((r.context_name, r.camera_name), []).append(r)
    return by_seg


def rows_to_detections(cfg, rows_for_segment, device="cuda") -> Tuple[List[int], Detections]:
    """One segment's detection rows -> (frame timestamps, padded Detections
    (T, D, ...) on ``device``).

    The frame grid is inferred from the timestamps (``infer_frame_grid``): a
    frame where the detector emitted nothing still steps the tracker and
    counts for ``interp_max_gap``. Rows past ``max_detections`` in a frame
    are dropped.
    """
    d = cfg.tracker.max_detections
    stamps = infer_frame_grid([r.timestamp_micros for r in rows_for_segment])
    t_idx = {ts: i for i, ts in enumerate(stamps)}
    t = len(stamps)
    boxes = np.zeros((t, d, 4), np.float32)
    scores = np.zeros((t, d), np.float32)
    classes = np.zeros((t, d), np.int32)
    valid = np.zeros((t, d), bool)
    counts = [0] * t
    for r in rows_for_segment:
        i = t_idx[r.timestamp_micros]
        j = counts[i]
        if j >= d:
            continue
        boxes[i, j] = r.to_xyxy()
        scores[i, j] = r.score
        classes[i, j] = _TYPE_TO_CLASS.get(r.object_type, 0)
        valid[i, j] = True
        counts[i] += 1
    dev = resolve_device(device)
    dets = Detections(
        boxes=torch.from_numpy(boxes), scores=torch.from_numpy(scores),
        classes=torch.from_numpy(classes),
        embeds=torch.zeros((t, d, max(cfg.tracker.embed_dim, 1)), dtype=torch.float32),
        valid=torch.from_numpy(valid),
    ).to(dev)
    return stamps, dets


def track_detection_rows(cfg, rows, device="cuda") -> list:
    """Run the tracker over detection records; returns TrackRecords.

    Groups rows by (context, camera), runs the tracker over each segment's
    frame grid and applies the configured gap interpolation
    (``pipeline.interp_max_gap``).
    """
    check_no_appearance(cfg)
    tracker = Tracker(cfg.tracker, device=device)
    all_records: list = []
    for (ctx, cam), rs in sorted(group_rows_by_segment(rows).items()):
        stamps, dets = rows_to_detections(cfg, rs, device=tracker.device)
        _, outputs = tracker.run(dets)
        all_records.extend(subm.records_from_track_outputs(
            outputs.to_numpy(), ctx, stamps, cam,
            interp_max_gap=cfg.pipeline.interp_max_gap,
        ))
    return all_records
