"""Offline track postprocessing: linear gap interpolation (counterpart of
``io_out/postprocess.py``, a host-only copy).

Fills short per-track gaps (frames where a live track coasted on its Kalman
prediction without a matched detection, so it emitted nothing) by linear
interpolation between the surrounding matched boxes, the standard MOT
postprocess (ByteTrack's ``linear_interpolation``). It runs on the host over
finished ``TrackRecord`` lists, so it composes with every driver. Gaps
longer than ``max_gap`` frames are left alone: they are usually real
occlusions or re-ID recoveries.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from waymo_2d_tracking_tpu_torch.io_out.submission import TrackRecord

_LERP_FIELDS = ("center_x", "center_y", "length", "width", "score")


def interpolate_gaps(
    records: Sequence[TrackRecord],
    timestamps: Sequence[int],
    max_gap: int = 0,
) -> List[TrackRecord]:
    """Fill per-track gaps of 1..max_gap frames on a known frame grid.

    records: one segment's records (single context+camera — callers pass
      the per-segment list they just built). Records whose timestamps are
      not on the grid are passed through untouched.
    timestamps: the segment's full ordered frame timestamps (the grid).
    max_gap: largest run of missing frames to fill; 0 disables (identity).

    Returns the input records plus interpolated ones, sorted by
    (timestamp, object_id) for determinism. Interpolated records lerp
    box center/extent and score between the bracketing real records.
    """
    if max_gap <= 0 or not records:
        return list(records)
    ts_index: Dict[int, int] = {int(t): i for i, t in enumerate(timestamps)}

    by_track: Dict[Tuple, List[TrackRecord]] = defaultdict(list)
    for r in records:
        by_track[(r.context_name, r.camera_name, r.object_id)].append(r)

    out = list(records)
    for track in by_track.values():
        on_grid = [r for r in track if r.timestamp_micros in ts_index]
        on_grid.sort(key=lambda r: ts_index[r.timestamp_micros])
        for prev, nxt in zip(on_grid, on_grid[1:]):
            i0 = ts_index[prev.timestamp_micros]
            i1 = ts_index[nxt.timestamp_micros]
            if not 1 < i1 - i0 <= max_gap + 1:
                continue
            for i in range(i0 + 1, i1):
                w = (i - i0) / (i1 - i0)
                fields = {
                    f: (1 - w) * getattr(prev, f) + w * getattr(nxt, f)
                    for f in _LERP_FIELDS
                }
                out.append(dataclasses.replace(
                    prev,
                    timestamp_micros=int(timestamps[i]),
                    **fields,
                ))
    out.sort(key=lambda r: (r.timestamp_micros, r.object_id))
    return out


def infer_frame_grid(timestamps: Sequence[int]) -> List[int]:
    """Reconstruct a full frame grid from observed timestamps.

    Frame period = smallest positive diff of the sorted unique timestamps
    (capture jitter is microseconds against a ~100 ms frame period, so the
    smallest observed diff IS one period; a median over few diffs can land
    on a 2-period hole). A diff of ~k periods means k-1 frames with no
    observation, for which evenly spaced timestamps are synthesized.
    Observed timestamps keep their exact values. Exact whenever at least
    one observation exists per frame, the overwhelmingly common case.
    """
    ts = np.unique(np.asarray(list(timestamps), dtype=np.int64))
    if len(ts) < 2:
        return [int(t) for t in ts]
    diffs = np.diff(ts)  # strictly positive: ts is unique and sorted
    period = float(diffs.min())
    grid: List[int] = [int(ts[0])]
    for prev, cur, d in zip(ts, ts[1:], diffs):
        k = max(int(round(d / period)), 1)
        for j in range(1, k):
            grid.append(int(round(prev + d * j / k)))
        grid.append(int(cur))
    return grid


def interpolate_gaps_offline(
    records: Sequence[TrackRecord],
    max_gap: int = 0,
) -> List[TrackRecord]:
    """Grid-inferring variant for record files (``w2t interp``).

    Groups records by (context, camera) and reconstructs each group's frame
    grid from the timestamps present in the file: frame period = smallest
    positive diff of the sorted unique timestamps; a diff of ~k periods
    means k-1 frames where NO track was output, and synthesized timestamps
    are inserted for them. Rank-based (robust to the microsecond jitter of
    real capture timestamps — no exact-arithmetic grid needed); exact when
    at least one track is visible per frame, the overwhelmingly common
    case.
    """
    if max_gap <= 0 or not records:
        return list(records)
    groups: Dict[Tuple, List[TrackRecord]] = defaultdict(list)
    for r in records:
        groups[(r.context_name, r.camera_name)].append(r)
    out: List[TrackRecord] = []
    for group in groups.values():
        grid = infer_frame_grid([r.timestamp_micros for r in group])
        if len(grid) < 2:
            out.extend(group)
            continue
        out.extend(interpolate_gaps(group, grid, max_gap))
    out.sort(key=lambda r: (r.context_name, r.camera_name,
                            r.timestamp_micros, r.object_id))
    return out
