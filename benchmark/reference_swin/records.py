"""Track records from tracker outputs: one row per emitted slot and frame,
the box mapped back to source pixels, as the Waymo 2D tracking submission
holds them."""
from __future__ import annotations

import numpy as np

WAYMO_TYPE = (1, 2, 4)   # vehicle, pedestrian, cyclist


def rows(outputs: dict, context: str, timestamps, camera: int, scale: float):
    """outputs: numpy (T, S) fields -> [(context, timestamp, camera, object_id,
    type, center_x, center_y, length, width, score)]."""
    valid = np.asarray(outputs["valid"])
    ids = np.asarray(outputs["track_id"])
    boxes = np.asarray(outputs["boxes"]) / scale
    scores, classes = np.asarray(outputs["scores"]), np.asarray(outputs["classes"])
    out = []
    for t in range(valid.shape[0]):
        for s in np.flatnonzero(valid[t]):
            x1, y1, x2, y2 = (float(v) for v in boxes[t, s])
            out.append((context, int(timestamps[t]), int(camera), f"{camera}_{int(ids[t, s])}",
                        WAYMO_TYPE[int(classes[t, s])], (x1 + x2) / 2, (y1 + y2) / 2,
                        x2 - x1, y2 - y1, float(scores[t, s])))
    return out
