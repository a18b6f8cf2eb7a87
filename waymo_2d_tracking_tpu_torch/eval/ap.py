"""COCO-style detection average precision (counterpart of ``eval/ap.py``;
host-side numpy, copied).

Per class and IoU threshold, detections are sorted by score and greedily
matched to the best still-unmatched GT with IoU >= thr; AP is the 101-point
interpolated area under the precision-recall curve; mAP averages over IoU
0.50:0.95:0.05, with the COCO size strata (APs / APm / APl). No crowd or
max-detection handling: the Waymo 2D labels have neither.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(G,4) x (D,4) xyxy -> (G,D) IoU (the helper of eval/mot.py)."""
    from waymo_2d_tracking_tpu_torch.eval.mot import _frame_iou

    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    return _frame_iou(np.asarray(a, float), np.asarray(b, float))


def _ap_101(recall: np.ndarray, precision: np.ndarray) -> float:
    """COCO 101-point interpolated AP."""
    # precision envelope (monotone non-increasing from the right)
    prec = np.concatenate([[0.0], precision, [0.0]])
    rec = np.concatenate([[0.0], recall, [1.0]])
    for i in range(len(prec) - 2, -1, -1):
        prec[i] = max(prec[i], prec[i + 1])
    points = np.linspace(0.0, 1.0, 101)
    idx = np.searchsorted(rec, points, side="left")
    return float(np.mean(prec[np.minimum(idx, len(prec) - 1)]))


def average_precision(
    preds: Mapping[object, Tuple[np.ndarray, np.ndarray]],
    gts: Mapping[object, np.ndarray],
    iou_thr: float,
    gt_ignore: Mapping[object, np.ndarray] | None = None,
    det_ignore: Mapping[object, np.ndarray] | None = None,
    iou_cache: Mapping[object, np.ndarray] | None = None,
) -> float:
    """AP for ONE class at one IoU threshold.

    iou_cache: image_key -> (G, D) IoU matrix, shared across the 40
    (threshold x stratum) calls evaluate_detections makes per class (IoUs
    depend on neither).

    preds: image_key -> (boxes (D,4) xyxy, scores (D,)).
    gts:   image_key -> boxes (G,4) xyxy.
    gt_ignore: image_key -> bool (G,) — COCO "ignored" GT (e.g. outside a
      size range): they don't count toward recall, and a detection whose
      best feasible match is an ignored GT is dropped (neither TP nor FP).
    det_ignore: image_key -> bool (D,) — detections dropped when they end up
      UNMATCHED (pycocotools dtIg-by-area: a spurious detection whose own
      size is outside the evaluated range must not count as a false
      positive for that range).
    """
    num_gt = sum(
        int((~gt_ignore[img]).sum()) if gt_ignore is not None else len(g)
        for img, g in gts.items()
    )
    rows: List[Tuple[float, object, int]] = []  # (score, img, det_idx)
    for img, (boxes, scores) in preds.items():
        for d in range(len(boxes)):
            rows.append((float(scores[d]), img, d))
    if num_gt == 0:
        return float("nan")
    if not rows:
        return 0.0
    rows.sort(key=lambda r: -r[0])

    matched: Dict[object, np.ndarray] = {
        img: np.zeros(len(g), bool) for img, g in gts.items()
    }
    tp = np.zeros(len(rows))
    fp = np.zeros(len(rows))
    for i, (_score, img, d) in enumerate(rows):
        d_ign = bool(det_ignore[img][d]) if det_ignore is not None else False
        gt_boxes = gts.get(img, np.zeros((0, 4)))
        if len(gt_boxes) == 0:
            fp[i] = 0 if d_ign else 1
            continue
        if iou_cache is not None:
            ious = iou_cache[img][:, d]
        else:
            ious = _iou_matrix(gt_boxes, preds[img][0][d][None])[:, 0]
        avail = np.where(matched[img], -1.0, ious)  # COCO: best UNMATCHED gt
        ign = (gt_ignore[img] if gt_ignore is not None
               else np.zeros(len(gt_boxes), bool))
        # prefer a counted (non-ignored) match; fall back to ignored
        counted = np.where(ign, -1.0, avail)
        g = int(np.argmax(counted))
        if counted[g] >= iou_thr:
            matched[img][g] = True
            tp[i] = 1
            continue
        g_ign = int(np.argmax(np.where(ign, avail, -1.0)))
        if ign.any() and np.where(ign, avail, -1.0)[g_ign] >= iou_thr:
            matched[img][g_ign] = True   # consumed, but neither TP nor FP
            continue
        if not d_ign:
            fp[i] = 1
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / num_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    return _ap_101(recall, precision)


def evaluate_detections(
    pred_frames: Sequence[Tuple[object, np.ndarray, np.ndarray, np.ndarray]],
    gt_frames: Sequence[Tuple[object, np.ndarray, np.ndarray]],
    num_classes: int = 3,
    iou_thrs: Sequence[float] = tuple(np.arange(0.5, 0.96, 0.05)),
) -> Dict[str, float]:
    """COCO-style summary over a detection set.

    pred_frames: (image_key, boxes (D,4), scores (D,), classes (D,)).
    gt_frames:   (image_key, boxes (G,4), classes (G,)).
    Returns {"mAP", "AP50", "AP75", "AP_class<k>"...} (NaN-classes — no GT —
    are excluded from means, per COCO).
    """
    # COCO size strata (areas in source pixels): AP over [.5:.95] with GT
    # outside the range ignored, matched-to-ignored detections dropped
    area_ranges = {
        "s": (0.0, 32.0 ** 2),
        "m": (32.0 ** 2, 96.0 ** 2),
        "l": (96.0 ** 2, float("inf")),
    }
    per_thr_cls = np.full((len(iou_thrs), num_classes), np.nan)
    per_size = {k: np.full((len(iou_thrs), num_classes), np.nan)
                for k in area_ranges}
    for cls in range(num_classes):
        preds = {}
        for key, boxes, scores, classes in pred_frames:
            m = np.asarray(classes) == cls
            preds[key] = (np.asarray(boxes)[m], np.asarray(scores)[m])
        gts = {}
        for key, boxes, classes in gt_frames:
            m = np.asarray(classes) == cls
            gts[key] = np.asarray(boxes)[m]
        def _areas(boxes):
            return ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
                    if len(boxes) else np.zeros(0))

        gt_areas = {key: _areas(b) for key, b in gts.items()}
        det_areas = {key: _areas(b) for key, (b, _s) in preds.items()}
        # one (G, D) IoU matrix per image, shared by all 40 AP calls below
        iou_cache = {
            key: _iou_matrix(gts.get(key, np.zeros((0, 4))), b)
            for key, (b, _s) in preds.items()
        }
        # per-stratum ignore masks depend only on the stratum — built once,
        # shared across the IoU-threshold loop
        strata = {
            name: (
                {k: ~((a >= lo) & (a < hi)) for k, a in gt_areas.items()},
                {k: ~((a >= lo) & (a < hi)) for k, a in det_areas.items()},
            )
            for name, (lo, hi) in area_ranges.items()
        }
        for t, thr in enumerate(iou_thrs):
            per_thr_cls[t, cls] = average_precision(
                preds, gts, float(thr), iou_cache=iou_cache)
            for name, (g_ign, d_ign) in strata.items():
                per_size[name][t, cls] = average_precision(
                    preds, gts, float(thr), gt_ignore=g_ign,
                    det_ignore=d_ign, iou_cache=iou_cache,
                )

    out: Dict[str, float] = {}
    valid = ~np.isnan(per_thr_cls)
    out["mAP"] = float(np.mean(per_thr_cls[valid])) if valid.any() else 0.0
    for name in area_ranges:
        v = ~np.isnan(per_size[name])
        if v.any():
            out[f"AP{name}"] = float(np.mean(per_size[name][v]))
    for label, thr in (("AP50", 0.5), ("AP75", 0.75)):
        # only report the key when the threshold is actually evaluated
        diffs = np.abs(np.asarray(iou_thrs, float) - thr)
        t = int(np.argmin(diffs))
        if diffs[t] > 1e-6:
            continue
        row = per_thr_cls[t]
        out[label] = float(np.nanmean(row)) if (~np.isnan(row)).any() else 0.0
    for cls in range(num_classes):
        col = per_thr_cls[:, cls]
        if (~np.isnan(col)).any():
            out[f"AP_class{cls}"] = float(np.nanmean(col))
    return out


def records_to_frames(records, with_scores: bool):
    """Group submission.TrackRecord rows by (context, camera, timestamp).

    Returns pred_frames or gt_frames tuples for evaluate_detections; record
    object_type (Waymo 1/2/4) is mapped back to internal classes 0/1/2.
    """
    from waymo_2d_tracking_tpu_torch.io_out.submission import CLASS_TO_WAYMO_TYPE

    type_to_class = {t: i for i, t in enumerate(CLASS_TO_WAYMO_TYPE)}
    by_key: Dict[object, List] = {}
    for r in records:
        if r.object_type not in type_to_class:
            # e.g. Waymo TYPE_SIGN (3): not one of the tracked classes —
            # skip rather than silently aliasing to vehicle
            continue
        key = (r.context_name, r.camera_name, r.timestamp_micros)
        by_key.setdefault(key, []).append(r)
    frames = []
    for key, rows in sorted(by_key.items()):
        boxes = np.array([r.to_xyxy() for r in rows], float).reshape(-1, 4)
        classes = np.array(
            [type_to_class[r.object_type] for r in rows], int
        )
        if with_scores:
            scores = np.array([r.score for r in rows], float)
            frames.append((key, boxes, scores, classes))
        else:
            frames.append((key, boxes, classes))
    return frames
