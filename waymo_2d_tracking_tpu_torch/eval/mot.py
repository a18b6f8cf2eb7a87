"""CLEAR-MOT evaluation: MOTA / MOTP / ID switches (component C22).

The reference relies on py-motmetrics / the waymo_open_dataset C++ metric ops
(SURVEY.md §2 C22, [RECALLED]); this is a small exact reimplementation of the
CLEAR-MOT protocol (Bernardin & Stiefelhagen 2008, as summarized in the SORT
paper §IV: MOTA = 1 - (FN + FP + IDSW) / num_GT). Offline host path — plain
numpy + scipy is the right tool here (SURVEY.md §3.4), the on-device auction
is for the per-frame hot loop, not offline eval.

Protocol per frame:
  1. Keep last frame's GT->hypothesis correspondences that still overlap
     (IoU >= threshold) — CLEAR's temporal-consistency rule.
  2. Hungarian-match remaining GT to remaining hypotheses on IoU.
  3. A GT matched to a different hypothesis id than its previous one counts
     one ID switch. Unmatched GT -> FN; unmatched hypotheses -> FP.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


@dataclasses.dataclass
class MotMetrics:
    mota: float
    motp: float            # mean IoU over matches (higher = better)
    idf1: float            # identity F1 (global trajectory matching)
    num_frames: int
    num_gt: int
    num_matches: int
    num_fp: int
    num_fn: int
    num_idsw: int
    mostly_tracked: int    # GT trajectories matched >= 80% of their frames
    mostly_lost: int       # GT trajectories matched <= 20% of their frames

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _idf1(gt_frames, hyp_frames, iou_threshold: float) -> float:
    """Identity F1 (Ristani et al. 2016): one GLOBAL bipartite matching of
    GT trajectories to hypothesis trajectories maximizing co-occurring
    (IoU-feasible) frames; IDTP is that total overlap."""
    pair_counts: Dict[Tuple[int, int], int] = {}
    total_gt = total_hyp = 0
    for (gt_ids, gt_boxes), (hyp_ids, hyp_boxes) in zip(gt_frames, hyp_frames):
        gt_ids = np.asarray(gt_ids)
        hyp_ids = np.asarray(hyp_ids)
        total_gt += len(gt_ids)
        total_hyp += len(hyp_ids)
        if len(gt_ids) == 0 or len(hyp_ids) == 0:
            continue
        iou = _frame_iou(np.asarray(gt_boxes, float), np.asarray(hyp_boxes, float))
        feasible = iou >= iou_threshold
        for gi, hj in zip(*np.nonzero(feasible)):
            key = (int(gt_ids[gi]), int(hyp_ids[hj]))
            pair_counts[key] = pair_counts.get(key, 0) + 1
    if not pair_counts:
        return 0.0
    g_ids = sorted({g for g, _ in pair_counts})
    h_ids = sorted({h for _, h in pair_counts})
    g_idx = {g: i for i, g in enumerate(g_ids)}
    h_idx = {h: i for i, h in enumerate(h_ids)}
    counts = np.zeros((len(g_ids), len(h_ids)))
    for (g, h), c in pair_counts.items():
        counts[g_idx[g], h_idx[h]] = c
    ri, ci = linear_sum_assignment(-counts)
    idtp = counts[ri, ci].sum()
    # IDF1 = 2*IDTP / (total_gt + total_hyp)
    return float(2 * idtp / max(total_gt + total_hyp, 1))


def _frame_iou(gt_boxes: np.ndarray, hyp_boxes: np.ndarray) -> np.ndarray:
    if len(gt_boxes) == 0 or len(hyp_boxes) == 0:
        return np.zeros((len(gt_boxes), len(hyp_boxes)))
    lt = np.maximum(gt_boxes[:, None, :2], hyp_boxes[None, :, :2])
    rb = np.minimum(gt_boxes[:, None, 2:], hyp_boxes[None, :, 2:])
    wh = np.maximum(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_g = np.prod(np.maximum(gt_boxes[:, 2:] - gt_boxes[:, :2], 0), axis=1)
    area_h = np.prod(np.maximum(hyp_boxes[:, 2:] - hyp_boxes[:, :2], 0), axis=1)
    union = area_g[:, None] + area_h[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def combine_mot(parts: Sequence[MotMetrics]) -> MotMetrics:
    """Exact pooled CLEAR-MOT from independently evaluated parts.

    Valid whenever the parts share no trajectories (per-(context, camera)
    segments with interned ids — the `w2t eval` case): every CLEAR count is
    additive, MOTP re-weights by matches, and IDF1's global trajectory
    matching decomposes per part, so IDTP is recoverable from each part's
    idf1 = 2*IDTP / (num_gt + num_matches + num_fp). Equality with
    `evaluate_mot` on the concatenated frame list is unit-tested; this form
    avoids the second full (Hungarian-per-frame) pass over the whole split.
    """
    gt = sum(p.num_gt for p in parts)
    matches = sum(p.num_matches for p in parts)
    fp = sum(p.num_fp for p in parts)
    fn = sum(p.num_fn for p in parts)
    idsw = sum(p.num_idsw for p in parts)
    idtp = sum(p.idf1 * (p.num_gt + p.num_matches + p.num_fp) / 2.0
               for p in parts)
    return MotMetrics(
        mota=1.0 - (fn + fp + idsw) / max(gt, 1),
        motp=(sum(p.motp * p.num_matches for p in parts) / max(matches, 1)),
        idf1=2.0 * idtp / max(gt + matches + fp, 1),
        num_frames=sum(p.num_frames for p in parts),
        num_gt=gt,
        num_matches=matches,
        num_fp=fp,
        num_fn=fn,
        num_idsw=idsw,
        mostly_tracked=sum(p.mostly_tracked for p in parts),
        mostly_lost=sum(p.mostly_lost for p in parts),
    )


def evaluate_mot(
    gt_frames: Sequence[Tuple[np.ndarray, np.ndarray]],
    hyp_frames: Sequence[Tuple[np.ndarray, np.ndarray]],
    iou_threshold: float = 0.5,
) -> MotMetrics:
    """Evaluate CLEAR-MOT over a clip.

    gt_frames:  per frame (ids (G,) int, boxes (G, 4) xyxy).
    hyp_frames: per frame (ids (H,) int, boxes (H, 4) xyxy).
    """
    assert len(gt_frames) == len(hyp_frames)
    num_gt = num_fp = num_fn = num_idsw = num_matches = 0
    iou_sum = 0.0
    # last hypothesis id matched to each GT id (persists across gaps, per CLEAR)
    last_match: Dict[int, int] = {}
    # per-GT-trajectory (frames present, frames matched) for MT/ML
    traj_seen: Dict[int, int] = {}
    traj_matched: Dict[int, int] = {}

    for (gt_ids, gt_boxes), (hyp_ids, hyp_boxes) in zip(gt_frames, hyp_frames):
        gt_ids = np.asarray(gt_ids)
        hyp_ids = np.asarray(hyp_ids)
        g, h = len(gt_ids), len(hyp_ids)
        num_gt += g
        iou = _frame_iou(np.asarray(gt_boxes, float), np.asarray(hyp_boxes, float))

        matched_g = np.zeros(g, bool)
        matched_h = np.zeros(h, bool)
        pairs: List[Tuple[int, int]] = []

        # 1. carry over still-valid correspondences
        for gi in range(g):
            prev = last_match.get(int(gt_ids[gi]))
            if prev is None:
                continue
            hj = np.flatnonzero(hyp_ids == prev)
            if len(hj) and iou[gi, hj[0]] >= iou_threshold and not matched_h[hj[0]]:
                matched_g[gi] = True
                matched_h[hj[0]] = True
                pairs.append((gi, hj[0]))

        # 2. Hungarian on the rest (maximize IoU among feasible pairs)
        free_g = np.flatnonzero(~matched_g)
        free_h = np.flatnonzero(~matched_h)
        if len(free_g) and len(free_h):
            sub = iou[np.ix_(free_g, free_h)]
            cost = 1.0 - sub
            cost[sub < iou_threshold] = 1e6  # infeasible
            ri, ci = linear_sum_assignment(cost)
            for r, c in zip(ri, ci):
                if sub[r, c] >= iou_threshold:
                    pairs.append((free_g[r], free_h[c]))
                    matched_g[free_g[r]] = True
                    matched_h[free_h[c]] = True

        # 3. count
        for gid in gt_ids:
            traj_seen[int(gid)] = traj_seen.get(int(gid), 0) + 1
        for gi, hj in pairs:
            gid, hid = int(gt_ids[gi]), int(hyp_ids[hj])
            if gid in last_match and last_match[gid] != hid:
                num_idsw += 1
            last_match[gid] = hid
            num_matches += 1
            iou_sum += iou[gi, hj]
            traj_matched[gid] = traj_matched.get(gid, 0) + 1
        num_fn += int((~matched_g).sum())
        num_fp += int((~matched_h).sum())

    mota = 1.0 - (num_fn + num_fp + num_idsw) / max(num_gt, 1)
    motp = iou_sum / max(num_matches, 1)
    mt = ml = 0
    for gid, seen in traj_seen.items():
        ratio = traj_matched.get(gid, 0) / seen
        if ratio >= 0.8:
            mt += 1
        elif ratio <= 0.2:
            ml += 1
    return MotMetrics(
        mota=mota, motp=motp,
        idf1=_idf1(gt_frames, hyp_frames, iou_threshold),
        num_frames=len(gt_frames), num_gt=num_gt,
        num_matches=num_matches, num_fp=num_fp, num_fn=num_fn, num_idsw=num_idsw,
        mostly_tracked=mt, mostly_lost=ml,
    )


def suppress_ignored(
    gt_frames: Sequence[Tuple[np.ndarray, np.ndarray]],
    hyp_frames: Sequence[Tuple[np.ndarray, np.ndarray]],
    ignore_frames: Sequence[np.ndarray],
    iou_threshold: float = 0.5,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Protocol preprocessing: drop hypothesis boxes sitting on ignore /
    distractor regions (MOT-style GT carries 'do not care'
    annotations: zero-marked rows, static persons, reflections, crowds;
    the official scorers remove tracker boxes matched to them BEFORE
    counting FPs, so a tracker is not penalized for detecting something a
    human annotator declined to score).

    Per frame: hypotheses are first Hungarian-matched to the real GT
    (IoU >= iou_threshold); an UNMATCHED hypothesis is then removed when
    it overlaps an ignore box at IoU >= iou_threshold, or when >= 50% of
    its own area lies inside one (the region test — a small detection
    inside a large crowd region has tiny IoU but is exactly what the
    region marks). Matched hypotheses are never removed.

    Returns filtered hyp_frames, applied identically before CLEAR/IDF1
    and HOTA so all metrics see one prediction set. This mirrors (not
    bit-replicates) TrackEval's MOTChallenge preprocessing, which matches
    distractors jointly; the practical difference is confined to boxes
    that tie between a real GT and a distractor at the same IoU.
    """
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    for (gt_ids, gt_boxes), (hyp_ids, hyp_boxes), ign in zip(
        gt_frames, hyp_frames, ignore_frames
    ):
        hyp_ids = np.asarray(hyp_ids)
        hyp_boxes = np.asarray(hyp_boxes, float).reshape(len(hyp_ids), 4)
        ign = np.asarray(ign, float).reshape(-1, 4)
        if len(hyp_ids) == 0 or len(ign) == 0:
            out.append((hyp_ids, hyp_boxes))
            continue
        matched = np.zeros(len(hyp_ids), bool)
        gt_boxes = np.asarray(gt_boxes, float).reshape(len(gt_ids), 4)
        if len(gt_ids):
            iou = _frame_iou(gt_boxes, hyp_boxes)
            cost = 1.0 - iou
            cost[iou < iou_threshold] = 1e6
            ri, ci = linear_sum_assignment(cost)
            for r, c in zip(ri, ci):
                if iou[r, c] >= iou_threshold:
                    matched[c] = True
        ign_iou = _frame_iou(ign, hyp_boxes)            # (I, H)
        # intersection / hyp area (region containment)
        x1 = np.maximum(ign[:, None, 0], hyp_boxes[None, :, 0])
        y1 = np.maximum(ign[:, None, 1], hyp_boxes[None, :, 1])
        x2 = np.minimum(ign[:, None, 2], hyp_boxes[None, :, 2])
        y2 = np.minimum(ign[:, None, 3], hyp_boxes[None, :, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        areas = np.maximum(
            (hyp_boxes[:, 2] - hyp_boxes[:, 0])
            * (hyp_boxes[:, 3] - hyp_boxes[:, 1]), 1e-9)
        on_ignore = np.logical_or(
            ign_iou >= iou_threshold, inter / areas[None, :] >= 0.5
        ).any(axis=0)
        keep = np.logical_or(matched, ~on_ignore)
        out.append((hyp_ids[keep], hyp_boxes[keep]))
    return out


def track_outputs_to_frames(outputs, num_frames: int):
    """Convert stacked TrackOutputs (T, S) pytree -> list of (ids, boxes)."""
    valid = np.asarray(outputs.valid)
    ids = np.asarray(outputs.track_id)
    boxes = np.asarray(outputs.boxes)
    frames = []
    for t in range(num_frames):
        m = valid[t]
        frames.append((ids[t][m], boxes[t][m]))
    return frames


def gt_to_frames(gt: dict):
    """Convert data.synthetic ground truth dict -> list of (ids, boxes)."""
    frames = []
    for t in range(gt["boxes"].shape[0]):
        m = gt["present"][t]
        frames.append((gt["ids"][m], gt["boxes"][t][m]))
    return frames
