"""HOTA evaluation (Luiten et al., IJCV 2021), a copy of the JAX package's
``eval/hota.py`` (host-only numpy + scipy; the port keeps its own).

The procedure is TrackEval's (trackeval/metrics/hota.py):

  pass 1 (once, alpha-independent): per frame, the potential-match count
      for each (gt_id, pred_id) pair accumulates the soft Jaccard-style
      similarity  sim_iou = iou / (rowsum + colsum - iou). Global alignment
      A_max(g, p) = pot(g, p) / (|g| + |p| - pot(g, p)).
  pass 2: per frame, Hungarian on  score = A_max * IoU  over all pairs;
      assigned pairs count as TPs only where IoU >= alpha - eps. Neither
      A_max nor IoU depends on alpha, so the Hungarian runs once per frame
      and the 19 per-alpha filters apply to that one assignment.
  DetA  = TP / (TP + FN + FP)
  AssA  = mean over TPs of  TPA / (TPA + FNA + FPA)
  LocA  = mean IoU over TPs
  HOTA(alpha) = sqrt(DetA * AssA), HOTA = mean over alpha in
  {0.05, 0.10, ..., 0.95}.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from waymo_2d_tracking_tpu_torch.eval.mot import _frame_iou

DEFAULT_ALPHAS = tuple(np.arange(0.05, 0.96, 0.05).round(2))


@dataclasses.dataclass
class HotaMetrics:
    hota: float            # mean over alphas of sqrt(DetA * AssA)
    deta: float            # mean detection accuracy over alphas
    assa: float            # mean association accuracy over alphas
    loca: float            # mean localization accuracy (TP-weighted)
    hota_50: float         # HOTA at alpha = 0.5 (single-threshold view)
    num_frames: int
    num_gt: int
    num_pred: int
    # raw per-alpha accumulators (A, 5): tp, fn, fp, ass_sum, loc_sum —
    # carried so combine_hota can pool sequences exactly (TrackEval's
    # combined-sequence accumulation); excluded from as_dict and from the
    # dataclass __eq__ (ndarray equality is elementwise and would raise)
    alphas: Tuple[float, ...] = ()
    counts: "np.ndarray | None" = dataclasses.field(default=None,
                                                    compare=False)

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d.pop("alphas")
        d.pop("counts")
        return d


def _intern_ids(frames) -> Tuple[List[np.ndarray], int]:
    """Per-frame id arrays -> per-frame contiguous index arrays + id count.

    Rejects duplicate ids within one frame: they are invalid tracker output,
    and the potential-match accumulation's fancy-index `+=` would silently
    drop the duplicate's contribution."""
    table: Dict[int, int] = {}
    out = []
    for t, (ids, _) in enumerate(frames):
        idx = np.array(
            [table.setdefault(int(i), len(table)) for i in ids], np.intp
        )
        if len(np.unique(idx)) != len(idx):
            raise ValueError(
                f"duplicate track/gt id within frame {t}: {list(ids)}"
            )
        out.append(idx)
    return out, len(table)


def _eval_all_alphas(
    gt_frames, hyp_frames, ious: List[np.ndarray],
    alphas: Sequence[float],
) -> np.ndarray:
    """All thresholds -> (A, 5) per-alpha (tp, fn, fp, ass_sum, loc_sum).

    Vectorized over ids (interned to contiguous indices) and over alphas
    (one Hungarian per frame, 19 filters)."""
    eps = np.finfo(float).eps
    gidx_frames, n_gt_ids = _intern_ids(gt_frames)
    pidx_frames, n_pr_ids = _intern_ids(hyp_frames)
    alphas = np.asarray(alphas, float)
    n_a = len(alphas)

    # pass 1 (once): soft potential-match counts + per-id appearance counts
    pot = np.zeros((n_gt_ids, n_pr_ids))
    gt_count = np.zeros(n_gt_ids)
    pr_count = np.zeros(n_pr_ids)
    for gidx, pidx, iou in zip(gidx_frames, pidx_frames, ious):
        np.add.at(gt_count, gidx, 1)
        np.add.at(pr_count, pidx, 1)
        if iou.size == 0:
            continue
        denom = iou.sum(0)[None, :] + iou.sum(1)[:, None] - iou
        sim = np.where(denom > eps, iou / np.maximum(denom, eps), 0.0)
        pot[np.ix_(gidx, pidx)] += sim
    align = pot / np.maximum(gt_count[:, None] + pr_count[None, :] - pot,
                             eps)

    # pass 2: one Hungarian per frame on align * iou; per-alpha TP filter
    matched = np.zeros((n_a, n_gt_ids, n_pr_ids), np.float32)
    tp = np.zeros(n_a)
    loc_sum = np.zeros(n_a)
    for gidx, pidx, iou in zip(gidx_frames, pidx_frames, ious):
        if iou.size == 0:
            continue
        score = align[np.ix_(gidx, pidx)] * iou
        ri, ci = linear_sum_assignment(-score)
        sims = iou[ri, ci]
        ok_all = sims[None, :] >= alphas[:, None] - eps      # (A, M)
        tp += ok_all.sum(axis=1)
        loc_sum += np.where(ok_all, sims[None, :], 0.0).sum(axis=1)
        gi, pi = gidx[ri], pidx[ci]
        for a in np.flatnonzero(ok_all.any(axis=1)):
            ok = ok_all[a]
            np.add.at(matched[a], (gi[ok], pi[ok]), 1.0)

    total_gt = gt_count.sum()
    total_pr = pr_count.sum()
    # AssA numerator: sum over TPs of TPA/(TPA+FNA+FPA)
    #   = sum over pairs of matched * (matched / (|g| + |p| - matched))
    denom = np.maximum(
        gt_count[None, :, None] + pr_count[None, None, :] - matched, 1.0
    )
    ass_sum = (matched * (matched / denom)).sum(axis=(1, 2))
    return np.stack(
        [tp, total_gt - tp, total_pr - tp, ass_sum, loc_sum], axis=1
    )


def _metrics_from_counts(
    alphas: Sequence[float], counts: np.ndarray,
    num_frames: int, num_gt: int, num_pred: int,
) -> HotaMetrics:
    """Per-alpha (tp, fn, fp, ass_sum, loc_sum) -> final HotaMetrics."""
    tp, fn, fp, ass_sum, loc_sum = counts.T
    detas = tp / np.maximum(tp + fn + fp, 1)
    assas = np.where(tp > 0, ass_sum / np.maximum(tp, 1), 0.0)
    locas = np.where(tp > 0, loc_sum / np.maximum(tp, 1), 0.0)
    hotas = np.sqrt(detas * assas)
    # LocA averaged only over alphas that had TPs
    has_tp = tp > 0
    alphas_arr = np.asarray(alphas)
    i50 = int(np.argmin(np.abs(alphas_arr - 0.5)))
    hota_50 = float(hotas[i50]) if abs(alphas_arr[i50] - 0.5) < 1e-6 else 0.0
    return HotaMetrics(
        hota=float(hotas.mean()),
        deta=float(detas.mean()),
        assa=float(assas.mean()),
        loca=float(locas[has_tp].mean()) if has_tp.any() else 0.0,
        hota_50=hota_50,
        num_frames=num_frames,
        num_gt=num_gt,
        num_pred=num_pred,
        alphas=tuple(float(a) for a in alphas),
        counts=counts,
    )


def evaluate_hota(
    gt_frames: Sequence[Tuple[np.ndarray, np.ndarray]],
    hyp_frames: Sequence[Tuple[np.ndarray, np.ndarray]],
    alphas: Sequence[float] = DEFAULT_ALPHAS,
) -> HotaMetrics:
    """Evaluate HOTA over a clip.

    gt_frames / hyp_frames: per frame (ids (N,) int, boxes (N, 4) xyxy) —
    the same frame format as eval/mot.evaluate_mot, so the two metrics run
    off one conversion (mot.track_outputs_to_frames / gt_to_frames).
    """
    assert len(gt_frames) == len(hyp_frames)
    ious = []
    num_gt = num_pred = 0
    for (gt_ids, gt_boxes), (hyp_ids, hyp_boxes) in zip(gt_frames, hyp_frames):
        num_gt += len(gt_ids)
        num_pred += len(hyp_ids)
        if len(gt_ids) and len(hyp_ids):
            ious.append(_frame_iou(
                np.asarray(gt_boxes, float), np.asarray(hyp_boxes, float)
            ))
        else:
            ious.append(np.zeros((len(gt_ids), len(hyp_ids))))

    counts = _eval_all_alphas(gt_frames, hyp_frames, ious, alphas)
    return _metrics_from_counts(alphas, counts, len(gt_frames), num_gt,
                                num_pred)


def combine_hota(parts: Sequence[HotaMetrics]) -> HotaMetrics:
    """Exact pooled HOTA from independently evaluated parts.

    Valid whenever parts share no trajectory ids (per-(context, camera)
    segments with interned ids): every per-alpha accumulator — TP/FN/FP,
    the per-TP association-Jaccard sum, the per-TP IoU sum — is additive
    because potential-match and matched counts never cross parts. This IS
    TrackEval's combined-sequence accumulation; equality with a
    concatenated re-run is unit-tested.
    """
    if not parts:
        return _metrics_from_counts(DEFAULT_ALPHAS,
                                    np.zeros((len(DEFAULT_ALPHAS), 5)),
                                    0, 0, 0)
    if any(p.counts is None for p in parts):
        raise ValueError(
            "combine_hota: a part carries no per-alpha counts (was it "
            "rebuilt from as_dict output?) — pooling it would silently "
            "undercount; re-run evaluate_hota for that sequence")
    alphas = parts[0].alphas
    if any(p.alphas != alphas for p in parts):
        raise ValueError("combine_hota: parts evaluated at different alphas")
    return _metrics_from_counts(
        alphas,
        np.sum([p.counts for p in parts], axis=0),
        num_frames=sum(p.num_frames for p in parts),
        num_gt=sum(p.num_gt for p in parts),
        num_pred=sum(p.num_pred for p in parts),
    )
