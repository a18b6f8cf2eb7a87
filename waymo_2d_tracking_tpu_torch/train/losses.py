"""FCOS training losses and target assignment (counterpart of
``train/losses.py``), plain PyTorch, differentiable by autograd.

Target assignment is vectorised and fixed-shape (locations x max_gt,
masked): the smallest eligible GT box wins a location, ties to the lowest
index (``argmin``'s first minimum, as ``jnp.argmin``). Losses: sigmoid focal
(class), GIoU (box, on positives, centerness-weighted) and BCE (centerness),
all levels in float32 and normalised by the number of positives. The ReID
objectives (batch-hard triplet, supervised contrastive) take the GT-box
embeddings of ``Detector.forward_train``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

# FCOS level regression ranges (in image pixels, by pyramid level)
LEVEL_RANGES = {3: (0.0, 64.0), 4: (64.0, 128.0), 5: (128.0, 256.0),
                6: (256.0, 512.0), 7: (512.0, 1e8)}
INF = 1e8


def _maximum(x: torch.Tensor, v: float) -> torch.Tensor:
    """``jnp.maximum(x, v)``: at a tie the gradient splits in halves (as
    ``torch.maximum``'s), where ``torch.clamp`` would pass all of it."""
    return torch.maximum(x, x.new_tensor(v))


def level_locations(h: int, w: int, stride: int, device="cpu") -> torch.Tensor:
    """(H*W, 2) location centers (x, y) in image coordinates."""
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * stride
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * stride
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def assign_targets_level(
    locs: torch.Tensor,        # (L, 2) x,y
    gt_boxes: torch.Tensor,    # (..., G, 4) xyxy
    gt_classes: torch.Tensor,  # (..., G) int
    gt_valid: torch.Tensor,    # (..., G) bool
    level_range: Tuple[float, float],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-location targets, batched over the leading axes of the GT:
    (cls (..., L) int64 [-1 = background], ltrb (..., L, 4) in pixels,
    centerness (..., L))."""
    x, y = locs[:, 0:1], locs[:, 1:2]                          # (L, 1)
    gb = gt_boxes[..., None, :, :]                             # (..., 1, G, 4)
    ltrb = torch.stack([x - gb[..., 0], y - gb[..., 1],
                        gb[..., 2] - x, gb[..., 3] - y], dim=-1)  # (..., L, G, 4)
    inside = ltrb.amin(dim=-1) > 0.0
    maxreg = ltrb.amax(dim=-1)
    lo, hi = level_range
    eligible = inside & (maxreg >= lo) & (maxreg <= hi) & gt_valid[..., None, :].bool()

    area = (gt_boxes[..., 2] - gt_boxes[..., 0]) * (gt_boxes[..., 3] - gt_boxes[..., 1])
    area_masked = torch.where(eligible, area[..., None, :], torch.full_like(area[..., None, :], INF))
    best = torch.argmin(area_masked, dim=-1)                   # (..., L)
    has_target = eligible.any(dim=-1)

    cls_t = torch.where(has_target, torch.gather(gt_classes.long(), -1, best),
                        torch.full_like(best, -1))
    ltrb_t = torch.gather(ltrb, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    lr = torch.stack([ltrb_t[..., 0], ltrb_t[..., 2]], -1)
    tb = torch.stack([ltrb_t[..., 1], ltrb_t[..., 3]], -1)
    ctr_t = torch.sqrt(torch.clamp(
        (lr.amin(-1) / torch.clamp(lr.amax(-1), min=1e-6))
        * (tb.amin(-1) / torch.clamp(tb.amax(-1), min=1e-6)), 0.0, 1.0))
    return cls_t, ltrb_t, torch.where(has_target, ctr_t, torch.zeros_like(ctr_t))


def optax_sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross entropy, optax's formula (not
    ``F.binary_cross_entropy_with_logits``, which agrees in value but not
    always in the last ulp)."""
    # |x| as jnp.abs differentiates it: slope +1 at 0 (torch.abs has 0)
    abs_l = torch.where(logits >= 0, logits, -logits)
    return _maximum(logits, 0.0) - logits * labels + torch.log1p(torch.exp(-abs_l))


def sigmoid_focal_loss(logits, targets_onehot, alpha: float = 0.25, gamma: float = 2.0):
    """Element-wise focal loss; caller reduces."""
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, targets_onehot)
    p_t = p * targets_onehot + (1 - p) * (1 - targets_onehot)
    alpha_t = alpha * targets_onehot + (1 - alpha) * (1 - targets_onehot)
    return alpha_t * ((1 - p_t) ** gamma) * ce


def giou_loss(pred_ltrb: torch.Tensor, target_ltrb: torch.Tensor) -> torch.Tensor:
    """GIoU loss on ltrb distances around a shared center (FCOS form); the
    union and the enclosing area are clamped at 1e-6, as in JAX."""
    pl, pt, pr, pb = pred_ltrb.unbind(-1)
    tl, tt, tr, tb = target_ltrb.unbind(-1)
    p_area = (pl + pr) * (pt + pb)
    t_area = (tl + tr) * (tt + tb)
    iw = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    ih = torch.minimum(pt, tt) + torch.minimum(pb, tb)
    inter = _maximum(iw, 0.0) * _maximum(ih, 0.0)
    union = p_area + t_area - inter
    iou = inter / _maximum(union, 1e-6)
    cw = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    ch = torch.maximum(pt, tt) + torch.maximum(pb, tb)
    c_area = cw * ch
    giou = iou - (c_area - union) / _maximum(c_area, 1e-6)
    return 1.0 - giou


def fcos_loss(
    head_out: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    gt_boxes: torch.Tensor,    # (N, G, 4)
    gt_classes: torch.Tensor,  # (N, G)
    gt_valid: torch.Tensor,    # (N, G)
    num_classes: int,
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total FCOS loss over a batch and all levels (head outputs NHWC)."""
    total_cls = total_box = total_ctr = total_pos = 0.0
    gt_boxes = gt_boxes.float()
    for lvl, (cls_logits, ltrb_pred, ctr_logits) in head_out.items():
        n, h, w, k = cls_logits.shape
        stride = 2 ** lvl
        locs = level_locations(h, w, stride, device=cls_logits.device)
        cls_t, ltrb_t, ctr_t = assign_targets_level(locs, gt_boxes, gt_classes, gt_valid,
                                                    LEVEL_RANGES[lvl])    # (N, L...)
        pos = cls_t >= 0
        posf = pos.float()
        onehot = F.one_hot(torch.clamp(cls_t, min=0), num_classes).float() * posf[..., None]
        cls_flat = cls_logits.float().reshape(n, -1, k)
        total_cls = total_cls + torch.sum(
            sigmoid_focal_loss(cls_flat, onehot, focal_alpha, focal_gamma))

        ltrb_flat = ltrb_pred.float().reshape(n, -1, 4) * stride
        box_l = giou_loss(ltrb_flat, ltrb_t)
        total_box = total_box + torch.sum(box_l * ctr_t * posf)

        ctr_flat = ctr_logits.float().reshape(n, -1)
        total_ctr = total_ctr + torch.sum(optax_sigmoid_ce(ctr_flat, ctr_t) * posf)
        total_pos = total_pos + torch.sum(posf)

    norm = _maximum(total_pos, 1.0)
    loss_cls = total_cls / norm
    loss_box = total_box / norm
    loss_ctr = total_ctr / norm
    loss = loss_cls + loss_box + loss_ctr
    return loss, {"loss": loss, "loss_cls": loss_cls, "loss_box": loss_box,
                  "loss_ctr": loss_ctr, "num_pos": total_pos}


def _pair_masks(embeds, ids, valid):
    n, g, e = embeds.shape
    flat_e = embeds.reshape(n * g, e).float()
    flat_id = ids.reshape(n * g)
    flat_ok = valid.reshape(n * g).bool() & (flat_id >= 0)
    same = flat_id[:, None] == flat_id[None, :]
    pair_ok = flat_ok[:, None] & flat_ok[None, :]
    eye = torch.eye(n * g, dtype=torch.bool, device=embeds.device)
    return flat_e, flat_ok, same, pair_ok, eye


def reid_triplet_loss(embeds: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                      margin: float = 0.3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-hard triplet loss over cosine distance (Hermans et al. 2017):
    for each valid anchor the hardest positive and the hardest negative,
    hinged at ``margin``. Returns (mean over active anchors, active count);
    anchors without both a positive and a negative contribute nothing."""
    flat_e, flat_ok, same, pair_ok, eye = _pair_masks(embeds, ids, valid)
    dist = 1.0 - flat_e @ flat_e.T
    pos_mask = same & pair_ok & ~eye
    neg_mask = ~same & pair_ok
    big = 4.0   # > max cosine distance (2)
    hardest_pos = torch.where(pos_mask, dist, torch.full_like(dist, -big)).amax(dim=1)
    hardest_neg = torch.where(neg_mask, dist, torch.full_like(dist, big)).amin(dim=1)
    active = pos_mask.any(dim=1) & neg_mask.any(dim=1) & flat_ok
    per_anchor = _maximum(hardest_pos - hardest_neg + margin, 0.0)
    count = active.sum()
    loss = torch.where(active, per_anchor, torch.zeros_like(per_anchor)).sum() \
        / torch.clamp(count, min=1)
    return loss, count


def reid_supcon_loss(embeds: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                     temperature: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Supervised contrastive loss (Khosla et al. 2020) over the same
    (embeds, ids, valid) contract: for each valid anchor with a positive,
    -mean over its positives of log softmax over all other valid entries
    (cosine similarity / ``temperature``). Returns (mean over active
    anchors, active count)."""
    flat_e, flat_ok, same, pair_ok, eye = _pair_masks(embeds, ids, valid)
    sim = (flat_e @ flat_e.T) / torch.tensor(temperature, dtype=torch.float32,
                                             device=embeds.device)
    pos_mask = same & pair_ok & ~eye
    all_mask = pair_ok & ~eye
    neg_inf = -1e9
    sim_m = torch.where(all_mask, sim, torch.full_like(sim, neg_inf))
    rowmax = sim_m.amax(dim=1, keepdim=True)
    rowmax = torch.where(rowmax <= neg_inf / 2, torch.zeros_like(rowmax), rowmax)  # empty rows
    logz = rowmax[:, 0] + torch.log(
        torch.where(all_mask, torch.exp(sim - rowmax), torch.zeros_like(sim)).sum(dim=1) + 1e-20)
    log_p = sim - logz[:, None]
    n_pos = pos_mask.sum(dim=1)
    per_anchor = -torch.where(pos_mask, log_p, torch.zeros_like(log_p)).sum(dim=1) \
        / torch.clamp(n_pos, min=1)
    active = (n_pos > 0) & flat_ok
    count = active.sum()
    loss = torch.where(active, per_anchor, torch.zeros_like(per_anchor)).sum() \
        / torch.clamp(count, min=1)
    return loss, count
