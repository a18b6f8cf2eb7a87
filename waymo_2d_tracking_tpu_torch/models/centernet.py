"""CenterNet head family (counterpart of ``models/centernet.py``; Zhou et al.,
"Objects as Points"): a per-class center heatmap, a size and a sub-pixel
offset on one pyramid level (``centernet_level``, P3 by default).

Peaks are 3x3 local maxima of the heat probabilities; their top-k is decoded
into boxes with the same (boxes, scores, classes) contract as the FCOS
candidates, so NMS, the TTA union, ReID pooling and the tracker apply
unchanged. The module names follow the flax ones (``tower``, ``heat``,
``wh``, ``offset``), so ``weights.from_flax_numpy`` maps them directly.

The training half: ``centernet_targets`` (Gaussian heatmaps splatted with
CornerNet's radius, exactly 1 at each centre; per-object log sizes and
sub-pixel offsets at flat centre indices) and ``centernet_loss`` (the
penalty-reduced focal loss on the heatmap, L1 on size and offset gathered
at the centres), with ``fcos_loss``'s contract.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from waymo_2d_tracking_tpu_torch.models.heads import HeadTower, _nhwc
from waymo_2d_tracking_tpu_torch.ops.nms import topk_stable
from waymo_2d_tracking_tpu_torch.parallel.collectives import sum_detached

PRIOR_BIAS = -4.595   # sigmoid prior p = 0.01 on the class / heat logits


class CenterNetHeads(nn.Module):
    """{level: (heat (N,H,W,K), wh (N,H,W,2) log stride units, offset
    (N,H,W,2))}, all NHWC."""

    def __init__(self, in_ch: int, num_classes: int = 3, depth: int = 2,
                 channels: int = 256, level: int = 3, quant: str = "off",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.level = level
        self.tower = HeadTower(in_ch, depth, channels, quant, dtype)   # heat, wh, offset float
        self.heat = nn.Conv2d(channels, num_classes, 3, padding=1)
        self.wh = nn.Conv2d(channels, 2, 3, padding=1)
        self.offset = nn.Conv2d(channels, 2, 3, padding=1)

    def forward(self, feats: Dict[int, torch.Tensor]):
        t = self.tower(feats[self.level])
        return {self.level: (_nhwc(self.heat(t)), _nhwc(self.wh(t)), _nhwc(self.offset(t)))}


def heat_peaks(prob: torch.Tensor) -> torch.Tensor:
    """Keep only 3x3-neighbourhood maxima of (N, H, W, K) heat probabilities
    (max-pool padded with -inf, then equality; equal neighbours both stay)."""
    pooled = F.max_pool2d(prob.permute(0, 3, 1, 2), 3, stride=1, padding=1)
    pooled = pooled.permute(0, 2, 3, 1)
    return torch.where(prob == pooled, prob, torch.zeros_like(prob))


def gather_centernet_candidates_batched(head_out, cfg):
    """Peak top-k decode: (boxes (N,C,4) xyxy image px, scores, classes)."""
    ((lvl, (heat, wh, off)),) = head_out.items()
    stride = 2 ** lvl
    n, h, w, k = heat.shape
    prob = heat_peaks(torch.sigmoid(heat.float()))
    flat = prob.reshape(n, -1)                              # (N, H*W*K)
    k_eff = min(cfg.pre_nms_topk, flat.shape[1])
    scores, idx = topk_stable(flat, k_eff)                  # lax.top_k order
    loc = idx // k
    cls = (idx % k).to(torch.int32)
    ci = loc // w
    cj = loc % w

    index = loc[..., None].expand(-1, -1, 2)
    o = torch.gather(off.float().reshape(n, -1, 2), 1, index)                  # (N, C, 2)
    s_wh = torch.gather(torch.exp(wh.float()).reshape(n, -1, 2), 1, index) * stride
    cx = (cj.to(torch.float32) + 0.5 + o[..., 0]) * stride
    cy = (ci.to(torch.float32) + 0.5 + o[..., 1]) * stride
    boxes = torch.stack(
        [cx - s_wh[..., 0] / 2, cy - s_wh[..., 1] / 2,
         cx + s_wh[..., 0] / 2, cy + s_wh[..., 1] / 2], dim=-1,
    )
    return boxes, scores, cls


# ---------------------------------------------------------------------------
# training targets + loss


def gaussian_radius(box_h: torch.Tensor, box_w: torch.Tensor,
                    min_overlap: float = 0.7) -> torch.Tensor:
    """CornerNet radius rule: the largest r such that a corner displaced by r
    still gives IoU >= min_overlap (three quadratic cases, the min).
    Feature-map units."""
    b1 = box_h + box_w
    c1 = box_w * box_h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0.0))) / 2
    b2 = 2 * (box_h + box_w)
    c2 = (1 - min_overlap) * box_w * box_h
    r2 = (b2 - torch.sqrt(torch.clamp(b2 ** 2 - 4 * 4.0 * c2, min=0.0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (box_h + box_w)
    c3 = (min_overlap - 1) * box_w * box_h
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))) / (2 * a3)
    return torch.clamp(torch.minimum(torch.minimum(r1, r2), r3), min=0.0)


def centernet_targets(gt_boxes, gt_classes, gt_valid, h: int, w: int, stride: int,
                      num_classes: int):
    """Targets, batched over the leading axes of the GT (..., G):
      heat_t (..., H, W, K) splatted Gaussians (exactly 1.0 at centres),
      wh_t (..., G, 2) log stride-unit sizes, off_t (..., G, 2) sub-pixel
      offsets, loc (..., G) flat centre indices, pos (..., G) validity."""
    gt_boxes = gt_boxes.float()
    x1, y1, x2, y2 = gt_boxes.unbind(-1)
    bw = torch.clamp(x2 - x1, min=1e-3) / stride
    bh = torch.clamp(y2 - y1, min=1e-3) / stride
    cx = (x1 + x2) / 2 / stride
    cy = (y1 + y2) / 2 / stride
    cj = torch.clamp(torch.floor(cx).to(torch.int64), 0, w - 1)
    ci = torch.clamp(torch.floor(cy).to(torch.int64), 0, h - 1)

    r = gaussian_radius(bh, bw)
    sigma2 = torch.clamp((2.0 * r + 1.0) / 6.0, min=1e-3) ** 2          # (..., G)
    dev = gt_boxes.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    d2 = ((ys[:, None] - ci[..., None, None].float()) ** 2
          + (xs[None, :] - cj[..., None, None].float()) ** 2)           # (..., G, H, W)
    gauss = torch.exp(-d2 / (2.0 * sigma2[..., None, None]))
    valid = gt_valid.bool()
    gauss = torch.where(valid[..., None, None], gauss, torch.zeros_like(gauss))
    onehot = F.one_hot(gt_classes.long(), num_classes).float()          # (..., G, K)
    heat_t = (gauss[..., None] * onehot[..., None, None, :]).amax(dim=-4)

    loc = ci * w + cj
    # the peak pixel is exactly 1 (a focal-loss positive); the splat maxes
    # below 1 when the float centre is off the integer grid
    peak = F.one_hot(loc, h * w).float().reshape(*loc.shape, h, w)
    peak = torch.where(valid[..., None, None], peak, torch.zeros_like(peak))
    heat_t = torch.maximum(heat_t, (peak[..., None] * onehot[..., None, None, :]).amax(dim=-4))

    wh_t = torch.log(torch.stack([bw, bh], dim=-1))
    off_t = torch.stack([cx - cj.float() - 0.5, cy - ci.float() - 0.5], dim=-1)
    return heat_t, wh_t, off_t, loc, valid


def penalty_reduced_focal(pred_logits, heat_t, alpha: float = 2.0, beta: float = 4.0):
    """CenterNet focal loss, summed (the caller normalises by the positives):
    (1-p)^alpha log p at heat_t == 1, (1-heat_t)^beta p^alpha log(1-p)
    elsewhere."""
    p = torch.sigmoid(pred_logits.float())
    eps = 1e-6
    pos_l = ((1 - p) ** alpha) * torch.log(p + eps)
    neg_l = ((1 - heat_t) ** beta) * (p ** alpha) * torch.log(1 - p + eps)
    return -torch.sum(torch.where(heat_t >= 1.0, pos_l, neg_l))


def centernet_loss(head_out, gt_boxes, gt_classes, gt_valid, num_classes: int,
                   wh_weight: float = 0.1, off_weight: float = 1.0, group=None):
    """Total CenterNet loss over a batch (``fcos_loss``'s contract, ``group``
    included: this rank's share, normalised by the global positives)."""
    ((lvl, (heat, wh, off)),) = head_out.items()
    stride = 2 ** lvl
    n, h, w, k = heat.shape
    heat_t, wh_t, off_t, loc, pos = centernet_targets(gt_boxes, gt_classes, gt_valid,
                                                      h, w, stride, k)
    loss_heat = penalty_reduced_focal(heat, heat_t)
    index = loc[..., None].expand(-1, -1, 2)
    wh_p = torch.gather(wh.float().reshape(n, -1, 2), 1, index)         # (N, G, 2)
    off_p = torch.gather(off.float().reshape(n, -1, 2), 1, index)
    m = pos[..., None].float()
    loss_wh = torch.sum(torch.abs(wh_p - wh_t) * m)
    loss_off = torch.sum(torch.abs(off_p - off_t) * m)

    num_pos = pos.float().sum()
    if group is not None:
        num_pos = sum_detached(num_pos, group)
    norm = torch.clamp(num_pos, min=1.0)
    loss_heat = loss_heat / norm
    loss_wh = wh_weight * loss_wh / norm
    loss_off = off_weight * loss_off / norm
    loss = loss_heat + loss_wh + loss_off
    return loss, {"loss": loss, "loss_cls": loss_heat, "loss_box": loss_wh,
                  "loss_ctr": loss_off, "num_pos": num_pos}
