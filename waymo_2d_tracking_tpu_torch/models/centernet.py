"""CenterNet head family (counterpart of ``models/centernet.py``; Zhou et al.,
"Objects as Points"): a per-class center heatmap, a size and a sub-pixel
offset on one pyramid level (``centernet_level``, P3 by default).

Peaks are 3x3 local maxima of the heat probabilities; their top-k is decoded
into boxes with the same (boxes, scores, classes) contract as the FCOS
candidates, so NMS, the TTA union, ReID pooling and the tracker apply
unchanged. The module names follow the flax ones (``tower``, ``heat``,
``wh``, ``offset``), so ``weights.from_flax_numpy`` maps them directly.

The training half (targets, focal loss) is a later slice of the port.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from waymo_2d_tracking_tpu_torch.models.heads import HeadTower, _nhwc
from waymo_2d_tracking_tpu_torch.ops.nms import topk_stable

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
