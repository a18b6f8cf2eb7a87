"""Anchor-free FCOS heads (counterpart of ``models/heads.py``): shared
GroupNorm conv towers over every pyramid level, per-location class logits,
ltrb distances (exp of a per-level scaled output, in stride units) and
centerness. NCHW inside; ``FCOSHeads`` returns NHWC like the JAX module."""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from waymo_2d_tracking_tpu_torch.models.quant import make_conv

GN_EPS = 1e-6  # flax nn.GroupNorm's epsilon (torch's default is 1e-5)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` without ``F.group_norm``'s Python check that refuses
    one value per group: a 1x1 pyramid level of a single image (P7 of a
    64x96 input, 32 groups of 32 channels) is valid, and flax normalizes it
    to the bias. The same ATen op computes it."""

    def forward(self, x):
        return torch.group_norm(x, self.num_groups, self.weight, self.bias, self.eps,
                                torch.backends.cudnn.enabled)


class HeadTower(nn.Module):
    """``depth`` x (3x3 conv, GroupNorm 32, relu); the convs from
    ``make_conv`` (quantized only under ``quant_scope='all'``)."""

    def __init__(self, in_ch: int, depth: int = 4, channels: int = 256, quant: str = "off",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"conv{i}", make_conv(quant, in_ch if i == 0 else channels,
                                                  channels, 3, padding=1, dtype=dtype))
            self.add_module(f"gn{i}", GroupNorm(32, channels, eps=GN_EPS))

    def forward(self, x):
        for i in range(self.depth):
            x = F.relu(getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x)))
        return x


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class FCOSHeads(nn.Module):
    """Per level: (cls_logits (N,H,W,K), ltrb (N,H,W,4) f32 in stride units,
    centerness (N,H,W,1)), all NHWC."""

    def __init__(self, in_ch: int, num_classes: int = 3, depth: int = 4,
                 channels: int = 256, levels: Sequence[int] = (3, 4, 5, 6, 7),
                 quant: str = "off", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.levels = tuple(levels)
        self.cls_tower = HeadTower(in_ch, depth, channels, quant, dtype)
        self.box_tower = HeadTower(in_ch, depth, channels, quant, dtype)
        # the predictor convs stay float in every mode, as in the JAX heads
        self.cls_logits = nn.Conv2d(channels, num_classes, 3, padding=1)
        self.box_ltrb = nn.Conv2d(channels, 4, 3, padding=1)
        self.centerness = nn.Conv2d(channels, 1, 3, padding=1)
        for lvl in self.levels:
            self.register_parameter(f"scale{lvl}", nn.Parameter(torch.ones(())))

    def forward(self, feats: Dict[int, torch.Tensor]):
        out = {}
        for lvl in self.levels:
            x = feats[lvl]
            ct = self.cls_tower(x)
            bt = self.box_tower(x)
            scale = getattr(self, f"scale{lvl}").float()
            cls_logits = self.cls_logits(ct)
            ltrb = torch.exp(self.box_ltrb(bt).float() * scale)
            ctr = self.centerness(bt)
            out[lvl] = (_nhwc(cls_logits), _nhwc(ltrb), _nhwc(ctr))
        return out


def decode_level(ltrb: torch.Tensor, stride: int) -> torch.Tensor:
    """Decode ltrb distances (N, H, W, 4, stride units) to xyxy image
    coordinates. Location centers at ((j+0.5)s, (i+0.5)s)."""
    n, h, w, _ = ltrb.shape
    dev = ltrb.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * stride
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * stride
    cy = ys[None, :, None].expand(n, h, w)
    cx = xs[None, None, :].expand(n, h, w)
    d = ltrb * stride
    return torch.stack(
        [cx - d[..., 0], cy - d[..., 1], cx + d[..., 2], cy + d[..., 3]], dim=-1
    )
