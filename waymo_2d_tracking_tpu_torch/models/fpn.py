"""Feature Pyramid Network (counterpart of ``models/fpn.py``): P3..P5 from
C3..C5 by lateral 1x1 convs, a nearest 2x top-down pathway and 3x3 smoothing;
P6/P7 by stride-2 convs on P5 (the FCOS convention). NCHW inside; the convs
come from ``models/quant.py make_conv`` (``quant``, ``dtype``)."""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from waymo_2d_tracking_tpu_torch.models.quant import make_conv


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 2H, 2W), nearest neighbour, by a broadcast as
    in the JAX module (its backward is a sum, with no scattered adds)."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(n, c, 2 * h, 2 * w)


class FPN(nn.Module):
    def __init__(self, in_channels: Dict[int, int], channels: int = 256,
                 levels: Sequence[int] = (3, 4, 5, 6, 7), quant: str = "off",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.levels = tuple(levels)
        conv = lambda *a, **kw: make_conv(quant, *a, dtype=dtype, **kw)  # noqa: E731
        for lvl in (3, 4, 5):
            self.add_module(f"lateral{lvl}", conv(in_channels[lvl], channels, 1))
            self.add_module(f"smooth{lvl}", conv(channels, channels, 3, padding=1))
        if 6 in self.levels:
            self.p6 = conv(channels, channels, 3, 2, padding=1)
        if 7 in self.levels:
            self.p7 = conv(channels, channels, 3, 2, padding=1)

    def forward(self, feats: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        laterals = {lvl: getattr(self, f"lateral{lvl}")(feats[lvl]) for lvl in (3, 4, 5)}
        merged = {5: laterals[5]}
        for lvl in (4, 3):
            up = nearest_upsample_2x(merged[lvl + 1])
            up = up[:, :, : laterals[lvl].shape[2], : laterals[lvl].shape[3]]
            merged[lvl] = laterals[lvl] + up
        outs = {lvl: getattr(self, f"smooth{lvl}")(merged[lvl]) for lvl in (3, 4, 5)}
        if 6 in self.levels:
            outs[6] = self.p6(outs[5])
        if 7 in self.levels:
            outs[7] = self.p7(F.relu(outs[6]))
        return {lvl: outs[lvl] for lvl in self.levels}
