"""Appearance-embedding (ReID) head (counterpart of ``models/reid.py``).

(R, P, P, C) RoIAligned features -> conv/GN/relu -> conv/relu -> flatten in
NHWC order (as the JAX head flattens (P, P, C), so the Dense weight maps
unchanged) -> Dense -> L2-normalized (R, E) float32 embeddings (the norm in
XLA's order, ``utils/l2norm.py``). The two convs come from ``make_conv``
(quantized only under ``quant_scope='all'``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from waymo_2d_tracking_tpu_torch.models.heads import GN_EPS
from waymo_2d_tracking_tpu_torch.models.quant import make_conv
from waymo_2d_tracking_tpu_torch.utils import l2norm


class ReIDHead(nn.Module):
    def __init__(self, in_ch: int, embed_dim: int = 128, channels: int = 256,
                 pool: int = 7, quant: str = "off", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv0 = make_conv(quant, in_ch, channels, 3, padding=1, dtype=dtype)
        self.gn0 = nn.GroupNorm(32, channels, eps=GN_EPS)
        self.conv1 = make_conv(quant, channels, channels, 3, padding=1, dtype=dtype)
        self.proj = nn.Linear(pool * pool * channels, embed_dim)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled.permute(0, 3, 1, 2)
        x = F.relu(self.gn0(self.conv0(x)))
        x = F.relu(self.conv1(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.proj(x).float()
        return l2norm.l2_normalize(x)
