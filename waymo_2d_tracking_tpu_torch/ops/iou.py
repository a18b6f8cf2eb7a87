"""Batched pairwise IoU (counterpart of ``ops/iou.py``)."""
from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of [x1,y1,x2,y2] boxes; clamped at 0 for degenerate boxes."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def pairwise_intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection areas. a: (..., N, 4), b: (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU. a: (..., N, 4), b: (..., M, 4) -> (..., N, M) in [0, 1]."""
    inter = pairwise_intersection(a, b)
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=eps)
