"""Frame preprocessing on the device (counterpart of ``data/preprocess.py``):
uint8 -> float, ImageNet normalize, bilinear resize as two matrix products,
top-left letterbox pad."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _resize_matrix(src: int, dst: int, scale: float, device="cpu") -> torch.Tensor:
    """(dst, src) bilinear interpolation matrix for align_corners=False
    resizing by ``scale`` (dst pixel i samples src at (i + 0.5)/scale - 0.5)."""
    pos = (torch.arange(dst, dtype=torch.float32, device=device) + 0.5) / scale - 0.5
    pos = torch.clamp(pos, 0.0, src - 1.0)
    grid = torch.arange(src, dtype=torch.float32, device=device)
    w = torch.clamp(1.0 - torch.abs(pos[:, None] - grid[None, :]), min=0.0)
    return w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-8)


def letterbox_batch(
    frames: torch.Tensor,          # (N, Hs, Ws, 3) uint8
    src_hw: Tuple[int, int],
    dst_hw: Tuple[int, int],
    out_dtype=torch.float32,
):
    """uint8 frames -> normalized letterboxed (N, Hd, Wd, 3) + scale.

    The image keeps its aspect ratio, is anchored top-left and the rest is
    zero (after normalization). ``boxes_image = boxes_net / scale``.
    """
    hs, ws = src_hw
    hd, wd = dst_hw
    scale = min(hd / hs, wd / ws)
    eff_h, eff_w = int(round(hs * scale)), int(round(ws * scale))
    dev = frames.device

    x = frames.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev)
    x = (x - mean) / std

    if (eff_h, eff_w) != (hs, ws):
        ry = _resize_matrix(hs, eff_h, scale, dev)            # (eff_h, Hs)
        rx = _resize_matrix(ws, eff_w, scale, dev)            # (eff_w, Ws)
        x = torch.einsum("eh,nhwc->newc", ry, x)
        x = torch.einsum("fw,newc->nefc", rx, x)

    x = F.pad(x, (0, 0, 0, wd - eff_w, 0, hd - eff_h))
    return x.to(out_dtype), scale


def unletterbox_boxes(boxes: torch.Tensor, scale) -> torch.Tensor:
    """Map network-space xyxy boxes back to source-image pixels."""
    return boxes / scale
