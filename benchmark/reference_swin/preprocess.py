"""Staging in plain PyTorch: the decode downscale (OpenCV's INTER_AREA on
frames whose sides the factor divides) and the letterbox (ImageNet
normalisation, bilinear resize as two float32 matrix products, top-left
zero pad)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def area_downscale(frames: torch.Tensor, d: int) -> torch.Tensor:
    """(N, H, W, C) uint8 -> (N, H/d, W/d, C) uint8 as ``cv2.resize(...,
    INTER_AREA)`` gives it when d divides H and W: the cell's integer sum,
    at d = 2 rounded half up as (s + 2) >> 2, otherwise times float32 1/d^2
    rounded half to even."""
    if d == 1:
        return frames
    n, h, w, c = frames.shape
    if h % d or w % d:
        raise ValueError(f"the reference downscales only by a factor of the sides, {h}x{w} / {d}")
    cells = frames.view(n, h // d, d, w // d, d, c).sum(dim=(2, 4), dtype=torch.int32)
    if d == 2:
        return ((cells + 2) >> 2).to(torch.uint8)
    scaled = cells.to(torch.float32) * torch.tensor(1.0 / (d * d), dtype=torch.float32).item()
    return torch.clamp(torch.round(scaled), 0, 255).to(torch.uint8)


def _resize_matrix(src: int, dst: int, scale: float, device) -> torch.Tensor:
    pos = (torch.arange(dst, dtype=torch.float32, device=device) + 0.5) / scale - 0.5
    pos = torch.clamp(pos, 0.0, src - 1.0)
    grid = torch.arange(src, dtype=torch.float32, device=device)
    w = torch.clamp(1.0 - torch.abs(pos[:, None] - grid[None, :]), min=0.0)
    return w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-8)


def letterbox(frames: torch.Tensor, dst_hw):
    """(N, H, W, 3) uint8 -> ((N, Hd, Wd, 3) float32, scale)."""
    n, hs, ws, _ = frames.shape
    hd, wd = dst_hw
    scale = min(hd / hs, wd / ws)
    eh, ew = int(round(hs * scale)), int(round(ws * scale))
    dev = frames.device
    x = frames.to(torch.float32) / 255.0
    x = (x - torch.tensor(MEAN, device=dev)) / torch.tensor(STD, device=dev)
    if (eh, ew) != (hs, ws):
        x = torch.einsum("eh,nhwc->newc", _resize_matrix(hs, eh, scale, dev), x)
        x = torch.einsum("fw,newc->nefc", _resize_matrix(ws, ew, scale, dev), x)
    return F.pad(x, (0, 0, 0, wd - ew, 0, hd - eh)), scale
