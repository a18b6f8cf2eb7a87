"""Frame preprocessing on the device (counterpart of ``data/preprocess.py``):
uint8 -> float, ImageNet normalize, bilinear resize as two matrix products,
top-left letterbox pad; and ``area_downscale``, the port's own copy of the
``cv2.resize(..., INTER_AREA)`` downscale that the JAX package applies to
pre-decoded frames under ``decode_scale_denom > 1``."""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
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


def _area_taps(src: int, dst: int) -> List[List[Tuple[int, float]]]:
    """Per output index, the (source index, float32 weight) taps of an area
    resize from ``src`` to ``dst`` samples, in OpenCV's order and rounding
    (``computeResizeAreaTab``: cell edges in float64, taps under 1e-3 of a
    pixel dropped, weights cast to float32)."""
    scale = 1.0 / (dst / src)
    taps = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, float(np.float32((s1 - f1) / cell))))
        row.extend((s, float(np.float32(1.0 / cell))) for s in range(s1, s2))
        if f2 - s2 > 1e-3:
            row.append((s2, float(np.float32(min(f2 - s2, 1.0, cell) / cell))))
        taps.append(row)
    return taps


def _tap_tables(src: int, dst: int, device):
    """``_area_taps`` as (dst, K) index and float32 weight tensors, padded
    with weight 0 (adding 0.0 to a float32 sum changes nothing)."""
    taps = _area_taps(src, dst)
    k = max(len(t) for t in taps)
    idx = torch.zeros((dst, k), dtype=torch.long)
    wts = torch.zeros((dst, k), dtype=torch.float32)
    for d, row in enumerate(taps):
        for j, (s, w) in enumerate(row):
            idx[d, j], wts[d, j] = s, w
    return idx.to(device), wts.to(device)


def area_downscale(frames: torch.Tensor, denom: int) -> torch.Tensor:
    """(N, H, W, C) uint8 -> (N, ceil(H/d), ceil(W/d), C) uint8: the bytes
    ``cv2.resize(f, (ceil(W/d), ceil(H/d)), interpolation=cv2.INTER_AREA)``
    gives for each frame, on a CPU or a CUDA tensor alike.

    OpenCV rounds differently in each case, and so does this function:

    - H and W divisible by d = 2: the exact integer sum s of each 2x2 cell,
      rounded half up, ``(s + 2) >> 2``;
    - H and W divisible by any other d: the exact integer sum of each d x d
      cell times float32 ``1 / d^2``, rounded half to even;
    - otherwise: OpenCV's fractional-weight area average in float32, taps in
      its order: each source row summed along W (``acc + s * a`` per tap,
      one rounding each), then those rows summed along H (``acc + b *
      row``), rounded half to even and clamped to 0..255.

    Every operation is a separate elementwise PyTorch op (no fused
    multiply-add), so the CPU and the card give the same bytes.
    """
    if frames.dtype != torch.uint8 or frames.dim() != 4:
        raise ValueError(f"area_downscale takes (N, H, W, C) uint8, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    d = int(denom)
    if d < 1:
        raise ValueError(f"decode_scale_denom must be >= 1, got {denom}")
    if d == 1:
        return frames
    n, h, w, c = frames.shape
    sh, sw = -(-h // d), -(-w // d)
    if h % d == 0 and w % d == 0:
        cells = frames.view(n, sh, d, sw, d, c).sum(dim=(2, 4), dtype=torch.int32)
        if d == 2:
            return ((cells + 2) >> 2).to(torch.uint8)
        scaled = cells.to(torch.float32) * float(np.float32(1.0 / (d * d)))
        return torch.clamp(torch.round(scaled), 0, 255).to(torch.uint8)

    xi, xw = _tap_tables(w, sw, frames.device)
    yi, yw = _tap_tables(h, sh, frames.device)
    rows = torch.zeros((n, h, sw, c), dtype=torch.float32, device=frames.device)
    for j in range(xi.shape[1]):
        tap = frames.index_select(2, xi[:, j]).to(torch.float32)
        rows = rows + tap * xw[:, j, None]
    out = torch.zeros((n, sh, sw, c), dtype=torch.float32, device=frames.device)
    for j in range(yi.shape[1]):
        out = out + yw[:, j, None, None] * rows.index_select(1, yi[:, j])
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def unletterbox_boxes(boxes: torch.Tensor, scale) -> torch.Tensor:
    """Map network-space xyxy boxes back to source-image pixels."""
    return boxes / scale
