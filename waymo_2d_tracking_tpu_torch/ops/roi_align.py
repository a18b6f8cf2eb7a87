"""RoIAlign as separable matrix products (counterpart of the production form
in ``ops/roi_align.py``: ``roi_align_batched`` and
``roi_align_multilevel_batched``).

Bilinear interpolation is separable, so average-pooled RoIAlign (aligned=True,
sampling ratio s) is exactly ``out[r] = Wy[r] @ F @ Wx[r]^T`` per channel,
with Wy (P, H) / Wx (P, W) the averaged hat-function weights of the sample
points. The products run in the features' dtype, chunked over RoIs to bound
the (N, K, P, W, C) intermediate.
"""
from __future__ import annotations

import torch


def _interp_matrix(start: torch.Tensor, bin_size: torch.Tensor, num_bins: int,
                   sampling_ratio: int, size: int) -> torch.Tensor:
    """(R, num_bins, size) averaged bilinear weights along one axis."""
    s = sampling_ratio
    dev = start.device
    offs = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    bins = torch.arange(num_bins, dtype=torch.float32, device=dev)
    pos = (
        start[:, None, None]
        + (bins[None, :, None] + offs[None, None, :]) * bin_size[:, None, None]
    )                                                                 # (R, P, s)
    in_range = (pos >= -1.0) & (pos <= size)
    posc = torch.clamp(pos, 0.0, size - 1.0)
    grid = torch.arange(size, dtype=torch.float32, device=dev)
    hat = torch.clamp(1.0 - torch.abs(posc[..., None] - grid), min=0.0)  # (R,P,s,Z)
    hat = torch.where(in_range[..., None], hat, torch.zeros_like(hat))
    return hat.sum(dim=2) / s


def roi_align_batched(
    features: torch.Tensor,   # (N, H, W, C)
    boxes: torch.Tensor,      # (N, R, 4) xyxy image coords
    spatial_scale: float = 1.0,
    output_size: int = 7,
    sampling_ratio: int = 2,
    roi_chunk: int = 16,
) -> torch.Tensor:
    """Pooled features (N, R, P, P, C), aligned=True convention."""
    n, h, w, c = features.shape
    r = boxes.shape[1]
    p = output_size

    flat = boxes.reshape(-1, 4).float()
    x1 = flat[:, 0] * spatial_scale - 0.5
    y1 = flat[:, 1] * spatial_scale - 0.5
    x2 = flat[:, 2] * spatial_scale - 0.5
    y2 = flat[:, 3] * spatial_scale - 0.5
    bin_w = (x2 - x1) / p
    bin_h = (y2 - y1) / p

    wdt = features.dtype
    wy = _interp_matrix(y1, bin_h, p, sampling_ratio, h).reshape(n, r, p, h).to(wdt)
    wx = _interp_matrix(x1, bin_w, p, sampling_ratio, w).reshape(n, r, p, w).to(wdt)

    out = []
    for k0 in range(0, r, roi_chunk):
        wy_c, wx_c = wy[:, k0:k0 + roi_chunk], wx[:, k0:k0 + roi_chunk]
        rows = torch.einsum("nkph,nhwc->nkpwc", wy_c, features)
        out.append(torch.einsum("nkqw,nkpwc->nkpqc", wx_c, rows))
    return torch.cat(out, dim=1).to(wdt)


def roi_align_multilevel_batched(
    feature_levels,           # dict level -> (N, H_l, W_l, C)
    boxes: torch.Tensor,      # (N, R, 4) image coords
    level_strides,            # dict level -> stride
    canonical_level: int = 4,
    canonical_size: float = 224.0,
    output_size: int = 7,
    sampling_ratio: int = 2,
):
    """FPN-style RoIAlign: each box pools from the level matched to its scale
    (k = k0 + log2(sqrt(area)/224)), as a masked sum over levels."""
    areas = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0) * torch.clamp(
        boxes[..., 3] - boxes[..., 1], min=0.0
    )
    target = torch.floor(
        canonical_level + torch.log2(torch.sqrt(areas) / canonical_size + 1e-8)
    )
    levels = sorted(feature_levels.keys())
    target = torch.clamp(target, min(levels), max(levels)).to(torch.int32)

    out = None
    for lvl in levels:
        pooled = roi_align_batched(
            feature_levels[lvl], boxes, spatial_scale=1.0 / level_strides[lvl],
            output_size=output_size, sampling_ratio=sampling_ratio,
        )
        mask = (target == lvl).to(pooled.dtype)[..., None, None, None]
        out = pooled * mask if out is None else out + pooled * mask
    return out
