"""RoIAlign (counterpart of ``ops/roi_align.py``), aligned=True convention.

Two forms of the same function:

- the separable matrix products, the production form of the JAX package and
  of the port's ReID pooling (``roi_align``, ``roi_align_batched`` and the
  multilevel variants): bilinear interpolation is separable, so average-pooled
  RoIAlign with sampling ratio s is exactly ``out[r] = Wy[r] @ F @ Wx[r]^T``
  per channel, with Wy (P, H) / Wx (P, W) the averaged hat-function weights of
  the sample points. The products run in the features' dtype, chunked over
  RoIs to bound the (N, K, P, W, C) intermediate;
- the gather form of the Pallas ``_roi_align_kernel``: ``roi_align_kernel``
  launches the hand-written ``csrc/roi_align.cu`` for a CUDA tensor and runs
  ``roi_align_kernel_reference``, the plain PyTorch version of the kernel's
  arithmetic, for a CPU tensor. Per sample row the two source rows are blended
  in y (weights ``(1 - ly) / s`` and ``ly / s``), then per sample column the
  two blended columns in x (``(1 - lx) / s``, ``lx / s``), accumulating in
  float32 and storing in the features' dtype.
"""
from __future__ import annotations

import ctypes

import torch

from waymo_2d_tracking_tpu_torch.ops import _cuda

MAX_SAMPLES = 128   # output_size * sampling_ratio per axis, the kernel's table


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


def _bin_size(start: torch.Tensor, end: torch.Tensor, p: int) -> torch.Tensor:
    """(end - start) / p as a true division, as XLA and the kernel compute it:
    PyTorch's CUDA kernels turn a division by a Python scalar into a
    multiplication by its reciprocal, which rounds differently."""
    return (end - start) / torch.full_like(start, float(p))


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
    bin_w = _bin_size(x1, x2, p)
    bin_h = _bin_size(y1, y2, p)

    wdt = features.dtype
    wy = _interp_matrix(y1, bin_h, p, sampling_ratio, h).reshape(n, r, p, h).to(wdt)
    wx = _interp_matrix(x1, bin_w, p, sampling_ratio, w).reshape(n, r, p, w).to(wdt)

    out = []
    for k0 in range(0, r, roi_chunk):
        wy_c, wx_c = wy[:, k0:k0 + roi_chunk], wx[:, k0:k0 + roi_chunk]
        rows = torch.einsum("nkph,nhwc->nkpwc", wy_c, features)
        out.append(torch.einsum("nkqw,nkpwc->nkpqc", wx_c, rows))
    return torch.cat(out, dim=1).to(wdt)


def roi_align(features: torch.Tensor, boxes: torch.Tensor, spatial_scale: float = 1.0,
              output_size: int = 7, sampling_ratio: int = 2,
              roi_chunk: int = 16) -> torch.Tensor:
    """One image: features (H, W, C), boxes (R, 4) -> (R, P, P, C)."""
    return roi_align_batched(features[None], boxes[None], spatial_scale, output_size,
                             sampling_ratio, roi_chunk)[0]


def _target_levels(boxes, levels, canonical_level, canonical_size):
    areas = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0) * torch.clamp(
        boxes[..., 3] - boxes[..., 1], min=0.0
    )
    target = torch.floor(
        canonical_level + torch.log2(torch.sqrt(areas) / canonical_size + 1e-8)
    )
    return torch.clamp(target, min(levels), max(levels)).to(torch.int32)


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
    levels = sorted(feature_levels.keys())
    target = _target_levels(boxes, levels, canonical_level, canonical_size)
    out = None
    for lvl in levels:
        pooled = roi_align_batched(
            feature_levels[lvl], boxes, spatial_scale=1.0 / level_strides[lvl],
            output_size=output_size, sampling_ratio=sampling_ratio,
        )
        mask = (target == lvl).to(pooled.dtype)[..., None, None, None]
        out = pooled * mask if out is None else out + pooled * mask
    return out


def roi_align_multilevel(feature_levels, boxes: torch.Tensor, level_strides,
                         canonical_level: int = 4, canonical_size: float = 224.0,
                         output_size: int = 7, sampling_ratio: int = 2):
    """One image: levels (H_l, W_l, C), boxes (R, 4) -> (R, P, P, C)."""
    return roi_align_multilevel_batched(
        {lvl: f[None] for lvl, f in feature_levels.items()}, boxes[None], level_strides,
        canonical_level, canonical_size, output_size, sampling_ratio)[0]


# ------------------------------------------------------------ the gather form

def _check_kernel_args(features, boxes, output_size, sampling_ratio):
    if features.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or boxes.shape[0] != features.shape[0]:
        raise ValueError(f"bad shapes features {tuple(features.shape)} boxes {tuple(boxes.shape)}")
    if features.shape[1] < 2 or features.shape[2] < 2:
        raise ValueError("the RoIAlign kernel needs a feature map of at least 2 x 2 "
                         f"(it blends rows y0, y0 + 1), got {tuple(features.shape[1:3])}")
    if output_size * sampling_ratio > MAX_SAMPLES or output_size < 1 or sampling_ratio < 1:
        raise ValueError(f"output_size * sampling_ratio must be in 1..{MAX_SAMPLES}")


def _sample_params(start: torch.Tensor, bin_size: torch.Tensor, p: int, s: int, size: int):
    """Per RoI and sample (R, P * s): the lower source index and the two
    weights, the kernel's arithmetic (f32, each operation rounded on its own)."""
    inv_s = 1.0 / s
    offs = torch.tensor([pi + (a + 0.5) * inv_s for pi in range(p) for a in range(s)],
                        dtype=torch.float32, device=start.device)
    pos = start[:, None] + offs[None, :] * bin_size[:, None]
    in_range = (pos >= -1.0) & (pos <= float(size))
    posc = torch.clamp(pos, 0.0, float(size - 1))
    lower = torch.clamp(torch.floor(posc), max=float(size - 2))
    frac = posc - lower
    zero = torch.zeros_like(frac)
    w_lo = torch.where(in_range, (1.0 - frac) * inv_s, zero)
    w_hi = torch.where(in_range, frac * inv_s, zero)
    return lower.to(torch.long), w_lo, w_hi


def roi_align_kernel_reference(
    features: torch.Tensor,   # (N, H, W, C) float32 or bfloat16
    boxes: torch.Tensor,      # (N, R, 4) xyxy image coords
    spatial_scale: float = 1.0,
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Plain PyTorch version of the RoIAlign kernel: (N, R, P, P, C) in the
    features' dtype. A direct bilinear gather, blended in y and then in x in
    the kernel's order, accumulating in float32."""
    _check_kernel_args(features, boxes, output_size, sampling_ratio)
    n, h, w, c = features.shape
    r = boxes.shape[1]
    p, s = output_size, sampling_ratio
    b = boxes.reshape(-1, 4).to(torch.float32)
    fx1 = b[:, 0] * spatial_scale - 0.5
    fy1 = b[:, 1] * spatial_scale - 0.5
    fx2 = b[:, 2] * spatial_scale - 0.5
    fy2 = b[:, 3] * spatial_scale - 0.5
    y0, wy_lo, wy_hi = _sample_params(fy1, _bin_size(fy1, fy2, p), p, s, h)   # (N*R, P*s)
    x0, wx_lo, wx_hi = _sample_params(fx1, _bin_size(fx1, fx2, p), p, s, w)

    feats = features.reshape(n, h * w, c)
    img = torch.arange(n, device=features.device).repeat_interleave(r)  # (N*R,)

    def ys(a):     # sample a of every output row: (N*R, P, 1[, 1])
        sel = slice(a, None, s)
        return y0[:, sel, None], wy_lo[:, sel, None, None], wy_hi[:, sel, None, None]

    def xs(b_):    # sample b_ of every output column: (N*R, 1, P[, 1])
        sel = slice(b_, None, s)
        return x0[:, None, sel], wx_lo[:, None, sel, None], wx_hi[:, None, sel, None]

    def pixel(yy, xx):   # (N*R, P, P, C) float32 gather of feature pixels
        return feats[img[:, None, None], yy * w + xx].to(torch.float32)

    acc = torch.zeros((n * r, p, p, c), dtype=torch.float32, device=features.device)
    for b_ in range(s):
        xx, wxl, wxh = xs(b_)
        g_lo = torch.zeros_like(acc)
        g_hi = torch.zeros_like(acc)
        for a in range(s):
            yy, wyl, wyh = ys(a)
            g_lo = g_lo + (wyl * pixel(yy, xx) + wyh * pixel(yy + 1, xx))
            g_hi = g_hi + (wyl * pixel(yy, xx + 1) + wyh * pixel(yy + 1, xx + 1))
        acc = acc + wxl * g_lo + wxh * g_hi
    return acc.reshape(n, r, p, p, c).to(features.dtype)


def roi_align_cuda(
    features: torch.Tensor,   # (N, H, W, C) float32 or bfloat16, contiguous CUDA
    boxes: torch.Tensor,      # (N, R, 4) float32, contiguous CUDA
    spatial_scale: float = 1.0,
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Launch ``csrc/roi_align.cu``: one CTA per (image, RoI, group of output
    rows: one row at one image, the whole RoI at a chunk of images), a thread
    per (output column, vector of channels). The vector is the widest
    power of two up to 16 bytes (8 bfloat16 or 4 float32 channels) that
    divides C and that the tensors' addresses are aligned to, down to one
    channel, so any C and any contiguous tensor is taken. Returns
    (N, R, P, P, C) in the features' dtype."""
    if features.device.type != "cuda" or boxes.device != features.device:
        raise ValueError("roi_align_cuda takes CUDA tensors on one device")
    if features.dtype not in (torch.float32, torch.bfloat16) or boxes.dtype != torch.float32:
        raise TypeError("features must be float32 or bfloat16 and boxes float32")
    if not (features.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("features and boxes must be contiguous")
    _check_kernel_args(features, boxes, output_size, sampling_ratio)
    n, h, w, c = features.shape
    r = boxes.shape[1]
    p = output_size
    out = torch.empty((n, r, p, p, c), dtype=features.dtype, device=features.device)
    if out.numel() == 0:
        return out
    lib = _cuda.library("roi_align")
    with torch.cuda.device(features.device):
        err = lib.w2t_roi_align(
            ctypes.c_void_p(features.data_ptr()), ctypes.c_void_p(boxes.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_int(n), ctypes.c_int(h),
            ctypes.c_int(w), ctypes.c_int(c), ctypes.c_int(r), ctypes.c_int(p),
            ctypes.c_int(sampling_ratio), ctypes.c_float(spatial_scale),
            ctypes.c_int(features.dtype == torch.bfloat16),
            ctypes.c_void_p(_cuda.stream_handle(features.device)),
        )
    _cuda.check(err, "roi_align")
    roi_align_cuda.launches += 1
    return out


roi_align_cuda.launches = 0


def roi_align_kernel(
    features: torch.Tensor,   # (H, W, C)
    boxes: torch.Tensor,      # (R, 4) xyxy image coords
    spatial_scale: float = 1.0,
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """RoIAlign through the kernel, the contract of ``pallas_roi_align``:
    (R, P, P, C) in the features' dtype. A CUDA tensor launches the kernel; a
    CPU tensor runs the plain version."""
    feats = features[None].contiguous()
    rois = boxes[None].to(torch.float32).contiguous()
    if feats.device.type == "cuda":
        return roi_align_cuda(feats, rois, spatial_scale, output_size, sampling_ratio)[0]
    return roi_align_kernel_reference(feats, rois, spatial_scale, output_size,
                                      sampling_ratio)[0]
