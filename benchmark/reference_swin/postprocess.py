"""The detector's post-processing in plain PyTorch: per-level top-k
candidates (score = sqrt(sigmoid(cls) * sigmoid(ctr)), boxes decoded from
ltrb distances), the global candidate cap, class-aware greedy NMS, the top-D
selection and RoIAlign (aligned, sampling ratio 2) of P3 for the ReID tower.

``dtype`` is the precision of the candidate arithmetic: float32 as the
configuration states, bfloat16 for the control."""
from __future__ import annotations

import torch

CLASS_OFFSET = 1e5


def topk(x: torch.Tensor, k: int):
    """Descending, ties lowest index first."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def decode(ltrb: torch.Tensor, stride: int) -> torch.Tensor:
    n, h, w, _ = ltrb.shape
    ys = (torch.arange(h, dtype=ltrb.dtype, device=ltrb.device) + 0.5) * stride
    xs = (torch.arange(w, dtype=ltrb.dtype, device=ltrb.device) + 0.5) * stride
    cy, cx = ys[None, :, None].expand(n, h, w), xs[None, None, :].expand(n, h, w)
    d = ltrb * stride
    return torch.stack([cx - d[..., 0], cy - d[..., 1], cx + d[..., 2], cy + d[..., 3]], -1)


def candidates(head_out, det: dict, dtype=torch.float32):
    boxes, scores, classes = [], [], []
    for lvl in det["fpn_levels"]:
        cls, ltrb, ctr = head_out[lvl]
        n, h, w, k = cls.shape
        s = torch.sqrt(torch.clamp(torch.sigmoid(cls.to(dtype)) * torch.sigmoid(ctr.to(dtype)),
                                   min=0.0)).reshape(n, -1)
        v, idx = topk(s, min(det["pre_nms_topk"], s.shape[1]))
        b = decode(ltrb.to(dtype), 2 ** lvl).reshape(n, -1, 4)
        boxes.append(torch.gather(b, 1, (idx // k)[..., None].expand(-1, -1, 4)))
        scores.append(v)
        classes.append((idx % k).to(torch.int32))
    return torch.cat(boxes, 1), torch.cat(scores, 1), torch.cat(classes, 1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return torch.clamp(x[..., 2] - x[..., 0], min=0.0) * torch.clamp(x[..., 3] - x[..., 1],
                                                                         min=0.0)
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-7)


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, thr: float) -> torch.Tensor:
    """Greedy keep-mask over score-sorted boxes (B, N, 4): box i, kept,
    removes every later box j with IoU(i, j) > thr. The IoU rows are
    computed a band at a time."""
    b, n = valid.shape
    t = torch.tensor(thr, dtype=boxes.dtype, device=boxes.device)
    keep = torch.zeros_like(valid)
    removed = torch.zeros_like(valid)
    cols = torch.arange(n, device=boxes.device)
    band = max(1, (1 << 22) // max(b * n, 1))
    for i0 in range(0, n, band):
        rows = torch.arange(i0, min(i0 + band, n), device=boxes.device)
        over = (iou(boxes[:, i0:i0 + band], boxes) > t) & (cols[None, :] > rows[:, None])
        for r in range(rows.numel()):
            k = valid[:, i0 + r] & ~removed[:, i0 + r]
            keep[:, i0 + r] = k
            removed |= over[:, r, :] & k[:, None]
    return keep


def select(boxes, scores, classes, det: dict):
    """Global cap, class-aware NMS, top-D -> (boxes, scores, classes, valid)."""
    if 0 < det["nms_topk"] < boxes.shape[1]:
        scores, sel = topk(scores, det["nms_topk"])
        boxes = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4))
        classes = torch.gather(classes, 1, sel)
    shifted = boxes + (classes.to(boxes.dtype) * CLASS_OFFSET)[..., None]
    n = boxes.shape[1]
    order_s, order = topk(scores, n)
    sboxes = torch.gather(shifted, 1, order[..., None].expand(-1, -1, 4))
    keep = nms_keep(sboxes, order_s > det["score_threshold"], det["nms_iou_threshold"])
    top, sel = topk(torch.where(keep, order_s, torch.full_like(order_s, float("-inf"))),
                    det["max_detections"])
    valid = torch.isfinite(top)
    idx = torch.clamp(torch.where(valid, torch.gather(order, 1, sel), -1), 0, n - 1)
    out_boxes = torch.where(valid[..., None],
                            torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)), 0.0)
    out_scores = torch.where(valid, top, 0.0)
    out_classes = torch.where(valid, torch.gather(classes, 1, idx), 0)
    return out_boxes, out_scores, out_classes, valid


def _weights(start, bin_size, p: int, s: int, size: int):
    offs = (torch.arange(s, dtype=torch.float32, device=start.device) + 0.5) / s
    bins = torch.arange(p, dtype=torch.float32, device=start.device)
    pos = start[:, None, None] + (bins[None, :, None] + offs[None, None, :]) * bin_size[:, None, None]
    inside = (pos >= -1.0) & (pos <= size)
    grid = torch.arange(size, dtype=torch.float32, device=start.device)
    hat = torch.clamp(1.0 - torch.abs(torch.clamp(pos, 0.0, size - 1.0)[..., None] - grid), min=0.0)
    return torch.where(inside[..., None], hat, 0.0).sum(dim=2) / s


def roi_align(features: torch.Tensor, boxes: torch.Tensor, scale: float, p: int = 7,
              s: int = 2) -> torch.Tensor:
    """features (N, H, W, C), boxes (N, R, 4) -> (N, R, p, p, C) float32."""
    n, h, w, c = features.shape
    r = boxes.shape[1]
    f = boxes.reshape(-1, 4).float() * scale - 0.5
    # the bin size divided by a tensor: on the card a division by a Python
    # number is a multiplication by its reciprocal, an ulp off the quotient,
    # and a sample that lands on -1 then falls on the other side of the
    # boundary (a whole row's weight)
    bins = torch.full_like(f[:, 0], float(p))
    wy = _weights(f[:, 1], (f[:, 3] - f[:, 1]) / bins, p, s, h).reshape(n, r, p, h)
    wx = _weights(f[:, 0], (f[:, 2] - f[:, 0]) / bins, p, s, w).reshape(n, r, p, w)
    rows = torch.einsum("nkph,nhwc->nkpwc", wy, features.float())
    return torch.einsum("nkqw,nkpwc->nkpqc", wx, rows)
