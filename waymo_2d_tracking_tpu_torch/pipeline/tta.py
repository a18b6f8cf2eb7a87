"""Test-time augmentation (counterpart of ``pipeline/tta.py``): multi-scale
and horizontal flip.

Every view (scale s, flip f) of a chunk goes through one whole-chunk detector
forward (the unflipped 1.0-scale view reuses the base forward); each view's
candidates are mapped back to original-image coordinates (unflip, unscale)
and concatenated, and ONE class-aware NMS merges the union. ReID embeddings
pool from the base pyramid with the merged boxes: augmentation changes the
candidates, not the appearance features.
"""
from __future__ import annotations

from typing import Sequence

import torch

from waymo_2d_tracking_tpu_torch.data.preprocess import _resize_matrix
from waymo_2d_tracking_tpu_torch.models.detector import (
    DetectorRunner,
    gather_candidates_batched,
    select_detections_batched,
)
from waymo_2d_tracking_tpu_torch.types import Detections


def flip_image(images: torch.Tensor) -> torch.Tensor:
    """Horizontal flip, NHWC."""
    return torch.flip(images, dims=[2])


def unflip_boxes(boxes: torch.Tensor, width: float) -> torch.Tensor:
    """Map xyxy boxes detected on a flipped image back to original coords."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([width - x2, y1, width - x1, y2], dim=-1)


def scale_image(images: torch.Tensor, scale: float) -> torch.Tensor:
    """Bilinear resize of (N, H, W, C) float32 images by ``scale`` as two
    float32 matrix products (the letterbox's resize weights)."""
    n, h, w, c = images.shape
    nh, nw = int(round(h * scale)), int(round(w * scale))
    ry = _resize_matrix(h, nh, scale, images.device)
    rx = _resize_matrix(w, nw, scale, images.device)
    x = torch.einsum("eh,nhwc->newc", ry, images)
    return torch.einsum("fw,newc->nefc", rx, x)


def tta_candidates_batched(
    runner: DetectorRunner,
    images: torch.Tensor,          # (N, H, W, 3)
    scales: Sequence[float] = (1.0,),
    flip: bool = True,
    base_head_out=None,
):
    """Union of per-view candidates in original coordinates:
    (boxes (N, V*C, 4), scores (N, V*C), classes (N, V*C)).

    One whole-batch forward per view; ``base_head_out`` is an already computed
    unflipped 1.0-scale forward to reuse."""
    cand = []
    for s in scales:
        img_s = scale_image(images, s) if s != 1.0 else images
        for flipped in (False, True) if flip else (False,):
            if s == 1.0 and not flipped and base_head_out is not None:
                head_out = base_head_out
            else:
                head_out, _ = runner.forward(flip_image(img_s) if flipped else img_s)
            boxes, scores, classes = gather_candidates_batched(head_out, runner.cfg)
            if flipped:
                boxes = unflip_boxes(boxes, img_s.shape[2])
            cand.append((boxes / s, scores, classes))
    return tuple(torch.cat([c[i] for c in cand], dim=1) for i in range(3))


@torch.no_grad()
def detect_tta_batch(runner: DetectorRunner, images: torch.Tensor,
                     scales: Sequence[float] = (1.0,), flip: bool = True) -> Detections:
    """TTA detection for a batch -> tracker-ready Detections (N, D, ...)."""
    base_head_out, p_feats = runner.forward(images)
    candidates = tta_candidates_batched(runner, images, scales=scales, flip=flip,
                                        base_head_out=base_head_out)
    return runner.select(candidates, p_feats)


@torch.no_grad()
def detect_tta_single(runner: DetectorRunner, image: torch.Tensor,
                      scales: Sequence[float] = (1.0,), flip: bool = True,
                      base_head_out=None):
    """TTA detection for one (H, W, 3) image -> (boxes (D,4), scores, classes,
    valid). ``base_head_out``: optional per-image (no batch axis) head outputs
    of the unflipped 1.0-scale view."""
    if base_head_out is not None:
        base_head_out = {lvl: tuple(t[None] for t in ts) for lvl, ts in base_head_out.items()}
    candidates = tta_candidates_batched(runner, image[None], scales=scales, flip=flip,
                                        base_head_out=base_head_out)
    with runner.precision():
        out = select_detections_batched(*candidates, runner.cfg)
    return tuple(t[0] for t in out)
