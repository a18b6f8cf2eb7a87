"""Association cost fusion (counterpart of ``tracker/cost.py``): IoU,
appearance cosine distance, class consistency and gating into one (S, D)
cost plus forbid pair for the assignment. Every function takes leading
camera axes, (..., S, ...) state against (..., D, ...) detections."""
from __future__ import annotations

from typing import Tuple

import torch

from waymo_2d_tracking_tpu_torch.config import TrackerConfig
from waymo_2d_tracking_tpu_torch.ops.iou import pairwise_iou
from waymo_2d_tracking_tpu_torch.tracker.kalman import gating_distance
from waymo_2d_tracking_tpu_torch.types import (
    Detections,
    TrackerState,
    boxes_cxcywh_to_xyxy,
    boxes_xyxy_to_cxcywh,
)


def cosine_distance(track_embeds: torch.Tensor, det_embeds: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity of L2-normalized (..., S, E) x (..., D, E) ->
    (..., S, D)."""
    return 1.0 - track_embeds @ det_embeds.transpose(-1, -2)


def _buffer_boxes(boxes_xyxy: torch.Tensor, b: float) -> torch.Tensor:
    """Expand each xyxy box by ``b`` times its width/height on every side (C-BIoU)."""
    dx = (boxes_xyxy[..., 2] - boxes_xyxy[..., 0]) * b
    dy = (boxes_xyxy[..., 3] - boxes_xyxy[..., 1]) * b
    return torch.stack(
        [boxes_xyxy[..., 0] - dx, boxes_xyxy[..., 1] - dy,
         boxes_xyxy[..., 2] + dx, boxes_xyxy[..., 3] + dy],
        dim=-1,
    )


def _common_gates(forbid, state, dets, det_valid, track_mask):
    forbid = forbid | (state.classes[..., :, None] != dets.classes[..., None, :])
    forbid = forbid | ~track_mask[..., :, None]
    return forbid | ~det_valid[..., None, :]


def stage1_cost(
    state: TrackerState, dets: Detections, det_valid: torch.Tensor,
    track_mask: torch.Tensor, cfg: TrackerConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Motion + appearance cost for active (tentative/confirmed) tracks.
    Gates: IoU below threshold, class mismatch, cosine distance above the
    appearance gate (when appearance is on) and the chi-square motion gate
    (when ``motion_gate`` > 0)."""
    track_boxes = boxes_cxcywh_to_xyxy(state.mean[..., :4])
    det_boxes = dets.boxes
    if cfg.iou_buffer > 0.0:
        track_boxes = _buffer_boxes(track_boxes, cfg.iou_buffer)
        det_boxes = _buffer_boxes(det_boxes, cfg.iou_buffer)
    iou = pairwise_iou(track_boxes, det_boxes)                     # (..., S, D)
    cost = 1.0 - iou
    forbid = iou < cfg.iou_threshold

    lam = cfg.appearance_weight
    if lam > 0.0 and cfg.embed_dim > 0:
        cos = cosine_distance(state.embed, dets.embeds)
        cost = (1.0 - lam) * cost + lam * cos
        forbid = forbid | (cos > cfg.appearance_gate)

    if cfg.motion_gate > 0.0:
        meas = boxes_xyxy_to_cxcywh(dets.boxes)
        d2 = gating_distance(state.mean, state.cov, meas, cfg.kalman)
        forbid = forbid | (d2 > cfg.motion_gate)

    return cost, _common_gates(forbid, state, dets, det_valid, track_mask)


def byte_cost(
    state: TrackerState, dets: Detections, det_valid: torch.Tensor,
    track_mask: torch.Tensor, cfg: TrackerConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IoU-only cost for the BYTE low-score second association, gated at
    ``byte_iou_threshold``."""
    track_boxes = boxes_cxcywh_to_xyxy(state.mean[..., :4])
    iou = pairwise_iou(track_boxes, dets.boxes)
    forbid = iou < cfg.byte_iou_threshold
    return 1.0 - iou, _common_gates(forbid, state, dets, det_valid, track_mask)


def stage2_cost(
    state: TrackerState, dets: Detections, det_valid: torch.Tensor,
    track_mask: torch.Tensor, cfg: TrackerConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Appearance-only recovery cost for LOST tracks: the best cosine
    distance over the EMA embedding and the gallery ring (``gallery_size``
    > 1), gated by ``appearance_gate`` and class."""
    cos = cosine_distance(state.embed, dets.embeds)
    k = state.gallery.shape[-2]
    if k > 1:
        cos_g = 1.0 - torch.einsum("...ske,...de->...skd", state.gallery, dets.embeds)
        k_valid = (
            torch.arange(k, device=cos.device)
            < torch.clamp(state.gallery_count, max=k)[..., None]
        )
        cos_g = torch.where(k_valid[..., None], cos_g, torch.full_like(cos_g, 2.0))
        cos = torch.minimum(cos, cos_g.amin(dim=-2))
    forbid = cos > cfg.appearance_gate
    return cos, _common_gates(forbid, state, dets, det_valid, track_mask)
