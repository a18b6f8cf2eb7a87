"""Tracker top level: ``track_step`` and ``track_segment`` (counterpart of
``tracker/tracker.py``).

``track_step`` advances the fixed-capacity track table by one frame: Kalman
predict -> fused cost -> assignment -> masked lifecycle. On a CUDA tensor
nothing in a step waits on the host (the auction kernel skips infeasible
problems itself), so a chunk of steps queues on the device back to back.
``track_segment`` is the Python loop over T that replaces ``lax.scan``: the
CPU path, and the reference that the card's captured step
(``tracker/graph.py``) is held to.

Every function takes optional leading camera axes, the counterpart of
``jax.vmap(track_step)``: a state of (C, S, ...) fields against detections
(C, D, ...) steps all C cameras with the same ops, and each association
stage is one auction launch carrying C problems. A single camera is the
same code with no leading axis. ``init_multicam_state`` stacks C fresh
states.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from waymo_2d_tracking_tpu_torch import resolve_device
from waymo_2d_tracking_tpu_torch.config import TrackerConfig
from waymo_2d_tracking_tpu_torch.ops.assign import auction_assign, greedy_assign
from waymo_2d_tracking_tpu_torch.ops.iou import pairwise_iou
from waymo_2d_tracking_tpu_torch.tracker import cost as cost_mod
from waymo_2d_tracking_tpu_torch.tracker import kalman, lifecycle
from waymo_2d_tracking_tpu_torch.types import (
    SLOT_CONFIRMED,
    SLOT_EMPTY,
    SLOT_LOST,
    SLOT_TENTATIVE,
    Detections,
    TrackerState,
    TrackOutputs,
    boxes_cxcywh_to_xyxy,
)


def init_state(cfg: TrackerConfig, device="cuda", dtype=torch.float32) -> TrackerState:
    """Fresh empty track table on ``device``."""
    dev = resolve_device(device)
    s, e = cfg.max_tracks, max(cfg.embed_dim, 1)
    k = max(cfg.gallery_size, 1)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    return TrackerState(
        mean=zeros(s, kalman.STATE_DIM),
        cov=torch.eye(kalman.STATE_DIM, dtype=dtype, device=dev).repeat(s, 1, 1),
        track_id=torch.full((s,), -1, dtype=torch.int32, device=dev),
        status=torch.full((s,), SLOT_EMPTY, dtype=torch.int8, device=dev),
        hits=zeros(s, dt=torch.int32),
        time_since_update=zeros(s, dt=torch.int32),
        age=zeros(s, dt=torch.int32),
        classes=zeros(s, dt=torch.int32),
        score=zeros(s),
        embed=zeros(s, e),
        gallery=zeros(s, k, e),
        gallery_count=zeros(s, dt=torch.int32),
        next_id=zeros(dt=torch.int32),
        frame_idx=zeros(dt=torch.int32),
    )


def init_multicam_state(cfg, num_cams: int, device="cuda",
                        dtype=torch.float32) -> TrackerState:
    """``num_cams`` fresh track tables stacked on a leading camera axis;
    ``cfg`` is the whole ``Config`` (its ``tracker`` part is used), as in
    the JAX package."""
    single = init_state(cfg.tracker, device=device, dtype=dtype)
    return TrackerState.stack([single] * num_cams)


def _assign(cost, forbid, row_mask, col_mask, cfg: TrackerConfig):
    if cfg.assignment == "greedy":
        return greedy_assign(cost, row_mask=row_mask, col_mask=col_mask,
                             forbid=forbid)
    return auction_assign(
        cost, row_mask=row_mask, col_mask=col_mask, forbid=forbid,
        eps_scale=cfg.auction_eps_scale, eps_min=cfg.auction_eps_min,
        max_iters=cfg.auction_max_iters,
    )


def track_step(
    state: TrackerState, dets: Detections, cfg: TrackerConfig
) -> Tuple[TrackerState, TrackOutputs]:
    """Advance the tracker by one frame: state (..., S, ...) and detections
    (..., D, ...) with the same leading camera axes, if any."""
    det_valid = dets.valid & (dets.scores >= cfg.score_threshold)

    # 1. Kalman predict for active tracks; LOST tracks keep a frozen state
    active = (state.status == SLOT_TENTATIVE) | (state.status == SLOT_CONFIRMED)
    mean_p, cov_p = kalman.predict(state.mean, state.cov, cfg.kalman)
    state = state.replace(
        mean=torch.where(active[..., None], mean_p, state.mean),
        cov=torch.where(active[..., None, None], cov_p, state.cov),
    )

    # 2. stage-1 association: active tracks x detections (IoU + appearance)
    c1, f1 = cost_mod.stage1_cost(state, dets, det_valid, active, cfg)
    row_to_col, col_to_row = _assign(c1, f1, active, det_valid, cfg)

    embed_update = None
    if cfg.byte_low_threshold > 0.0:
        # 2b. BYTE: low-score dets vs CONFIRMED tracks stage 1 left unmatched
        det_low = dets.valid & (dets.scores >= cfg.byte_low_threshold) & (
            dets.scores < cfg.score_threshold)
        trk_free = (state.status == SLOT_CONFIRMED) & (row_to_col < 0)
        cb, fb = cost_mod.byte_cost(state, dets, det_low, trk_free, cfg)
        rtcb, ctrb = _assign(cb, fb, trk_free, det_low, cfg)
        low_matched = rtcb >= 0
        row_to_col = torch.where(low_matched, rtcb, row_to_col)
        col_to_row = torch.maximum(col_to_row, ctrb)
        embed_update = ~low_matched

    recovered = torch.zeros_like(active)
    if cfg.reid_recovery and cfg.embed_dim > 0:
        # 3. stage 2: LOST tracks x still-unmatched detections, appearance only
        lost = state.status == SLOT_LOST
        det_free = det_valid & (col_to_row < 0)
        c2, f2 = cost_mod.stage2_cost(state, dets, det_free, lost, cfg)
        rtc2, ctr2 = _assign(c2, f2, lost, det_free, cfg)
        recovered = rtc2 >= 0
        row_to_col = torch.where(recovered, rtc2, row_to_col)
        col_to_row = torch.maximum(col_to_row, ctr2)

    # 4. lifecycle: update matched, age/kill missed, birth leftovers
    state = lifecycle.apply_matches(
        state, dets, row_to_col, recovered, cfg, embed_update=embed_update
    )
    state = lifecycle.apply_misses(state, row_to_col >= 0, cfg)
    birth_ok = col_to_row < 0
    if cfg.birth_iou_threshold < 1.0:
        # duplicate-birth suppression against same-class live tracks, after
        # this frame's matches/misses
        live = (state.status == SLOT_TENTATIVE) | (state.status == SLOT_CONFIRMED)
        same_class = dets.classes[..., :, None] == state.classes[..., None, :]
        trk_boxes = boxes_cxcywh_to_xyxy(state.mean[..., :4])
        overlap = pairwise_iou(dets.boxes, trk_boxes)              # (..., D, S)
        max_iou = torch.where(live[..., None, :] & same_class, overlap,
                              torch.zeros_like(overlap)).amax(dim=-1)
        birth_ok = birth_ok & (max_iou < cfg.birth_iou_threshold)
    state = lifecycle.apply_births(state, dets, birth_ok, cfg)
    state = state.replace(frame_idx=state.frame_idx + 1)

    # 5. emit confirmed tracks matched this frame; during the first n_init
    # frames tentative tracks too (SORT's warm-up rule)
    fresh = state.time_since_update == 0
    emit = fresh & (state.status == SLOT_CONFIRMED)
    warmup = (state.status == SLOT_TENTATIVE) & (state.frame_idx[..., None] <= cfg.n_init)
    emit = emit | (warmup & fresh)

    outputs = TrackOutputs(
        track_id=torch.where(emit, state.track_id, -1),
        boxes=boxes_cxcywh_to_xyxy(state.mean[..., :4]),
        scores=state.score,
        classes=state.classes,
        valid=emit,
    )
    return state, outputs


def track_segment(
    state: TrackerState, det_seq: Detections, cfg: TrackerConfig
) -> Tuple[TrackerState, TrackOutputs]:
    """Run ``track_step`` over time-major Detections (T, ...) or (T, C, ...).
    Returns the final state and time-stacked TrackOutputs (T, [C,] S, ...)."""
    outs = []
    for t in range(det_seq.boxes.shape[0]):
        state, out = track_step(state, det_seq[t], cfg)
        outs.append(out)
    return state, TrackOutputs.stack(outs)


class Tracker:
    """Config + device holder with ``init``/``step``/``run``. On the card
    ``run`` replays a captured step (``tracker/graph.py``), one per shape,
    kept on this object."""

    def __init__(self, cfg: Optional[TrackerConfig] = None, device="cuda"):
        self.cfg = cfg or TrackerConfig()
        self.device = resolve_device(device)
        self._graphs = {}

    def init(self) -> TrackerState:
        return init_state(self.cfg, device=self.device)

    def step(self, state: TrackerState, dets: Detections):
        return track_step(state, dets, self.cfg)

    def run(self, det_seq: Detections, state: Optional[TrackerState] = None):
        from waymo_2d_tracking_tpu_torch.tracker.graph import track_chunk

        if state is None:
            state = self.init()
        return track_chunk(state, det_seq.to(self.device), self.cfg, self._graphs)
