"""Track lifecycle: masked birth / death / confirmation (counterpart of
``tracker/lifecycle.py``). Every event is a masked vectorized update of the
fixed-capacity slot table:

- birth: unmatched high-score detections claim EMPTY slots in detection
  order; surplus births are dropped;
- confirmation: TENTATIVE -> CONFIRMED after ``n_init`` hits;
- miss: TENTATIVE dies on its first miss; CONFIRMED survives ``max_age``
  misses, then becomes LOST (re-ID on) or EMPTY;
- LOST tracks die after ``max_lost_age`` further frames.

Every function takes leading camera axes: a state (..., S, ...) against
detections (..., D, ...), each camera with its own id counter.
"""
from __future__ import annotations

import numpy as np
import torch

from waymo_2d_tracking_tpu_torch.config import TrackerConfig
from waymo_2d_tracking_tpu_torch.tracker import kalman
from waymo_2d_tracking_tpu_torch.types import (
    SLOT_CONFIRMED,
    SLOT_EMPTY,
    SLOT_LOST,
    SLOT_TENTATIVE,
    Detections,
    TrackerState,
    boxes_xyxy_to_cxcywh,
)
from waymo_2d_tracking_tpu_torch.utils import l2norm


def _int8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int8)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-camera rows of a detection field: x (..., D, *F), idx (..., K)
    long -> (..., K, *F). One camera (idx 1-D) indexes directly: one op
    where the gather takes three, and a tracker step is bound by the ops
    the host issues."""
    if idx.dim() == 1:
        return x[idx]
    extra = x.dim() - idx.dim()
    index = idx.reshape(idx.shape + (1,) * extra).expand(idx.shape + x.shape[idx.dim():])
    return torch.gather(x, idx.dim() - 1, index)


def ema_normalize(embed: torch.Tensor, det_e: torch.Tensor, momentum: float) -> torch.Tensor:
    """``m * embed + (1 - m) * det_e``, L2-normalized over the last axis, with
    the bits of the JAX package's jitted ``apply_matches`` on the CPU.

    XLA fuses the update into the norm's reduction and into the division, and
    LLVM contracts each multiply-add: the update is ``fma(m, embed, round(c *
    det_e))`` with ``m = float32(momentum)`` and ``c = float32(1 - momentum)``,
    and the norm sums its squares in XLA's order (``utils/l2norm.py``). At
    E <= 32 the division's copy of the update contracts the other product,
    ``fma(c, det_e, round(m * embed))``.
    """
    m = float(np.float32(momentum))
    c = float(np.float32(1.0 - momentum))
    ema = l2norm.fma(embed, m, det_e * c)
    num = ema if embed.shape[-1] > l2norm.WINDOW else l2norm.fma(det_e, c, embed * m)
    return l2norm.divide_by_norm(num, l2norm.l2_norm(ema))


def apply_matches(
    state: TrackerState,
    dets: Detections,
    row_to_col: torch.Tensor,
    recovered: torch.Tensor,
    cfg: TrackerConfig,
    embed_update: torch.Tensor | None = None,
) -> TrackerState:
    """Kalman-update matched slots and advance their lifecycle counters.

    row_to_col (..., S): det index per slot, -1 if unmatched. recovered
    (..., S): LOST slots re-identified this frame (stage 2); their motion
    state re-initializes at the detection. embed_update (..., S) or None:
    slots allowed to update their appearance (None = all matched slots).
    """
    matched = row_to_col >= 0
    emb_ok = matched if embed_update is None else (matched & embed_update)
    det_idx = torch.clamp(row_to_col, 0, dets.max_detections - 1).long()
    meas = boxes_xyxy_to_cxcywh(take(dets.boxes, det_idx))         # (..., S, 4)
    det_score = take(dets.scores, det_idx)

    up_mean, up_cov = kalman.update(
        state.mean, state.cov, meas, cfg.kalman, score=det_score
    )
    re_mean, re_cov = kalman.init_track(meas, cfg.kalman)
    if cfg.recovery_momentum:
        # observation-centric momentum: velocity across the occlusion gap
        gap = (state.time_since_update + 1).to(meas.dtype)
        vel = (meas - state.mean[..., :4]) / gap[..., None]
        re_mean = torch.cat([meas, vel], dim=-1)
    new_mean = torch.where(recovered[..., None], re_mean, up_mean)
    new_cov = torch.where(recovered[..., None, None], re_cov, up_cov)

    mean = torch.where(matched[..., None], new_mean, state.mean)
    cov = torch.where(matched[..., None, None], new_cov, state.cov)

    hits = torch.where(matched, state.hits + 1, state.hits)
    tsu = torch.where(matched, torch.zeros_like(state.time_since_update),
                      state.time_since_update)
    score = torch.where(matched, det_score, state.score)

    if cfg.embed_dim > 0:
        det_e = take(dets.embeds, det_idx)
        ema = ema_normalize(state.embed, det_e, cfg.embed_ema)
        embed = torch.where(emb_ok[..., None], ema, state.embed)
        # gallery ring write: matched slots record the raw detection embed
        k = state.gallery.shape[-2]
        slot_pos = torch.remainder(state.gallery_count, k)
        ring = torch.arange(k, dtype=slot_pos.dtype, device=slot_pos.device)
        onehot = (slot_pos[..., None] == ring).to(state.gallery.dtype)  # (..., S, K)
        write = onehot * emb_ok[..., None]
        gallery = (
            state.gallery * (1.0 - write[..., None])
            + write[..., None] * det_e[..., None, :]
        )
        gallery_count = torch.where(emb_ok, state.gallery_count + 1,
                                    state.gallery_count)
    else:
        embed, gallery, gallery_count = state.embed, state.gallery, state.gallery_count

    # matched TENTATIVE confirms at n_init hits; matched LOST re-confirms
    status = state.status
    confirm = matched & (
        ((status == SLOT_TENTATIVE) & (hits >= cfg.n_init)) | (status == SLOT_LOST)
    )
    status = _int8(torch.where(confirm, SLOT_CONFIRMED, status))

    return state.replace(
        mean=mean, cov=cov, hits=hits, time_since_update=tsu,
        score=score, embed=embed, status=status,
        gallery=gallery, gallery_count=gallery_count,
    )


def apply_misses(state: TrackerState, was_matched: torch.Tensor,
                 cfg: TrackerConfig) -> TrackerState:
    """Age unmatched slots and apply death transitions."""
    live = state.status != SLOT_EMPTY
    missed = live & ~was_matched
    tsu = torch.where(missed, state.time_since_update + 1, state.time_since_update)
    age = torch.where(live, state.age + 1, state.age)

    status = state.status
    status = _int8(torch.where(missed & (status == SLOT_TENTATIVE), SLOT_EMPTY, status))
    expired = (status == SLOT_CONFIRMED) & (tsu > cfg.max_age)
    status = _int8(torch.where(
        expired, SLOT_LOST if cfg.reid_recovery else SLOT_EMPTY, status))
    status = _int8(torch.where(
        (status == SLOT_LOST) & (tsu > cfg.max_age + cfg.max_lost_age),
        SLOT_EMPTY, status,
    ))

    track_id = torch.where(status == SLOT_EMPTY, -1, state.track_id)
    return state.replace(status=status, time_since_update=tsu, age=age,
                         track_id=track_id)


def apply_births(
    state: TrackerState,
    dets: Detections,
    det_unmatched: torch.Tensor,
    cfg: TrackerConfig,
) -> TrackerState:
    """Birth unmatched high-score detections into EMPTY slots.

    The k-th birthing detection (detection order) claims the k-th empty slot
    (slot order); surplus births are dropped. New ids are
    ``next_id + empty_rank`` (the slot's rank among empty slots), as in the
    JAX package.
    """
    d = dets.max_detections
    dev = dets.boxes.device

    is_birth = dets.valid & det_unmatched & (dets.scores >= cfg.birth_score_threshold)
    empty = state.status == SLOT_EMPTY

    birth_rank = torch.cumsum(is_birth.to(torch.int32), -1) - 1
    empty_rank = (torch.cumsum(empty.to(torch.int32), -1) - 1).to(torch.int32)
    n_births = is_birth.to(torch.int32).sum(-1)
    n_empty = empty.to(torch.int32).sum(-1)
    n_placed = torch.minimum(n_births, n_empty).to(torch.int32)

    # det index of the birth with rank r (scatter by rank; rank d drops)
    rank_idx = torch.where(is_birth, birth_rank, d).long()
    det_by_rank = torch.full(rank_idx.shape[:-1] + (d + 1,), -1, dtype=torch.int32,
                             device=dev).scatter_(
        -1, rank_idx, torch.arange(d, dtype=torch.int32, device=dev).expand(rank_idx.shape))
    det_by_rank = det_by_rank[..., :d]

    slot_det = torch.gather(det_by_rank, -1, torch.clamp(empty_rank, 0, d - 1).long())
    place = empty & (empty_rank < n_placed[..., None]) & (slot_det >= 0)
    det_idx = torch.clamp(slot_det, 0, d - 1).long()

    meas = boxes_xyxy_to_cxcywh(take(dets.boxes, det_idx))
    new_mean, new_cov = kalman.init_track(meas, cfg.kalman)

    mean = torch.where(place[..., None], new_mean, state.mean)
    cov = torch.where(place[..., None, None], new_cov, state.cov)
    track_id = torch.where(place, state.next_id[..., None] + empty_rank, state.track_id)
    status = _int8(torch.where(place, SLOT_TENTATIVE, state.status))
    hits = torch.where(place, 1, state.hits)
    tsu = torch.where(place, 0, state.time_since_update)
    age = torch.where(place, 0, state.age)
    classes = torch.where(place, take(dets.classes, det_idx), state.classes)
    score = torch.where(place, take(dets.scores, det_idx), state.score)
    if cfg.embed_dim > 0:
        det_e = take(dets.embeds, det_idx)
        embed = torch.where(place[..., None], det_e, state.embed)
        fresh = torch.zeros_like(state.gallery)
        fresh[..., 0, :] = det_e
        gallery = torch.where(place[..., None, None], fresh, state.gallery)
        gallery_count = torch.where(place, 1, state.gallery_count)
    else:
        embed, gallery, gallery_count = state.embed, state.gallery, state.gallery_count

    return state.replace(
        mean=mean, cov=cov, track_id=track_id, status=status, hits=hits,
        time_since_update=tsu, age=age, classes=classes, score=score,
        embed=embed, gallery=gallery, gallery_count=gallery_count,
        next_id=state.next_id + n_placed,
    )
