"""The SORT-family tracker in plain PyTorch: a fixed table of S slots, the
constant-velocity Kalman filter, the fused IoU + appearance cost, the
auction (``assign``), re-ID recovery of lost tracks against the appearance
gallery, and the lifecycle (births into empty slots in detection order,
confirmation after ``n_init`` hits, death or loss after ``max_age`` misses).
Every function takes optional leading camera axes.

The arithmetic is written out op by op in a fixed order (the Kalman solve as
a reciprocal multiply of the diagonal innovation covariance, the Mahalanobis
squares summed in order, the embedding update as a float64 fused
multiply-add, the norms summed in windows of 32 then in order), the order the
program documents, so the comparison of track records can be exact.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference_swin.assign import auction
from benchmark.reference_swin.postprocess import iou as pairwise_iou

EMPTY, TENTATIVE, CONFIRMED, LOST = 0, 1, 2, 3
STATE = ("mean", "cov", "track_id", "status", "hits", "time_since_update", "age", "classes",
         "score", "embed", "gallery", "gallery_count", "next_id", "frame_idx")


def init_state(t: dict, cams, device) -> dict:
    """Fresh tables; ``cams`` None for one camera, else a leading axis."""
    s, e, k = t["max_tracks"], max(t["embed_dim"], 1), max(t["gallery_size"], 1)
    lead = () if cams is None else (cams,)
    z = lambda *sh, dt=torch.float32: torch.zeros(lead + sh, dtype=dt, device=device)  # noqa
    return {
        "mean": z(s, 8), "cov": torch.eye(8, device=device).repeat(lead + (s, 1, 1)),
        "track_id": torch.full(lead + (s,), -1, dtype=torch.int32, device=device),
        "status": torch.zeros(lead + (s,), dtype=torch.int8, device=device),
        "hits": z(s, dt=torch.int32), "time_since_update": z(s, dt=torch.int32),
        "age": z(s, dt=torch.int32), "classes": z(s, dt=torch.int32), "score": z(s),
        "embed": z(s, e), "gallery": z(s, k, e), "gallery_count": z(s, dt=torch.int32),
        "next_id": z(dt=torch.int32), "frame_idx": z(dt=torch.int32),
    }


def xyxy_to_cxcywh(b):
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


def cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], -1)


# ------------------------------------------------------------------ Kalman

def _eye(like):
    return torch.eye(8, dtype=like.dtype, device=like.device)


def kf_init(meas, k):
    mean = torch.cat([meas, torch.zeros_like(meas)], -1)
    h = torch.clamp(meas[..., 3], min=1.0)
    p = k["std_weight_position"] * h
    v = k["std_weight_velocity"] * h * k["init_velocity_std"]
    diag = torch.stack([p, p, p, p, v, v, v, v], -1)
    return mean, _eye(meas) * (diag[..., None, :] ** 2)


def kf_predict(mean, cov, k):
    new_mean = torch.cat([mean[..., :4] + mean[..., 4:], mean[..., 4:]], -1)
    a, b = cov[..., :4, :4], cov[..., :4, 4:]
    c, d = cov[..., 4:, :4], cov[..., 4:, 4:]
    new_cov = torch.cat([torch.cat([a + b + c + d, b + d], -1), torch.cat([c + d, d], -1)], -2)
    h = torch.clamp(mean[..., 3], min=1.0)
    pos, vel = (k["std_weight_position"] * h) ** 2, (k["std_weight_velocity"] * h) ** 2
    q = torch.stack([pos, pos, pos, pos, vel, vel, vel, vel], -1)
    return new_mean, new_cov + _eye(cov) * q[..., None, :]


def kf_update(mean, cov, meas, k, score):
    m = (k["std_weight_measurement"] * torch.clamp(meas[..., 3], min=1.0)) ** 2
    r = torch.stack([m, m, m, m], -1)
    if k["nsa"]:
        r = r * torch.clamp(1.0 - score, min=1e-3)[..., None]
    s_diag = torch.diagonal(cov[..., :4, :4], dim1=-2, dim2=-1) + r
    gain = cov[..., :, :4] * torch.reciprocal(s_diag)[..., None, :]
    new_mean = mean + torch.einsum("...ij,...j->...i", gain, meas - mean[..., :4])
    return new_mean, cov - torch.einsum("...ij,...jk->...ik", gain, cov[..., :4, :])


def gating_distance(mean, cov, meas, k):
    m = (k["std_weight_measurement"] * torch.clamp(mean[..., 3], min=1.0)) ** 2
    s_diag = torch.diagonal(cov[..., :4, :4], dim1=-2, dim2=-1) + torch.stack([m, m, m, m], -1)
    diff = meas[..., None, :, :] - mean[..., :, None, :4]
    z = diff * torch.reciprocal(torch.sqrt((s_diag + 1e-6).double()).float())[..., :, None, :]
    q = z * z
    return ((q[..., 0] + q[..., 1]) + q[..., 2]) + q[..., 3]


# --------------------------------------------------------------- embeddings

def fma(x, y: float, z):
    return torch.add(z, x.double(), alpha=y).float()


def l2_norm(x):
    e = x.shape[-1]
    if e % 32 == 0 and e > 32:
        sq = (x * x).unflatten(-1, (e // 32, 32))
        win = sq[..., 0]
        for i in range(1, 32):
            win = win + sq[..., i]
        ss = win[..., 0]
        for j in range(1, e // 32):
            ss = ss + win[..., j]
    elif e <= 32:
        sq = x.double().square()
        ss = sq[..., 0].float()
        for i in range(1, e):
            ss = (sq[..., i] + ss).float()
    else:
        return torch.linalg.vector_norm(x, dim=-1)
    return torch.sqrt(ss.double()).float()


def ema_normalize(embed, det_e, momentum):
    m, c = float(np.float32(momentum)), float(np.float32(1.0 - momentum))
    ema = fma(embed, m, det_e * c)
    num = ema if embed.shape[-1] > 32 else fma(det_e, c, embed * m)
    return num / torch.clamp(l2_norm(ema), min=1e-8)[..., None]


# ---------------------------------------------------------------- the step

def take(x, idx):
    if idx.dim() == 1:
        return x[idx]
    extra = x.dim() - idx.dim()
    index = idx.reshape(idx.shape + (1,) * extra).expand(idx.shape + x.shape[idx.dim():])
    return torch.gather(x, idx.dim() - 1, index)


def _gates(forbid, st, dets, det_valid, track_mask):
    forbid = forbid | (st["classes"][..., :, None] != dets["classes"][..., None, :])
    return forbid | ~track_mask[..., :, None] | ~det_valid[..., None, :]


def _cos(a, b):
    return 1.0 - a @ b.transpose(-1, -2)


def _assign(cost, forbid, rows, cols, t, solve):
    if t["assignment"] != "auction":
        raise ValueError("the reference implements the auction assignment")
    return auction(cost, rows, cols, forbid, t["auction_eps_scale"], t["auction_eps_min"],
                   t["auction_max_iters"], solve)


def step(st: dict, dets: dict, t: dict, solve=None):
    """One frame: (state, detections) -> (state, outputs). ``solve``: the
    cameras whose assignments are solved (None: all); the others match
    nothing, so only their tables are not to be compared."""
    k = t["kalman"]
    if t.get("byte_low_threshold", 0.0) > 0 or t.get("iou_buffer", 0.0) > 0 \
            or t.get("recovery_momentum") or t.get("birth_iou_threshold", 1.0) < 1.0:
        raise ValueError("the reference leaves out BYTE, buffered IoU, recovery momentum "
                         "and duplicate-birth suppression")
    st = dict(st)
    det_valid = dets["valid"] & (dets["scores"] >= t["score_threshold"])
    active = (st["status"] == TENTATIVE) | (st["status"] == CONFIRMED)
    mp, cp = kf_predict(st["mean"], st["cov"], k)
    st["mean"] = torch.where(active[..., None], mp, st["mean"])
    st["cov"] = torch.where(active[..., None, None], cp, st["cov"])

    iou = pairwise_iou(cxcywh_to_xyxy(st["mean"][..., :4]), dets["boxes"])
    cost, forbid = 1.0 - iou, iou < t["iou_threshold"]
    lam = t["appearance_weight"]
    if lam > 0.0 and t["embed_dim"] > 0:
        cos = _cos(st["embed"], dets["embeds"])
        cost = (1.0 - lam) * cost + lam * cos
        forbid = forbid | (cos > t["appearance_gate"])
    if t["motion_gate"] > 0.0:
        d2 = gating_distance(st["mean"], st["cov"], xyxy_to_cxcywh(dets["boxes"]), k)
        forbid = forbid | (d2 > t["motion_gate"])
    rtc, ctr = _assign(cost, _gates(forbid, st, dets, det_valid, active), active, det_valid, t,
                       solve)

    recovered = torch.zeros_like(active)
    if t["reid_recovery"] and t["embed_dim"] > 0:
        lost = st["status"] == LOST
        free = det_valid & (ctr < 0)
        cos = _cos(st["embed"], dets["embeds"])
        kk = st["gallery"].shape[-2]
        if kk > 1:
            cg = 1.0 - torch.einsum("...ske,...de->...skd", st["gallery"], dets["embeds"])
            ok = torch.arange(kk, device=cos.device) < torch.clamp(st["gallery_count"],
                                                                    max=kk)[..., None]
            cos = torch.minimum(cos, torch.where(ok[..., None], cg,
                                                 torch.full_like(cg, 2.0)).amin(dim=-2))
        r2, c2 = _assign(cos, _gates(cos > t["appearance_gate"], st, dets, free, lost),
                         lost, free, t, solve)
        recovered = r2 >= 0
        rtc = torch.where(recovered, r2, rtc)
        ctr = torch.maximum(ctr, c2)

    st = _matches(st, dets, rtc, recovered, t)
    st = _misses(st, rtc >= 0, t)
    st = _births(st, dets, ctr < 0, t)
    st["frame_idx"] = st["frame_idx"] + 1
    fresh = st["time_since_update"] == 0
    warm = (st["status"] == TENTATIVE) & (st["frame_idx"][..., None] <= t["n_init"])
    emit = (fresh & (st["status"] == CONFIRMED)) | (warm & fresh)
    out = {"track_id": torch.where(emit, st["track_id"], -1),
           "boxes": cxcywh_to_xyxy(st["mean"][..., :4]), "scores": st["score"],
           "classes": st["classes"], "valid": emit}
    return st, out


def _matches(st, dets, rtc, recovered, t):
    matched = rtc >= 0
    idx = torch.clamp(rtc, 0, dets["boxes"].shape[-2] - 1).long()
    meas = xyxy_to_cxcywh(take(dets["boxes"], idx))
    score = take(dets["scores"], idx)
    um, uc = kf_update(st["mean"], st["cov"], meas, t["kalman"], score)
    rm, rc = kf_init(meas, t["kalman"])
    mean = torch.where(recovered[..., None], rm, um)
    cov = torch.where(recovered[..., None, None], rc, uc)
    st["mean"] = torch.where(matched[..., None], mean, st["mean"])
    st["cov"] = torch.where(matched[..., None, None], cov, st["cov"])
    hits = torch.where(matched, st["hits"] + 1, st["hits"])
    st["hits"] = hits
    st["time_since_update"] = torch.where(matched, torch.zeros_like(st["time_since_update"]),
                                          st["time_since_update"])
    st["score"] = torch.where(matched, score, st["score"])
    if t["embed_dim"] > 0:
        det_e = take(dets["embeds"], idx)
        st_embed = st["embed"]
        st["embed"] = torch.where(matched[..., None],
                                  ema_normalize(st_embed, det_e, t["embed_ema"]), st_embed)
        kk = st["gallery"].shape[-2]
        pos = torch.remainder(st["gallery_count"], kk)
        ring = torch.arange(kk, dtype=pos.dtype, device=pos.device)
        write = (pos[..., None] == ring).to(st["gallery"].dtype) * matched[..., None]
        st["gallery"] = st["gallery"] * (1.0 - write[..., None]) + write[..., None] * det_e[..., None, :]
        st["gallery_count"] = torch.where(matched, st["gallery_count"] + 1, st["gallery_count"])
    status = st["status"]
    confirm = matched & (((status == TENTATIVE) & (hits >= t["n_init"])) | (status == LOST))
    st["status"] = torch.where(confirm, CONFIRMED, status).to(torch.int8)
    return st


def _misses(st, was_matched, t):
    live = st["status"] != EMPTY
    missed = live & ~was_matched
    tsu = torch.where(missed, st["time_since_update"] + 1, st["time_since_update"])
    st["age"] = torch.where(live, st["age"] + 1, st["age"])
    s = torch.where(missed & (st["status"] == TENTATIVE), EMPTY, st["status"]).to(torch.int8)
    s = torch.where((s == CONFIRMED) & (tsu > t["max_age"]),
                    LOST if t["reid_recovery"] else EMPTY, s).to(torch.int8)
    s = torch.where((s == LOST) & (tsu > t["max_age"] + t["max_lost_age"]), EMPTY, s).to(torch.int8)
    st["status"], st["time_since_update"] = s, tsu
    st["track_id"] = torch.where(s == EMPTY, -1, st["track_id"])
    return st


def _births(st, dets, unmatched, t):
    d = dets["boxes"].shape[-2]
    dev = dets["boxes"].device
    born = dets["valid"] & unmatched & (dets["scores"] >= t["birth_score_threshold"])
    empty = st["status"] == EMPTY
    b_rank = torch.cumsum(born.to(torch.int32), -1) - 1
    e_rank = (torch.cumsum(empty.to(torch.int32), -1) - 1).to(torch.int32)
    placed = torch.minimum(born.to(torch.int32).sum(-1), empty.to(torch.int32).sum(-1)).to(torch.int32)
    rank_idx = torch.where(born, b_rank, d).long()
    by_rank = torch.full(rank_idx.shape[:-1] + (d + 1,), -1, dtype=torch.int32,
                         device=dev).scatter_(
        -1, rank_idx, torch.arange(d, dtype=torch.int32, device=dev).expand(rank_idx.shape))[..., :d]
    slot_det = torch.gather(by_rank, -1, torch.clamp(e_rank, 0, d - 1).long())
    place = empty & (e_rank < placed[..., None]) & (slot_det >= 0)
    idx = torch.clamp(slot_det, 0, d - 1).long()
    mean, cov = kf_init(xyxy_to_cxcywh(take(dets["boxes"], idx)), t["kalman"])
    st["mean"] = torch.where(place[..., None], mean, st["mean"])
    st["cov"] = torch.where(place[..., None, None], cov, st["cov"])
    st["track_id"] = torch.where(place, st["next_id"][..., None] + e_rank, st["track_id"])
    st["status"] = torch.where(place, TENTATIVE, st["status"]).to(torch.int8)
    st["hits"] = torch.where(place, 1, st["hits"])
    st["time_since_update"] = torch.where(place, 0, st["time_since_update"])
    st["age"] = torch.where(place, 0, st["age"])
    st["classes"] = torch.where(place, take(dets["classes"], idx), st["classes"])
    st["score"] = torch.where(place, take(dets["scores"], idx), st["score"])
    if t["embed_dim"] > 0:
        det_e = take(dets["embeds"], idx)
        st["embed"] = torch.where(place[..., None], det_e, st["embed"])
        fresh = torch.zeros_like(st["gallery"])
        fresh[..., 0, :] = det_e
        st["gallery"] = torch.where(place[..., None, None], fresh, st["gallery"])
        st["gallery_count"] = torch.where(place, 1, st["gallery_count"])
    st["next_id"] = st["next_id"] + placed
    return st
