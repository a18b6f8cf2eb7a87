"""The comparison that decides ``correct``.

The configuration's reference (the package its file names under
``reference``, handed in as ``ref``: ``spec.py``) follows the program stage
by stage:

- ``forward_gap``: the staging and the detector's forward. The reference
  downscales and letterboxes the raw frames of each sampled chunk itself
  and runs the detector in float32 (TF32 off); per image and per head output
  (class logits, box distances, centerness over all levels) the relative L2
  distance of the program's output from the reference's; the largest.
- ``embed_gap``: RoIAlign and the ReID tower. At the program's boxes the
  reference pools its own float32 P3 features and embeds them; the largest
  L2 distance between the program's unit embedding and the reference's,
  over the valid detections of the sampled chunks.
- ``select_mismatch``: candidates, NMS and the top-D selection, from the
  program's own head outputs (the stage that ``forward_gap`` checks): the
  detection slots whose box, score, class or validity differ. Exact.
- ``track_mismatch``: the tracker and the records, from the program's own
  detections of every chunk of the checked units (the stage that the two
  gaps and ``select_mismatch`` check): the track records in one list and not
  the other, plus the final track-table slots (id, status, embedding) that
  differ from the program's gallery sidecar. Exact.

``control_artifacts`` computes what the program would have produced with
the reference in its place, one precision step lower than the
configuration states: the forward and the ReID tower with float8 inputs
and weights (bfloat16 stated), the candidates and NMS in bfloat16 and the
tracker's products in TF32 (float32 stated).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import time
from collections import Counter
from typing import Callable, List, Optional

import numpy as np
import torch

DET_FIELDS = ("boxes", "scores", "classes", "embeds", "valid")


@dataclasses.dataclass
class Sample:
    """One sampled detector batch: its raw frames (host uint8 (N, H, W, 3) in
    batch order), the program's head outputs and detections."""
    key: object
    frames: Callable[[], torch.Tensor]
    head: Optional[dict]
    dets: Optional[dict]
    denom: int = 1                 # the decode downscale the program applied first


@dataclasses.dataclass
class TrackUnit:
    """Frames the tracker ran from a fresh table: the program's detections
    per detector batch, in order, and its records."""
    key: object
    dets: List[dict]
    cams: Optional[int]            # None: one camera, no camera axis
    t_real: int                    # frames that have records (pad frames after)
    contexts: List[str]            # per camera
    cameras: List[int]
    timestamps: List[int]
    rows: list                     # program records, as the reference's records.py tuples
    sidecar: Optional[List[dict]]  # per camera {track_id, status, embed} or None
    scale: float                   # network pixels per source pixel
    frames: Optional[Callable[[int], torch.Tensor]] = None   # batch i's raw frames (control)
    denom: int = 1
    check_cams: Optional[List[int]] = None   # camera indices compared (None: all)


def check_cams(ctx) -> Optional[List[int]]:
    """The cameras of a rig whose tracks are compared, drawn from the seed
    (``check_cameras`` of the cell's file; all when absent). Cameras are
    independent problems of one batched step."""
    n = ctx.cellf.get("check_cameras")
    if ctx.cams == 1 or n is None or n >= ctx.cams:
        return None
    return sorted(ctx.rng.choice(ctx.cams, size=n, replace=False).tolist())


@contextlib.contextmanager
def precision(tf32: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def net_scale(cfg: dict, source_hw, sd: int) -> float:
    """Network pixels per source pixel: the letterbox scale over the decode
    downscale ``sd``."""
    hs, ws = -(-source_hw[0] // sd), -(-source_hw[1] // sd)
    hd, wd = cfg["detector"]["image_size"]
    return min(hd / hs, wd / ws) / sd


@torch.no_grad()
def reference_forward(ref, model, cfg: dict, frames: torch.Tensor, device, denom: int,
                      block: int = 8):
    """Raw uint8 frames -> (head outputs {lvl: (cls, ltrb, ctr)}, P3 NHWC),
    float32, in blocks of images."""
    heads, p3 = [], []
    lvl0 = min(cfg["detector"]["fpn_levels"])
    for i in range(0, frames.shape[0], block):
        x = ref.preprocess.area_downscale(frames[i:i + block].to(device), denom)
        images, _ = ref.preprocess.letterbox(x, cfg["detector"]["image_size"])
        h, f = model(images)
        heads.append({lvl: tuple(t.float() for t in v) for lvl, v in h.items()})
        p3.append(f[lvl0].float())
    head = {lvl: tuple(torch.cat([h[lvl][j] for h in heads]) for j in range(3))
            for lvl in heads[0]}
    return head, torch.cat(p3)


@torch.no_grad()
def reference_embeds(ref, model, cfg: dict, p3: torch.Tensor, boxes: torch.Tensor,
                     block: int = 4):
    lvl0 = min(cfg["detector"]["fpn_levels"])
    out = []
    for i in range(0, p3.shape[0], block):
        pooled = ref.postprocess.roi_align(p3[i:i + block], boxes[i:i + block].float(),
                                           1.0 / 2 ** lvl0)
        n, d = pooled.shape[:2]
        out.append(model.embed(pooled.reshape((n * d,) + pooled.shape[2:])).reshape(n, d, -1))
    return torch.cat(out)


KINDS = ("class logits", "box distances", "centerness")


def _per_image_rel(prog: dict, ref: dict):
    """(largest relative L2 distance, its head output, its image)."""
    worst = (0.0, None, None)
    for j in range(3):
        p = torch.cat([prog[lvl][j].float().flatten(1) for lvl in sorted(ref)], 1)
        r = torch.cat([ref[lvl][j].float().flatten(1) for lvl in sorted(ref)], 1)
        rel = torch.linalg.vector_norm(p - r, dim=1) / torch.clamp(
            torch.linalg.vector_norm(r, dim=1), min=1e-12)
        if float(rel.max()) > worst[0]:
            worst = (float(rel.max()), KINDS[j], int(rel.argmax()))
    return worst


def _frame_dets(batch: dict, t: int, cams: Optional[int]) -> dict:
    if cams is None:
        return {f: batch[f][t] for f in DET_FIELDS}
    if batch["boxes"].shape[0] == cams:            # one tick of a rig: (C, D, ...)
        return dict(batch)
    return {f: batch[f][t * cams:(t + 1) * cams] for f in DET_FIELDS}


def _frames_in(batch: dict, cams: Optional[int]) -> int:
    n = batch["boxes"].shape[0]
    return n if cams is None else max(n // cams, 1)


@torch.no_grad()
def run_tracker(ref, cfg: dict, unit: TrackUnit, device, tf32: bool = False):
    """The reference tracker over the unit's detections -> (records, final
    state)."""
    t = cfg["tracker"]
    st = ref.tracker.init_state(t, unit.cams, device)
    outs = []
    solve = None if unit.cams is None else _cams(unit)
    with precision(tf32):
        for batch in unit.dets:
            for i in range(_frames_in(batch, unit.cams)):
                st, out = ref.tracker.step(st, _frame_dets(batch, i, unit.cams), t, solve)
                outs.append({k: v.cpu().numpy() for k, v in out.items()})
    outs = outs[:unit.t_real]
    stacked = {k: np.stack([o[k] for o in outs]) for k in outs[0]} if outs else None
    rows = []
    for ci, cam in enumerate(unit.cameras):
        if stacked is None or (unit.cams is not None and ci not in _cams(unit)):
            continue
        sel = stacked if unit.cams is None else {k: v[:, ci] for k, v in stacked.items()}
        rows += ref.records.rows(sel, unit.contexts[ci], unit.timestamps, cam, unit.scale)
    return rows, {k: v.cpu().numpy() for k, v in st.items()}


def _cams(unit: TrackUnit) -> List[int]:
    return list(range(len(unit.cameras))) if unit.check_cams is None else unit.check_cams


def _program_rows(unit: TrackUnit) -> list:
    keep = {unit.cameras[ci] for ci in _cams(unit)}
    return [r for r in unit.rows if r[2] in keep]


def _sidecar_mismatch(cfg: dict, unit: TrackUnit, state: dict) -> int:
    if unit.sidecar is None or cfg["tracker"]["embed_dim"] <= 1:
        return 0
    bad = 0
    for ci, side in enumerate(unit.sidecar):
        if ci not in _cams(unit):
            continue
        sel = (lambda x: x) if unit.cams is None else (lambda x: x[ci])
        if side is None:
            bad += sel(state["track_id"]).shape[0]
            continue
        same = ((side["track_id"] == sel(state["track_id"]))
                & (side["status"] == sel(state["status"]))
                & np.all(side["embed"].view(np.uint32) == sel(state["embed"]).view(np.uint32), -1))
        bad += int((~same).sum())
    return bad


def compare(ref, model, cfg: dict, samples: List[Sample], tracks: List[TrackUnit], device):
    """The four numbers for the program's (or the control's) artifacts, and
    how much they covered (images, valid detections, program records)."""
    fwd_gap = emb_gap = 0.0
    sel_bad = 0
    trk_bad = 0
    if not samples or any(s.head is None or s.dets is None for s in samples):
        fwd_gap = emb_gap = sel_bad = math.inf
    det = cfg["detector"]
    t0 = time.time()
    seen_worst = None
    with precision(False):
        for s in samples:
            if s.head is None or s.dets is None:
                continue
            head, p3 = reference_forward(ref, model, cfg, s.frames(), device, s.denom)
            gap, kind, image = _per_image_rel(s.head, head)
            if gap > fwd_gap:
                fwd_gap, seen_worst = gap, f"{kind} of image {image} of batch {s.key}"
            if det["embed_dim"] > 0:
                e_ref = reference_embeds(ref, model, cfg, p3, s.dets["boxes"])
                gap = torch.linalg.vector_norm(s.dets["embeds"].float() - e_ref, dim=-1)
                gap = torch.where(s.dets["valid"], gap, 0.0)
                emb_gap = max(emb_gap, float(gap.max()) if gap.numel() else 0.0)
            del head, p3
            cand = ref.postprocess.candidates(s.head, det)
            boxes, scores, classes, valid = ref.postprocess.select(*cand, det)
            diff = ((s.dets["boxes"] != boxes).any(-1) | (s.dets["scores"] != scores)
                    | (s.dets["classes"] != classes) | (s.dets["valid"] != valid))
            sel_bad += int(diff.sum())
    if not tracks:
        trk_bad = math.inf
    seen = {"images": sum(s.dets["valid"].shape[0] for s in samples if s.dets is not None),
            "detections": sum(int(s.dets["valid"].sum()) for s in samples if s.dets is not None),
            "records": sum(len(_program_rows(u)) for u in tracks),
            "worst forward gap at": seen_worst}
    t1 = time.time()
    for u in tracks:
        if not u.dets or any(b is None for b in u.dets):    # a unit that never ran
            trk_bad = math.inf
            continue
        rows, state = run_tracker(ref, cfg, u, device)
        prog = _program_rows(u)
        trk_bad += sum(((Counter(rows) - Counter(prog)) + (Counter(prog) - Counter(rows))).values())
        trk_bad += _sidecar_mismatch(cfg, u, state)
    print(f"check: detector stages {t1 - t0:.2f} s, tracker {time.time() - t1:.2f} s",
          file=sys.stderr)
    return {"forward_gap": fwd_gap, "embed_gap": emb_gap,
            "select_mismatch": sel_bad, "track_mismatch": trk_bad}, seen


@torch.no_grad()
def control_artifacts(ref, model, cfg: dict, samples: List[Sample], tracks: List[TrackUnit],
                      device):
    """Fill the samples and units with what the reference one precision step
    lower produces in the program's place (see the module docstring)."""
    det = cfg["detector"]

    def detect(frames, denom):
        ref.model.set_fake_quant("fp8")
        try:
            head, p3 = reference_forward(ref, model, cfg, frames, device, denom)
            head16 = {lvl: tuple(t.to(torch.bfloat16) if j != 1 else t for j, t in enumerate(v))
                      for lvl, v in head.items()}
            boxes, scores, classes, valid = ref.postprocess.select(
                *ref.postprocess.candidates(head16, det, dtype=torch.bfloat16), det)
            boxes, scores = boxes.float(), scores.float()
            if det["embed_dim"] > 0:
                embeds = reference_embeds(ref, model, cfg, p3, boxes) * valid[..., None]
            else:
                embeds = torch.zeros(boxes.shape[:2] + (1,), device=boxes.device)
        finally:
            ref.model.set_fake_quant(None)
        return head16, {"boxes": boxes, "scores": scores, "classes": classes.to(torch.int32),
                        "embeds": embeds.float(), "valid": valid}

    with precision(False):
        for s in samples:
            s.head, s.dets = detect(s.frames(), s.denom)
        for u in tracks:
            u.dets = [detect(u.frames(i), u.denom)[1] for i in range(len(u.dets))]
    for u in tracks:
        u.rows, state = run_tracker(ref, cfg, u, device, tf32=True)
        if u.sidecar is not None:
            u.sidecar = [{k: (state[k] if u.cams is None else state[k][ci])
                          for k in ("track_id", "status", "embed")}
                         for ci in range(len(u.cameras))]
