"""Tracker hyperparameter search over precomputed detections (``tune``;
counterpart of ``pipeline/tune.py``).

Freeze the detector's outputs once, then sweep association and lifecycle
knobs against ground truth: random search over a declared space, each trial
a full tracker-only run (``pipeline/offline.py track_detection_rows``, what
``track --from-detections`` runs) scored with pooled CLEAR-MOT / IDF1
(``eval/mot.py``, segment-interned ids). The search space, ``apply_knobs``,
``sample_knobs`` and ``evaluate_records`` are the JAX package's, and the
tracker is exact against it, so a report equals the JAX package's for the
same seed and data.

On the card every trial runs through the auction kernel and the captured
tracker step. Trials are independent; ``workers > 1`` fans them over a
process pool started with ``spawn`` (a forked child cannot use CUDA), each
child given the device. Trial i draws its knobs from
``np.random.default_rng(seed + i)`` whatever the worker count or order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

# Each entry: knob path -> sampler(rng) -> value. Paths are dotted into the
# frozen Config (tracker.* / pipeline.*). Distributions bias toward the
# committed defaults so a short search refines rather than thrashes:
# discrete choices repeat the default (0 / off) to give it fair mass.
DEFAULT_SPACE: Dict[str, Callable] = {
    "tracker.score_threshold": lambda rng: round(float(rng.uniform(0.3, 0.7)), 3),
    "tracker.birth_score_threshold":
        lambda rng: round(float(rng.uniform(0.4, 0.8)), 3),
    "tracker.iou_threshold": lambda rng: round(float(rng.uniform(0.15, 0.45)), 3),
    "tracker.iou_buffer": lambda rng: float(rng.choice([0.0, 0.0, 0.1, 0.2, 0.3])),
    "tracker.byte_low_threshold":
        lambda rng: float(rng.choice([0.0, 0.0, 0.1, 0.2, 0.3])),
    "tracker.birth_iou_threshold":
        lambda rng: float(rng.choice([1.0, 1.0, 0.3, 0.5, 0.7])),
    "tracker.n_init": lambda rng: int(rng.integers(1, 4)),
    "tracker.max_age": lambda rng: int(rng.integers(1, 9)),
    "tracker.motion_gate": lambda rng: float(rng.choice([0.0, 0.0, 9.4877])),
    "pipeline.interp_max_gap": lambda rng: int(rng.choice([0, 0, 3, 5])),
}

OBJECTIVES = ("mota", "idf1", "motp")


def apply_knobs(cfg, knobs: Dict[str, object]):
    """Dotted knob dict -> new frozen Config (dataclasses.replace per section)."""
    sections: Dict[str, dict] = {}
    for path, value in knobs.items():
        section, _, field = path.partition(".")
        if not field or not hasattr(cfg, section):
            raise ValueError(f"unknown knob {path!r}")
        if not hasattr(getattr(cfg, section), field):
            raise ValueError(f"unknown knob {path!r}")
        sections.setdefault(section, {})[field] = value
    return dataclasses.replace(cfg, **{
        name: dataclasses.replace(getattr(cfg, name), **fields)
        for name, fields in sections.items()
    })


def sample_knobs(rng: np.random.Generator,
                 space: Dict[str, Callable]) -> Dict[str, object]:
    knobs = {k: space[k](rng) for k in sorted(space)}
    # keep the birth gate at or above the participation gate — sampling
    # them independently would otherwise spend trials on configs where
    # birth_score_threshold is dead (scores below score_threshold never
    # reach the birth logic)
    st = knobs.get("tracker.score_threshold")
    bt = knobs.get("tracker.birth_score_threshold")
    if st is not None and bt is not None and bt < st:
        knobs["tracker.birth_score_threshold"] = st
    return knobs


def evaluate_records(pred_rows, gt_rows, iou_threshold: float = 0.5) -> dict:
    """Pooled CLEAR-MOT/IDF1 over all (context, camera) keys.

    Same protocol as `w2t eval`: union of keys and timestamps, ids
    interned per (key, object_id) namespace, per-key evaluate_mot
    combined exactly with combine_mot.
    """
    from waymo_2d_tracking_tpu_torch.eval.mot import combine_mot, evaluate_mot

    def to_frames(rows):
        by = {}
        for r in rows:
            by.setdefault((r.context_name, r.camera_name), {}).setdefault(
                r.timestamp_micros, []).append(r)
        return by

    pred, gt = to_frames(pred_rows), to_frames(gt_rows)
    intern: dict = {}

    def ids(key, rows_):
        return np.array(
            [intern.setdefault((key, r.object_id), len(intern))
             for r in rows_], dtype=np.int64)

    parts = []
    for key in sorted(set(gt) | set(pred)):
        stamps = sorted(set(gt.get(key, {})) | set(pred.get(key, {})))
        gt_frames, hyp_frames = [], []
        for ts in stamps:
            g = gt.get(key, {}).get(ts, [])
            h = pred.get(key, {}).get(ts, [])
            gt_frames.append(
                (ids(key, g), np.array([r.to_xyxy() for r in g]).reshape(-1, 4)))
            hyp_frames.append(
                (ids(key, h), np.array([r.to_xyxy() for r in h]).reshape(-1, 4)))
        parts.append(evaluate_mot(gt_frames, hyp_frames,
                                  iou_threshold=iou_threshold))
    return combine_mot(parts).as_dict() if parts else {}


def _run_trial(task) -> dict:
    """One trial: knobs -> tracker run -> pooled metrics. Module-level so a
    process pool can dispatch it (det/gt rows ride the pickled task; for
    tune-sized clips that is cheaper than a shared-memory dance)."""
    trial_idx, knobs, cfg, det_rows, gt_rows, iou_threshold, device, build_dir = task
    from waymo_2d_tracking_tpu_torch.ops import _cuda
    from waymo_2d_tracking_tpu_torch.pipeline.offline import track_detection_rows

    _cuda.BUILD_DIR = build_dir   # a spawned child builds where its parent does

    trial_cfg = apply_knobs(cfg, knobs)
    records = track_detection_rows(trial_cfg, det_rows, device=device)
    metrics = evaluate_records(records, gt_rows, iou_threshold=iou_threshold)
    return {"trial": trial_idx, "knobs": knobs, "records": len(records),
            **{k: metrics.get(k) for k in
               ("mota", "motp", "idf1", "num_idsw", "num_fp", "num_fn")}}


def tune_tracker(det_rows, gt_rows, cfg, *, trials: int = 20, seed: int = 0,
                 objective: str = "mota", iou_threshold: float = 0.5,
                 space: Optional[Dict[str, Callable]] = None,
                 workers: int = 0,
                 include_baseline: bool = True, device="cuda") -> dict:
    """Random-search the tracker knob space; returns the ranked report.

    Trial i is reproducible in isolation: its knobs come from
    np.random.default_rng(seed + i) regardless of worker count or order.
    include_baseline prepends the unmodified config as trial -1, so the
    report always answers "did tuning beat what I have?".
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"objective must be one of {OBJECTIVES}, got {objective!r}")
    space = DEFAULT_SPACE if space is None else space
    from waymo_2d_tracking_tpu_torch import resolve_device
    from waymo_2d_tracking_tpu_torch.ops import _cuda
    from waymo_2d_tracking_tpu_torch.pipeline.offline import check_no_appearance

    check_no_appearance(cfg)  # fail before trial 0, not inside the pool
    run = (str(resolve_device(device)), _cuda.BUILD_DIR)
    tasks = []
    if include_baseline:
        tasks.append((-1, {}, cfg, det_rows, gt_rows, iou_threshold, *run))
    for i in range(trials):
        knobs = sample_knobs(np.random.default_rng(seed + i), space)
        tasks.append((i, knobs, cfg, det_rows, gt_rows, iou_threshold, *run))

    if workers > 1 and len(tasks) > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=mp.get_context("spawn")) as pool:
            results = list(pool.map(_run_trial, tasks))
    else:
        results = [_run_trial(t) for t in tasks]

    results.sort(key=lambda r: (-(r[objective] if r[objective] is not None
                                  else -np.inf), r["trial"]))
    best = results[0]
    return {
        "objective": objective,
        "trials": trials,
        "seed": seed,
        "best": best,
        "best_overrides": [f"{k}={v}" for k, v in sorted(best["knobs"].items())],
        "results": results,
    }
