#!/usr/bin/env python3
"""Train the pixels-to-MOTA fixture detector with the port (counterpart of
``tools/train_pixels_fixture.py``), on the card.

    python3 waymo_2d_tracking_tpu_torch/tools/train_pixels_fixture.py OUT_DIR [--reid]

The recipe: the slim detector (``PIXELS_DET``, 256x384, float32) trained
800 steps at batch 16 (AdamW, lr 3e-3, 50 warm-up steps, weight decay
1e-5) on a fresh random rectangle layout each step
(``data/synthetic.py random_rect_batch``; ``--reid``: a 32-dim embedding
trained with the supervised contrastive loss at weight 0.5 on identity-aware
batches, ``random_rect_batch_reid``). Its gates: held-out recall@0.5 >= 0.8
through ``DetectorRunner.detect`` and, with ``--reid``, serving-path
same-identity cosine distance + 0.05 < different-identity distance.

It writes ``OUT_DIR/<stem>.pt`` (the port's ``state_dict``) and
``<stem>.json`` (the config, recall and separation), never over the
committed fixtures.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pixels_det():
    from waymo_2d_tracking_tpu_torch.config import DetectorConfig

    # tests/golden/test_pixels_to_mota.py's detector
    return DetectorConfig(
        backbone="resnet18slim", image_size=(256, 384), fpn_channels=32,
        fpn_levels=(3, 4, 5), head_depth=2, head_channels=32,
        pre_nms_topk=128, nms_topk=256, max_detections=32, embed_dim=0,
        dtype="float32", score_threshold=0.3,
    )


def _iou(a, b) -> float:
    lt = np.maximum(a[:2], b[:2])
    rb = np.minimum(a[2:], b[2:])
    inter = np.prod(np.maximum(rb - lt, 0))
    union = np.prod(a[2:] - a[:2]) + np.prod(b[2:] - b[:2]) - inter
    return inter / union if union > 0 else 0.0


def recall_at_iou(dets, batch, iou_thr: float = 0.5) -> float:
    """Fraction of valid GT boxes covered by a valid detection at IoU >= thr."""
    boxes, valid = dets.boxes, dets.valid
    hits = total = 0
    for n in range(batch["gt_boxes"].shape[0]):
        for g in np.flatnonzero(batch["gt_valid"][n]):
            total += 1
            best = max((_iou(batch["gt_boxes"][n, g], boxes[n, d])
                        for d in np.flatnonzero(valid[n])), default=0.0)
            hits += best >= iou_thr
    return hits / max(total, 1)


def reid_separation(runner, rng: np.random.Generator, n_batches: int = 4) -> dict:
    """Serving-path embedding quality: detect on held-out identity batches,
    give each detection its GT identity by IoU >= 0.5, and return same- and
    different-identity cosine-distance means and quantiles."""
    import torch

    from waymo_2d_tracking_tpu_torch.data.synthetic import random_rect_batch_reid

    same, diff = [], []
    for _ in range(n_batches):
        batch = random_rect_batch_reid(rng, 16)
        dets = runner.detect(torch.from_numpy(batch["images"]).to(runner.device)).to_numpy()
        pool_e, pool_id = [], []
        for n in range(dets.boxes.shape[0]):
            for d in np.flatnonzero(dets.valid[n]):
                best, best_g = 0.0, -1
                for g in np.flatnonzero(batch["gt_valid"][n]):
                    iou = _iou(batch["gt_boxes"][n, g], dets.boxes[n, d])
                    if iou > best:
                        best, best_g = iou, g
                if best >= 0.5:
                    pool_e.append(dets.embeds[n, d])
                    pool_id.append(batch["gt_track_ids"][n, best_g])
        e, ids = np.asarray(pool_e), np.asarray(pool_id)
        if len(e) < 2:
            continue
        dist = 1.0 - e @ e.T
        same_m = (ids[:, None] == ids[None, :]) & ~np.eye(len(e), dtype=bool)
        diff_m = ids[:, None] != ids[None, :]
        same.extend(dist[same_m].tolist())
        diff.extend(dist[diff_m].tolist())
    same, diff = np.asarray(same), np.asarray(diff)
    return {"same_mean": float(same.mean()), "diff_mean": float(diff.mean()),
            "same_p95": float(np.percentile(same, 95)), "diff_p5": float(np.percentile(diff, 5)),
            "n_same_pairs": int(len(same)), "n_diff_pairs": int(len(diff))}


def main(out_dir: str, steps: int = 800, batch_size: int = 16, seed: int = 0,
         reid: bool = False, device="cuda", log=print) -> dict:
    """Train, check the gates (raising if one is missed) and write the
    fixture to ``out_dir``. Returns its metadata with ``state_dict``."""
    import torch

    from waymo_2d_tracking_tpu_torch.config import Config, TrainConfig
    from waymo_2d_tracking_tpu_torch.data.prefetch import DevicePrefetcher
    from waymo_2d_tracking_tpu_torch.data.synthetic import (
        random_rect_batch,
        random_rect_batch_reid,
    )
    from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
    from waymo_2d_tracking_tpu_torch.train.train import DetectorTrainer

    det_cfg = pixels_det()
    if reid:
        det_cfg = dataclasses.replace(det_cfg, embed_dim=32)
    cfg = Config(detector=det_cfg, train=TrainConfig(
        batch_size=batch_size, learning_rate=3e-3, warmup_steps=50, total_steps=steps,
        weight_decay=1e-5, reid_loss_weight=0.5 if reid else 0.0))
    rng = np.random.default_rng(seed)
    trainer = DetectorTrainer(cfg, device=device)
    state = trainer.create_state(torch.Generator().manual_seed(seed))
    gen = random_rect_batch_reid if reid else random_rect_batch
    losses = []
    # the batches are drawn in order from one generator, in the prefetcher's
    # worker thread while the device trains on the previous one
    with DevicePrefetcher((gen(rng, batch_size) for _ in range(steps)), depth=2,
                          device=device) as batches:
        for step, batch in enumerate(batches):
            state, metrics = trainer.train_step(state, batch)
            if step % 100 == 0 or step == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                losses.append(m["loss"])
                extra = f" reid {m['reid_loss']:.4f} (n={m['reid_active']:.0f})" if reid else ""
                log(f"step {step}: loss {m['loss']:.4f}{extra}")

    state_dict = trainer.eval_variables(state)
    runner = DetectorRunner(det_cfg, state_dict, device=device)
    held_out = gen(np.random.default_rng(10_000), 16)
    rec = recall_at_iou(runner.detect(torch.from_numpy(held_out["images"]).to(runner.device))
                        .to_numpy(), held_out)
    log(f"held-out recall@0.5: {rec:.3f}")
    if rec < 0.8:
        raise AssertionError(f"fixture under-trained: recall {rec:.3f} < 0.8")
    meta = {"detector": {k: getattr(det_cfg, k) for k in (
        "backbone", "image_size", "fpn_channels", "fpn_levels", "head_depth", "head_channels",
        "pre_nms_topk", "nms_topk", "max_detections", "embed_dim", "dtype", "score_threshold")},
        "steps": steps, "batch_size": batch_size, "seed": seed,
        "held_out_recall_at_0.5": round(float(rec), 4), "logged_losses": losses}
    if reid:
        sep = reid_separation(runner, np.random.default_rng(20_000))
        log("reid separation: " + json.dumps(sep))
        if not sep["same_mean"] + 0.05 < sep["diff_mean"]:
            raise AssertionError(f"ReID separation gate missed: {sep}")
        meta["reid_separation"] = sep
    os.makedirs(out_dir, exist_ok=True)
    stem = "pixels_detector_reid" if reid else "pixels_detector"
    torch.save({k: v.cpu() for k, v in state_dict.items()}, os.path.join(out_dir, f"{stem}.pt"))
    with open(os.path.join(out_dir, f"{stem}.json"), "w") as f:
        json.dump(meta, f, indent=1)
    log(f"wrote {os.path.join(out_dir, stem)}.pt")
    return dict(meta, state_dict=state_dict)


if __name__ == "__main__":
    import argparse

    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", help="directory for the trained fixture (not fixtures/)")
    ap.add_argument("--reid", action="store_true", help="train the ReID-enabled variant")
    ap.add_argument("--steps", type=int, default=800)
    args = ap.parse_args()
    main(args.out_dir, steps=args.steps, reid=args.reid)
