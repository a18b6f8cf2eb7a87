"""Run the pixels fixture's training recipe in the JAX package and in the
PyTorch port on the CPU, and score every set of weights through the port's
pipeline, to tell a port difference from the recipe's own spread.

    JAX_PLATFORMS=cpu python tools/diagnose_fixture_recipe.py OUT_DIR \
        [--steps 800] [--runs jax:0,port:0,port_from_jax:0,jax:1]

Runs (``name:seed``):
- ``jax:S``: the JAX package's ``tools/train_pixels_fixture.py main`` with
  seed S, its output directory pointed at ``OUT_DIR/jax_S`` (never at
  ``tests/fixtures``);
- ``port:S``: the port's ``waymo_2d_tracking_tpu_torch/tools/
  train_pixels_fixture.py main`` with seed S on the CPU (its own weight draw);
- ``port_from_jax:S``: the port's recipe started from the JAX package's
  initial variables for seed S, so only the training arithmetic differs.

Each run prints one JSON line: the loss every 100 steps and at the last step,
the held-out recall@0.5, the seconds it took, and the MOT metrics of the
seed-5 and dense pixel clips (``tests/golden/test_pixels_to_mota.py``'s
settings, float32, chunk 16) through the port's ``SegmentPipeline`` on the
CPU. The committed fixture is scored the same way first.
"""
import contextlib
import importlib.util
import io
import json
import os
import re
import sys
import time

import jax
import numpy as np
import torch
from flax import serialization

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from waymo_2d_tracking_tpu_torch import weights  # noqa: E402
from waymo_2d_tracking_tpu_torch.config import (  # noqa: E402
    Config, DetectorConfig, PipelineConfig, TrackerConfig,
)
from waymo_2d_tracking_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticClipConfig, render_video_clip,
)
from waymo_2d_tracking_tpu_torch.eval.mot import evaluate_mot, gt_to_frames  # noqa: E402
from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames, SegmentPipeline  # noqa: E402

# tests/golden/test_pixels_to_mota.py's clips and tracker
CLIPS = {
    "seed5": SyntheticClipConfig(num_frames=80, num_objects=8, image_size=(1024, 1536), seed=5),
    "dense": SyntheticClipConfig(num_frames=80, num_objects=14, image_size=(1024, 1536), seed=11),
}
TRACKER = dict(chip_smoke.PIXELS_TRK, birth_iou_threshold=0.3)
KEYS = ("mota", "idf1", "num_idsw", "mostly_tracked")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def score(det_cfg: DetectorConfig, state_dict, clips) -> dict:
    out = {}
    for name, (frames, gt, n) in clips.items():
        cfg = Config(detector=det_cfg, tracker=TrackerConfig(**TRACKER),
                     pipeline=PipelineConfig(chunk_frames=16, interp_max_gap=0))
        records, _ = SegmentPipeline(cfg, state_dict, device="cpu").run_segment(
            SegmentFrames("fixture", 1, list(range(n)), frames))
        m = evaluate_mot(gt_to_frames(gt),
                         chip_smoke.records_to_frames(np, records, n)).as_dict()
        out[name] = {k: m[k] for k in KEYS}
    return out


def main(out_dir: str, steps: int, runs):
    jtool = _load(os.path.join(ROOT, "tools", "train_pixels_fixture.py"), "jax_fixture_tool")
    ptool = _load(os.path.join(ROOT, "waymo_2d_tracking_tpu_torch", "tools",
                               "train_pixels_fixture.py"), "port_fixture_tool")
    det_cfg = ptool.pixels_det()
    clips = {}
    for name, clip in CLIPS.items():
        frames, gt = render_video_clip(clip)
        clips[name] = (frames, gt, clip.num_frames)
    with open(os.path.join(ROOT, "tests", "fixtures", "pixels_detector.msgpack"), "rb") as f:
        committed = weights.from_flax_numpy(
            jax.tree.map(np.asarray, serialization.msgpack_restore(f.read())))
    print(json.dumps({"run": "committed", **score(det_cfg, committed, clips)}), flush=True)

    for run in runs:
        kind, seed = run.split(":")
        seed = int(seed)
        t0 = time.perf_counter()
        res = {"run": run, "steps": steps}
        if kind == "jax":
            jtool.FIXTURE_DIR = os.path.join(out_dir, f"jax_{seed}")
            text = io.StringIO()
            try:
                with contextlib.redirect_stdout(text):
                    jtool.main(steps=steps, batch_size=16, seed=seed)
            except AssertionError as e:
                res["gate"] = str(e)
            log = text.getvalue()
            res["losses"] = [float(x) for x in re.findall(r"loss ([0-9.]+)", log)]
            rec = re.search(r"recall@0.5: ([0-9.]+)", log)
            res["recall"] = float(rec.group(1)) if rec else None
            path = os.path.join(jtool.FIXTURE_DIR, "pixels_detector.msgpack")
            sd = None
            if os.path.exists(path):
                with open(path, "rb") as f:
                    sd = weights.from_flax_numpy(
                        jax.tree.map(np.asarray, serialization.msgpack_restore(f.read())))
        else:
            init = None
            if kind == "port_from_jax":
                jcfg = jtool.Config(detector=jtool.PIXELS_DET)
                trainer = jtool.DetectorTrainer(jcfg)
                state = trainer.create_state(jax.random.PRNGKey(seed), batch_size=16)
                init = weights.from_flax_numpy(jax.tree.map(np.asarray, {
                    "params": state.params, "batch_stats": state.batch_stats}))
            lines = []
            try:
                meta = ptool.main(os.path.join(out_dir, f"{kind}_{seed}"), steps=steps,
                                  batch_size=16, seed=seed, device="cpu", log=lines.append,
                                  init_weights=init)
                sd = {k: v.detach().cpu() for k, v in meta["state_dict"].items()}
                res["recall"] = meta["held_out_recall_at_0.5"]
            except AssertionError as e:
                res["gate"], sd = str(e), None
            res["losses"] = [float(x) for x in re.findall(r"loss ([0-9.]+)", "\n".join(lines))]
        res["train_s"] = round(time.perf_counter() - t0, 1)
        if sd is not None:
            res.update(score(det_cfg, sd, clips))
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--runs", default="jax:0,port:0,port_from_jax:0,jax:1")
    args = ap.parse_args()
    torch.set_num_threads(int(os.environ.get("TORCH_THREADS", "4")))
    main(args.out_dir, args.steps, args.runs.split(","))
