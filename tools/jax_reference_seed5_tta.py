"""JAX reference metrics of the seed-5 pixels clip with test-time
augmentation, for the PyTorch port's on-card check (``chip_smoke.py``
phase 2).

    JAX_PLATFORMS=cpu python tools/jax_reference_seed5_tta.py [CHUNK ...]

Runs the JAX package's ``SegmentPipeline`` on the CPU with the trained
``pixels_detector`` fixture and the settings of
``tests/golden/test_pixels_to_mota.py`` (float32, 80 frames at 1024x1536,
chunk 16 unless chunk sizes are given), plus ``tta_flip=True,
tta_scales=(1.0, 0.75)``, and prints the MOT metrics as one JSON line per
chunk size. Other chunk sizes run other batch shapes through the same
detector: their spread shows how far ulp-level differences move the metrics
on this clip.
"""
import json
import os
import sys

import jax
from flax import serialization

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from waymo_2d_tracking_tpu.config import (  # noqa: E402
    Config, DetectorConfig, PipelineConfig, TrackerConfig,
)
from waymo_2d_tracking_tpu.data.synthetic import SyntheticClipConfig, render_video_clip  # noqa: E402
from waymo_2d_tracking_tpu.eval.mot import evaluate_mot, gt_to_frames  # noqa: E402
from waymo_2d_tracking_tpu.models.detector import DetectorRunner  # noqa: E402
from waymo_2d_tracking_tpu.pipeline.run import SegmentFrames, SegmentPipeline  # noqa: E402

DET = dict(backbone="resnet18slim", image_size=(256, 384), fpn_channels=32,
           fpn_levels=(3, 4, 5), head_depth=2, head_channels=32, pre_nms_topk=128,
           nms_topk=256, max_detections=32, embed_dim=0, dtype="float32",
           score_threshold=0.3)
TRK = dict(max_tracks=32, max_detections=32, embed_dim=0, n_init=2, max_age=5,
           iou_threshold=0.3, score_threshold=0.55, birth_score_threshold=0.65,
           birth_iou_threshold=0.3)
CLIP = dict(num_frames=80, num_objects=8, image_size=(1024, 1536), seed=5)


def records_to_frames(records, num_frames):
    import numpy as np

    ids, frames = {}, [([], []) for _ in range(num_frames)]
    for r in records:
        ids.setdefault(r.object_id, len(ids))
        frames[r.timestamp_micros][0].append(ids[r.object_id])
        frames[r.timestamp_micros][1].append(list(r.to_xyxy()))
    return [(np.asarray(i, np.int64), np.asarray(b, float).reshape(len(i), 4))
            for i, b in frames]


def main(chunks):
    det = DetectorConfig(**DET)
    template = DetectorRunner(det).init_params(jax.random.PRNGKey(0), batch_size=1)
    with open(os.path.join(ROOT, "tests", "fixtures", "pixels_detector.msgpack"), "rb") as f:
        params = serialization.from_bytes(template, f.read())
    frames, gt = render_video_clip(SyntheticClipConfig(**CLIP))
    ts = list(range(CLIP["num_frames"]))
    for chunk in chunks:
        cfg = Config(detector=det, tracker=TrackerConfig(**TRK),
                     pipeline=PipelineConfig(chunk_frames=chunk, interp_max_gap=0,
                                             tta_flip=True, tta_scales=(1.0, 0.75)))
        records, _ = SegmentPipeline(cfg, params=params).run_segment(
            SegmentFrames(context_name="seed5", camera_name=1, timestamps=ts, frames=frames))
        m = evaluate_mot(gt_to_frames(gt), records_to_frames(records, len(ts)))
        print(json.dumps({"clip": "seed5", "tta_flip": True, "tta_scales": [1.0, 0.75],
                          "chunk_frames": chunk, "backend": jax.default_backend(),
                          **m.as_dict()}), flush=True)


if __name__ == "__main__":
    main([int(c) for c in sys.argv[1:]] or [16])
