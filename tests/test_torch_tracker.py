"""The port's tracker against the JAX package: the frozen golden clips and a
step-by-step state comparison with ReID and stage-2 recovery on.

Inputs come from the JAX package's scripted ``generate_clip`` as numpy and go
to both packages. Off the TPU both run the auction's while-loop schedule, so
ids must agree exactly.
"""
import os

import jax
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.config import TrackerConfig as JaxTrackerConfig
from waymo_2d_tracking_tpu.data.synthetic import SyntheticClipConfig, generate_clip
from waymo_2d_tracking_tpu.eval.mot import evaluate_mot as jax_evaluate_mot
from waymo_2d_tracking_tpu.tracker import Tracker as JaxTracker

from waymo_2d_tracking_tpu_torch.config import TrackerConfig
from waymo_2d_tracking_tpu_torch.eval.mot import (
    evaluate_mot,
    gt_to_frames,
    track_outputs_to_frames,
)
from waymo_2d_tracking_tpu_torch.tracker import Tracker
from waymo_2d_tracking_tpu_torch.types import Detections

# xdist runs several workers on the machine's cores; a torch thread pool the
# width of the machine in each would oversubscribe them, and the port's CPU
# ops are small, so one thread each is fastest.
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CLIP = SyntheticClipConfig(num_frames=200, num_objects=12, seed=0)
CFGS = {
    "golden_config1.npz": dict(
        max_tracks=64, max_detections=64, embed_dim=0,
        n_init=3, max_age=3, iou_threshold=0.3,
    ),
    "golden_config3.npz": dict(
        max_tracks=64, max_detections=64, embed_dim=128,
        appearance_weight=0.3, appearance_gate=0.5,
        n_init=3, max_age=3, iou_threshold=0.3,
        reid_recovery=True, max_lost_age=30, gallery_size=4,
    ),
}


@pytest.mark.parametrize("golden_name", sorted(CFGS))
def test_golden_clip_through_port(golden_name):
    dets, gt = generate_clip(CLIP)
    tracker = Tracker(TrackerConfig(**CFGS[golden_name]), device="cpu")
    _, outs = tracker.run(Detections.from_numpy(dets))
    outs = outs.to_numpy()
    golden = np.load(os.path.join(GOLDEN, golden_name))
    np.testing.assert_array_equal(outs.valid, golden["valid"])
    ids = np.where(outs.valid, outs.track_id, -1)
    np.testing.assert_array_equal(ids, golden["track_id"])
    if "boxes" in golden:
        boxes = np.where(outs.valid[..., None], outs.boxes, 0.0)
        np.testing.assert_allclose(boxes, golden["boxes"], atol=0.2)
    m = evaluate_mot(gt_to_frames(gt), track_outputs_to_frames(outs, CLIP.num_frames))
    assert m.mota > 0.80 and m.idf1 > 0.85, m.as_dict()


def test_step_by_step_state_matches_jax():
    """Scripted detections with ReID, gallery and stage-2 recovery on: the
    full state after every step equals JAX ``track_step``'s."""
    clip = SyntheticClipConfig(num_frames=40, num_objects=6, seed=3,
                               occlusion_gap=(10, 22), embed_dim=16,
                               max_detections=16)
    dets, _ = generate_clip(clip)
    kw = dict(max_tracks=16, max_detections=16, embed_dim=16,
              appearance_weight=0.3, appearance_gate=0.5, n_init=2, max_age=3,
              reid_recovery=True, max_lost_age=20, gallery_size=3,
              birth_iou_threshold=0.5)
    jtr = JaxTracker(JaxTrackerConfig(**kw))
    ttr = Tracker(TrackerConfig(**kw), device="cpu")
    js, ts = jtr.init(), ttr.init()
    recovered_any = False
    for t in range(clip.num_frames):
        frame = jax.tree.map(lambda x: x[t], dets)
        js, jout = jtr.step(js, frame)
        ts, tout = ttr.step(ts, Detections.from_numpy(frame))
        jn = jax.device_get(js)
        tn = ts.to_numpy()
        for name in ("track_id", "status", "hits", "time_since_update", "age",
                     "classes", "gallery_count", "next_id", "frame_idx"):
            np.testing.assert_array_equal(getattr(tn, name), np.asarray(getattr(jn, name)),
                                          err_msg=f"{name} @ step {t}")
        for name in ("mean", "cov", "score", "embed", "gallery"):
            np.testing.assert_allclose(getattr(tn, name), np.asarray(getattr(jn, name)),
                                       rtol=1e-4, atol=1e-3, err_msg=f"{name} @ step {t}")
        np.testing.assert_array_equal(tout.to_numpy().valid, np.asarray(jout.valid))
        recovered_any |= bool(np.any((np.asarray(jn.status) == 2)
                                     & (np.asarray(jn.age) > 12)))
    assert recovered_any


def test_mot_copy_matches_jax():
    dets, gt = generate_clip(SyntheticClipConfig(num_frames=60, seed=1))
    _, outs = JaxTracker(JaxTrackerConfig(max_tracks=32, max_detections=64,
                                          embed_dim=0)).run(dets)
    from waymo_2d_tracking_tpu.eval.mot import (
        gt_to_frames as jgt, track_outputs_to_frames as jtof,
    )
    want = jax_evaluate_mot(jgt(gt), jtof(outs, 60)).as_dict()
    got = evaluate_mot(gt_to_frames(gt), track_outputs_to_frames(outs, 60)).as_dict()
    assert got == want
