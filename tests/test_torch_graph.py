"""The body that ``tracker/graph.py`` captures as a CUDA graph, run eagerly on
the CPU through the same static-buffer plumbing (state copied in, one step,
new state and outputs copied back), equals the eager ``track_segment`` bit
for bit on the golden tracker clips, for one camera and for two cameras at
once; the copies it hands out do not alias its buffers. The graph itself
exists only on the card (``chip_smoke.py`` holds it to the eager loop there);
on a CPU state ``CapturedTracker`` raises."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.data.synthetic import SyntheticClipConfig, generate_clip

from waymo_2d_tracking_tpu_torch.config import Config, TrackerConfig
from waymo_2d_tracking_tpu_torch.tracker import init_multicam_state, init_state, track_segment
from waymo_2d_tracking_tpu_torch.tracker.graph import (
    CapturedTracker,
    StaticTrackerStep,
    graph_key,
    track_chunk,
)
from waymo_2d_tracking_tpu_torch.types import Detections

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CLIP = SyntheticClipConfig(num_frames=200, num_objects=12, seed=0)
# tests/test_torch_tracker.py CFGS: the configs the golden files froze
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


def _fields_equal(a, b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what}.{f.name}"
        assert torch.equal(x, y), f"{what}.{f.name} differs"


def _clip(seed, frames=None):
    dets, _ = generate_clip(dataclasses.replace(CLIP, seed=seed))
    d = Detections.from_numpy(dets)
    return d if frames is None else d[:frames]


@pytest.mark.parametrize("golden_name", sorted(CFGS))
def test_static_plumbing_equals_eager_one_camera(golden_name):
    cfg = TrackerConfig(**CFGS[golden_name])
    dets = _clip(0)
    want_state, want_out = track_segment(init_state(cfg, device="cpu"), dets, cfg)
    step = StaticTrackerStep(cfg, init_state(cfg, device="cpu"), dets[0])
    got_state, got_out = step.run(init_state(cfg, device="cpu"), dets)
    _fields_equal(got_state, want_state, "state")
    _fields_equal(got_out, want_out, "outputs")
    golden = np.load(os.path.join(GOLDEN, golden_name))
    np.testing.assert_array_equal(got_out.valid.numpy(), golden["valid"])
    np.testing.assert_array_equal(np.where(got_out.valid, got_out.track_id, -1),
                                  golden["track_id"])


@pytest.mark.parametrize("golden_name", sorted(CFGS))
def test_static_plumbing_equals_eager_two_cameras(golden_name):
    """Two cameras (the golden clip and another seed) in one state, the
    state carried across two chunks as a driver carries it."""
    cfg = TrackerConfig(**CFGS[golden_name])
    dets = Detections.stack([_clip(0, 96), _clip(1, 96)], dim=1)        # (T, 2, D, ...)
    fresh = init_multicam_state(Config(tracker=cfg), 2, device="cpu")
    want_state, want_out = track_segment(fresh, dets, cfg)
    step = StaticTrackerStep(cfg, fresh, dets[0])
    mid, first = step.run(fresh, dets[:48])
    got_state, second = step.run(mid, dets[48:])
    _fields_equal(got_state, want_state, "state")
    _fields_equal(type(first).stack([first[t] for t in range(48)]
                                    + [second[t] for t in range(48)]), want_out, "outputs")
    assert tuple(got_state.next_id.shape) == (2,) and (got_state.next_id > 0).all()


def test_handed_out_state_does_not_alias_the_buffers():
    cfg = TrackerConfig(**CFGS["golden_config1.npz"])
    dets = _clip(0, 12)
    step = StaticTrackerStep(cfg, init_state(cfg, device="cpu"), dets[0])
    state, _ = step.run(init_state(cfg, device="cpu"), dets[:6])
    before = state.to_numpy()
    step.step(dets[6])                      # the buffers advance ...
    after = state.to_numpy()                # ... the copy handed out does not
    for f in dataclasses.fields(before):
        np.testing.assert_array_equal(getattr(after, f.name), getattr(before, f.name))
    assert int(step.state.frame_idx) == int(state.frame_idx) + 1


def test_track_chunk_on_the_cpu_is_the_eager_loop():
    cfg = TrackerConfig(**CFGS["golden_config1.npz"])
    dets = _clip(0, 10)
    graphs = {}
    got = track_chunk(init_state(cfg, device="cpu"), dets, cfg, graphs)
    want = track_segment(init_state(cfg, device="cpu"), dets, cfg)
    _fields_equal(got[0], want[0], "state")
    _fields_equal(got[1], want[1], "outputs")
    assert graphs == {}


def test_graph_key_holds_config_shapes_and_dtypes():
    cfg = TrackerConfig(**CFGS["golden_config1.npz"])
    state, det = init_state(cfg, device="cpu"), _clip(0, 1)[0]
    key = graph_key(cfg, state, det)
    assert key == graph_key(TrackerConfig(**CFGS["golden_config1.npz"]), state, det)
    assert key != graph_key(dataclasses.replace(cfg, byte_low_threshold=0.2), state, det)
    two = init_multicam_state(Config(tracker=cfg), 2, device="cpu")
    assert key != graph_key(cfg, two, Detections.stack([det, det]))
    assert key != graph_key(cfg, state, det.replace(scores=det.scores.double()))


def test_captured_tracker_raises_on_a_cpu_state():
    cfg = TrackerConfig(**CFGS["golden_config1.npz"])
    with pytest.raises(ValueError, match="CUDA"):
        CapturedTracker(cfg, init_state(cfg, device="cpu"), _clip(0, 1)[0])
