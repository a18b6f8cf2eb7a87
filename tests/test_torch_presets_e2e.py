"""The shipped presets end to end through the port's drivers against the
JAX package's, float32 on the CPU: rendered frames -> letterbox (after the
``decode_scale_denom`` downscale) -> detector (TTA views on config 5) ->
NMS -> tracker -> records (gap fill on config 5). Configs 2 and 3 here;
robust in ``test_torch_presets_e2e_robust.py`` and config 5 in
``test_torch_presets_e2e_config5.py``, on this file's helpers (split so
that each file takes about 30 s or less).

Each preset's ``tracker`` and ``pipeline`` sections are as shipped: cameras,
chunk, TTA views, ``interp_max_gap``, BYTE / buffered IoU / gallery, the
score gates. The ``detector`` section keeps the preset's ReID width and is
narrowed to the slim size of ``test_torch_tta.py`` (``SLIM``: resnet18slim
at 64x96, an FPN of 32 channels over P3-P5, one 32-wide tower layer, 32
candidates a level, 16 detections a frame). The weights are JAX's seeded
initialisation, carried to the port by ``weights.from_flax_numpy``, with the
class-logit bias raised by ``SCORE_SHIFT``: the initial weights score every
detection 0.16-0.32, under each shipped tracker gate (score 0.5, birth 0.6),
so no track would be born; raised, the scores spread over 0.46-0.63 and the
tracker births, matches and (on robust) runs its BYTE stage. Config 5's
1.25 view is 80x120, a size its coarsest stride (32) does not divide.

Tolerances: ``valid`` and ids exact, boxes within 0.2 px, scores within
1e-4, and equal record counts after gap fill.
"""
import os

import jax
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.config import load_config as jax_load_config
from waymo_2d_tracking_tpu.models.detector import DetectorRunner as JaxRunner
from waymo_2d_tracking_tpu.pipeline.run import SegmentFrames as JaxFrames
from waymo_2d_tracking_tpu.pipeline.run import SegmentPipeline as JaxPipeline

from waymo_2d_tracking_tpu_torch.config import load_config
from waymo_2d_tracking_tpu_torch.data.synthetic import SyntheticClipConfig, render_video_clip
from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames, SegmentPipeline
from waymo_2d_tracking_tpu_torch.weights import from_flax_numpy

torch.set_num_threads(1)

CONFIGS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs")
SLIM = dict(backbone="resnet18slim", image_size=[64, 96], fpn_channels=32,
            fpn_levels=[3, 4, 5], head_depth=1, head_channels=32, pre_nms_topk=32,
            nms_topk=128, max_detections=16, dtype="float32", score_threshold=0.01)
SCORE_SHIFT = 2.5


def _configs(preset):
    path = os.path.join(CONFIGS_DIR, preset)
    overrides = {"detector": SLIM}
    return load_config(path, overrides), jax_load_config(path, overrides)


def _weights(jcfg):
    """JAX's seeded variables with the class-logit bias raised, and the same
    tree as the port's state dict."""
    runner = JaxRunner(jcfg.detector)
    variables = jax.tree.map(np.array, jax.device_get(
        jax.jit(lambda key: runner.init_params(key, batch_size=1))(jax.random.PRNGKey(0))))
    head = variables["params"]["heads"]["cls_logits"]
    head["bias"] = head["bias"] + np.float32(SCORE_SHIFT)
    return variables, from_flax_numpy(variables)


def _frames(num_frames, seed, hw):
    frames, _ = render_video_clip(SyntheticClipConfig(num_frames=num_frames, num_objects=8,
                                                      seed=seed), render_hw=hw)
    return frames


def _key(r):
    return (r.timestamp_micros, r.camera_name, r.object_id)


def _assert_records_equal(got, want):
    got, want = sorted(got, key=_key), sorted(want, key=_key)
    assert len(got) == len(want) > 0
    assert [(_key(r), r.object_type) for r in got] == [(_key(r), r.object_type) for r in want]
    np.testing.assert_allclose([r.to_xyxy() for r in got], [r.to_xyxy() for r in want],
                               atol=0.2)
    np.testing.assert_allclose([r.score for r in got], [r.score for r in want], atol=1e-4)


def _assert_tables_equal(state, jstate):
    """Final track tables: live slots and their ids exact."""
    live, jlive = state.status != 0, np.asarray(jstate.status) != 0
    np.testing.assert_array_equal(live, jlive)
    np.testing.assert_array_equal(np.where(live, state.track_id, -1),
                                  np.where(jlive, np.asarray(jstate.track_id), -1))


def compare_single_camera(preset, frames_hw, num_frames):
    """``SegmentPipeline.run_segment`` in both packages on one rendered clip
    of ``frames_hw`` source frames: records and final track tables equal."""
    cfg, jcfg = _configs(preset)
    variables, sd = _weights(jcfg)
    frames = _frames(num_frames, seed=3, hw=frames_hw)
    ts = [100 * t for t in range(num_frames)]

    pipe = SegmentPipeline(cfg, sd, device="cpu")
    records, stats = pipe.run_segment(SegmentFrames("preset", 1, ts, frames))
    jpipe = JaxPipeline(jcfg, params=variables)
    jrecords, jstats = jpipe.run_segment(JaxFrames(context_name="preset", camera_name=1,
                                                   timestamps=ts, frames=frames))
    _assert_records_equal(records, jrecords)
    assert (stats["records"], stats["tracks"]) == (jstats["records"], jstats["tracks"])
    _assert_tables_equal(pipe.last_state, jpipe.last_state)
    return cfg, records


@pytest.mark.parametrize("preset,frames_hw", [
    ("config2_detector_iou.yaml", (64, 96)),     # letterbox at scale 1, 2 chunks of 8
    ("config3_reid_fused.yaml", (96, 144)),      # letterbox at scale 2/3, ReID in the cost
])
def test_single_camera_preset_matches_jax(preset, frames_hw):
    compare_single_camera(preset, frames_hw, num_frames=12)
