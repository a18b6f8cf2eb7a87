"""The slice as a whole: rendered pixels -> letterbox -> trained detector ->
NMS -> tracker -> records, through the port's ``SegmentPipeline`` on the CPU,
against the JAX ``SegmentPipeline`` on the same clip, plus the pixel floors
the JAX goldens hold (``tests/golden/test_pixels_to_mota.py``), and
``SegmentPipeline.chunk_step`` against the JAX package's ``_chunk_step`` on
two chunks, at ``decode_scale_denom`` 1 and 2."""
import os

import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.config import (
    Config as JaxConfig,
    DetectorConfig as JaxDetectorConfig,
    PipelineConfig as JaxPipelineConfig,
    TrackerConfig as JaxTrackerConfig,
)
from waymo_2d_tracking_tpu.data.synthetic import render_video_clip as jax_render
from waymo_2d_tracking_tpu.data.synthetic import SyntheticClipConfig as JaxClip

from waymo_2d_tracking_tpu_torch.config import (
    Config,
    DetectorConfig,
    PipelineConfig,
    TrackerConfig,
)
from waymo_2d_tracking_tpu_torch.data.synthetic import (
    SyntheticClipConfig,
    render_video_clip,
)
from waymo_2d_tracking_tpu_torch.eval.mot import evaluate_mot, gt_to_frames
from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames, SegmentPipeline
from waymo_2d_tracking_tpu_torch.weights import fixture_state_dict

# xdist runs several workers on the machine's cores; a torch thread pool the
# width of the machine in each would oversubscribe them, and the port's CPU
# ops are small, so one thread each is fastest.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/golden/test_pixels_to_mota.py PIXELS_DET, CLIP and tracker knobs
DET_KW = dict(
    backbone="resnet18slim", image_size=(256, 384), fpn_channels=32,
    fpn_levels=(3, 4, 5), head_depth=2, head_channels=32,
    pre_nms_topk=128, nms_topk=256, max_detections=32, embed_dim=0,
    dtype="float32", score_threshold=0.3,
)
TRK_KW = dict(
    max_tracks=32, max_detections=32, embed_dim=0,
    n_init=2, max_age=5, iou_threshold=0.3,
    score_threshold=0.55, birth_score_threshold=0.65, birth_iou_threshold=0.3,
)
CLIP_KW = dict(num_frames=80, num_objects=8, image_size=(1024, 1536), seed=5)


def records_to_frames(records, num_frames):
    """TrackRecords -> per-frame (ids, boxes xyxy); object_id interned."""
    ids = {}
    frames = [([], []) for _ in range(num_frames)]
    for r in records:
        ids.setdefault(r.object_id, len(ids))
        x1 = r.center_x - r.length / 2
        y1 = r.center_y - r.width / 2
        frames[r.timestamp_micros][0].append(ids[r.object_id])
        frames[r.timestamp_micros][1].append([x1, y1, x1 + r.length, y1 + r.width])
    return [(np.asarray(i, np.int64), np.asarray(b, float).reshape(len(i), 4))
            for i, b in frames]


def _per_frame(records, num_frames):
    """{frame: sorted [(object_id, (x1, y1, x2, y2))]} for exact id checks."""
    out = {t: [] for t in range(num_frames)}
    for r in records:
        out[r.timestamp_micros].append((r.object_id, r.to_xyxy()))
    return {t: sorted(v) for t, v in out.items()}


def test_seed5_clip_matches_jax_and_meets_floors():
    from flax import serialization

    from waymo_2d_tracking_tpu.models.detector import DetectorRunner as JaxRunner
    from waymo_2d_tracking_tpu.pipeline.run import (
        SegmentFrames as JaxFrames,
        SegmentPipeline as JaxPipeline,
    )
    import jax

    frames, gt = render_video_clip(SyntheticClipConfig(**CLIP_KW))
    jframes, _ = jax_render(JaxClip(**CLIP_KW))
    np.testing.assert_array_equal(frames, jframes)     # the numpy copy renders alike
    ts = list(range(CLIP_KW["num_frames"]))

    cfg = Config(detector=DetectorConfig(**DET_KW), tracker=TrackerConfig(**TRK_KW),
                 pipeline=PipelineConfig(chunk_frames=16, interp_max_gap=0))
    port = SegmentPipeline(cfg, fixture_state_dict("pixels_detector"), device="cpu")
    records, stats = port.run_segment(SegmentFrames("pixels", 1, ts, frames))
    assert stats["frames"] == len(ts)

    jdet = JaxDetectorConfig(**DET_KW)
    template = JaxRunner(jdet).init_params(jax.random.PRNGKey(0), batch_size=1)
    with open("tests/fixtures/pixels_detector.msgpack", "rb") as f:
        variables = serialization.from_bytes(template, f.read())
    jcfg = JaxConfig(detector=jdet, tracker=JaxTrackerConfig(**TRK_KW),
                     pipeline=JaxPipelineConfig(chunk_frames=16, interp_max_gap=0))
    jrecords, _ = JaxPipeline(jcfg, params=variables).run_segment(
        JaxFrames(context_name="pixels", camera_name=1, timestamps=ts, frames=frames))

    got, want = _per_frame(records, len(ts)), _per_frame(jrecords, len(ts))
    for t in ts:
        assert [i for i, _ in got[t]] == [i for i, _ in want[t]], f"frame {t}"
        if got[t]:
            np.testing.assert_allclose([b for _, b in got[t]], [b for _, b in want[t]],
                                       atol=0.2, err_msg=f"frame {t}")

    m = evaluate_mot(gt_to_frames(gt), records_to_frames(records, len(ts)))
    d = m.as_dict()
    assert m.mota >= 0.78, d
    assert m.idf1 >= 0.87, d
    assert m.num_idsw <= 6, d
    assert m.mostly_tracked >= 7, d


def test_chunk_step_matches_jax_chunk_step():
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from waymo_2d_tracking_tpu.config import (
        Config as JaxConfig,
        DetectorConfig as JaxDetectorConfig,
        PipelineConfig as JaxPipelineConfig,
        TrackerConfig as JaxTrackerConfig,
    )
    from waymo_2d_tracking_tpu.models.detector import DetectorRunner as JaxRunner
    from waymo_2d_tracking_tpu.pipeline.run import SegmentPipeline as JaxPipeline
    from waymo_2d_tracking_tpu.tracker import init_state as jax_init_state

    from waymo_2d_tracking_tpu_torch.data.synthetic import SyntheticClipConfig, render_video_clip
    from waymo_2d_tracking_tpu_torch.tracker import init_state
    from waymo_2d_tracking_tpu_torch.weights import from_flax_numpy

    chunk = 4
    frames, _ = render_video_clip(SyntheticClipConfig(num_frames=2 * chunk, num_objects=8,
                                                      image_size=(1024, 1536), seed=5))
    src_hw = tuple(frames.shape[1:3])
    jdet = JaxDetectorConfig(**DET_KW)
    template = JaxRunner(jdet).init_params(jax.random.PRNGKey(0), batch_size=1)
    with open(os.path.join(ROOT, "tests", "fixtures", "pixels_detector.msgpack"), "rb") as f:
        variables = serialization.from_bytes(template, f.read())
    jcfg = JaxConfig(detector=jdet, tracker=JaxTrackerConfig(**TRK_KW),
                     pipeline=JaxPipelineConfig(chunk_frames=chunk))
    jpipe = JaxPipeline(jcfg, params=variables)
    jstate, want = jax_init_state(jcfg.tracker), []
    for start in (0, chunk):
        jstate, jout, jscale = jpipe._chunk_step(jpipe.params, jstate,
                                                 jnp.asarray(frames[start:start + chunk]),
                                                 src_hw=src_hw)
        want.append((jax.tree.map(np.asarray, jout), float(jscale)))
    state_dict = from_flax_numpy(jax.tree.map(np.asarray, variables))

    # denom 2: frames twice the size, downscaled on the device by chunk_step
    # (the area downscale of a 2x nearest upscale gives the frames back)
    for sd in (1, 2):
        cfg = Config(detector=DetectorConfig(**DET_KW), tracker=TrackerConfig(**TRK_KW),
                     pipeline=PipelineConfig(chunk_frames=chunk, decode_scale_denom=sd))
        pipe = SegmentPipeline(cfg, state_dict, device="cpu")
        big = frames.repeat(sd, axis=1).repeat(sd, axis=2)
        state, n_valid = init_state(cfg.tracker, device="cpu"), 0
        for k, (jout, jscale) in enumerate(want):
            block = torch.from_numpy(big[k * chunk:(k + 1) * chunk])
            state, out, scale = pipe.chunk_step(state, block, src_hw)
            assert float(scale) == pytest.approx(jscale, rel=1e-6)
            valid = jout.valid
            np.testing.assert_array_equal(out.valid.numpy(), valid)
            np.testing.assert_array_equal(out.track_id.numpy()[valid], jout.track_id[valid])
            np.testing.assert_array_equal(out.classes.numpy()[valid], jout.classes[valid])
            np.testing.assert_allclose(out.boxes.numpy()[valid], jout.boxes[valid], atol=0.2)
            np.testing.assert_allclose(out.scores.numpy()[valid], jout.scores[valid], atol=1e-4)
            n_valid += int(valid.sum())
        assert n_valid > chunk      # tracks are confirmed and reported


def test_detections_only_records_match_jax_writer():
    """``run_segment(detections_only=True)`` emits the detector's output as
    records exactly as the JAX writer turns the same detections into them."""
    from waymo_2d_tracking_tpu.io_out.submission import (
        records_from_detections as jax_records,
    )

    frames, _ = render_video_clip(SyntheticClipConfig(**{**CLIP_KW, "num_frames": 20}))
    ts = list(range(20))
    cfg = Config(detector=DetectorConfig(**DET_KW), tracker=TrackerConfig(**TRK_KW),
                 pipeline=PipelineConfig(chunk_frames=20, interp_max_gap=0))
    pipe = SegmentPipeline(cfg, fixture_state_dict("pixels_detector"), device="cpu")
    records, stats = pipe.run_segment(SegmentFrames("dets", 2, ts, frames),
                                      detections_only=True)
    images, scale = pipe.preprocess(frames, frames.shape[1:3])   # the one chunk
    dets = pipe.detector.detect(images).to_numpy()
    want = jax_records(dets, "dets", ts, 2, scale=scale)
    assert records and [vars(r) for r in records] == [vars(r) for r in want]
    assert stats["records"] == len(records)


def test_jsonl_round_trip(tmp_path):
    from waymo_2d_tracking_tpu_torch.io_out.submission import (
        TrackRecord, read_jsonl, write_jsonl,
    )

    recs = [TrackRecord.from_xyxy("ctx", 7, 1, "1_3", 2, (1.0, 2.0, 5.0, 9.0), 0.75)]
    path = str(tmp_path / "r.jsonl")
    assert write_jsonl(path, recs) == 1
    assert read_jsonl(path) == recs
