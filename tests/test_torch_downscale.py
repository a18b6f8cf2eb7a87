"""``decode_scale_denom > 1`` on pre-decoded frames: the port's
``area_downscale`` gives the bytes of the JAX package's ``cv2.resize(...,
INTER_AREA)``, so ``SegmentFrames.chunk_iter`` yields the JAX package's
blocks byte for byte, and ``SegmentPipeline.run_segment`` at denom 2 gives
the JAX package's records, boxes in source pixels."""
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.pipeline.run import SegmentFrames as JaxFrames

from waymo_2d_tracking_tpu_torch.config import (
    Config,
    DetectorConfig,
    PipelineConfig,
    TrackerConfig,
)
from waymo_2d_tracking_tpu_torch.data.preprocess import area_downscale
from waymo_2d_tracking_tpu_torch.data.synthetic import SyntheticClipConfig, render_video_clip
from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames, SegmentPipeline
from waymo_2d_tracking_tpu_torch.weights import fixture_state_dict

torch.set_num_threads(1)


def _random(t, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3), dtype=np.uint8)


def _ties(t, h, w, d, seed):
    """Constant d x d cells, one pixel of each raised so that every cell sums
    to k * d^2 + d^2 / 2: a tie of the rounding rule in every output pixel."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, (t, h // d, w // d, 3)).astype(np.uint8)
    frames = np.repeat(np.repeat(base, d, axis=1), d, axis=2)
    frames[:, ::d, ::d] += np.uint8(d * d // 2)
    return frames


def _clips():
    return {
        "even 64x96": _random(3, 64, 96, 0),
        "odd 65x97": _random(3, 65, 97, 1),
        "odd 67x99": _random(3, 67, 99, 2),
        "side camera 886x1920": _random(2, 886, 1920, 3),
        "ties 64x96 d=2": _ties(3, 64, 96, 2, 4),
        "ties 64x96 d=4": _ties(3, 64, 96, 4, 5),
        "padded last chunk 65x97": _random(5, 65, 97, 6),
    }


@pytest.mark.parametrize("denom", [2, 4])
@pytest.mark.parametrize("name", sorted(_clips()))
def test_chunk_iter_blocks_equal_jax(name, denom):
    frames = _clips()[name]
    t = frames.shape[0]
    chunk = 3 if "padded" in name else t
    ts = list(range(t))
    port = SegmentFrames("c", 1, ts, frames)
    jax_seg = JaxFrames(context_name="c", camera_name=1, timestamps=ts, frames=frames)
    got = list(port.chunk_iter(chunk, scale_denom=denom))
    want = list(jax_seg.chunk_iter(chunk, scale_denom=denom))
    assert len(got) == len(want) == -(-t // chunk)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert port.scaled_hw(denom) == jax_seg.scaled_hw(denom) == got[0].shape[1:3]


def test_area_downscale_identity_and_checks():
    frames = torch.from_numpy(_random(2, 9, 11, 7))
    assert area_downscale(frames, 1) is frames
    # a frame upscaled 2x by repetition comes back exactly
    up = frames.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    assert torch.equal(area_downscale(up, 2), frames)
    with pytest.raises(ValueError, match="uint8"):
        area_downscale(frames.float(), 2)
    with pytest.raises(ValueError, match=">= 1"):
        area_downscale(frames, 0)


# tests/golden/test_pixels_to_mota.py PIXELS_DET and tracker knobs
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


def _per_frame(records, num_frames):
    out = {t: [] for t in range(num_frames)}
    for r in records:
        out[r.timestamp_micros].append((r.object_id, r.to_xyxy()))
    return {t: sorted(v) for t, v in out.items()}


def test_run_segment_denom2_records_equal_jax():
    """A 512x768 clip at ``decode_scale_denom: 2``: the detector sees the
    256x384 downscale, records come back in 512x768 source pixels, with the
    JAX package's ids exactly and its boxes within the tolerance of
    ``tests/test_torch_pipeline.py``."""
    import jax
    from flax import serialization

    from waymo_2d_tracking_tpu.config import (
        Config as JaxConfig,
        DetectorConfig as JaxDetectorConfig,
        PipelineConfig as JaxPipelineConfig,
        TrackerConfig as JaxTrackerConfig,
    )
    from waymo_2d_tracking_tpu.models.detector import DetectorRunner as JaxRunner
    from waymo_2d_tracking_tpu.pipeline.run import SegmentPipeline as JaxPipeline

    num_frames = 12
    frames, _ = render_video_clip(
        SyntheticClipConfig(num_frames=num_frames, num_objects=8, image_size=(1024, 1536),
                            seed=5), render_hw=(512, 768))
    ts = list(range(num_frames))
    pipe_kw = dict(chunk_frames=8, interp_max_gap=0, decode_scale_denom=2)

    cfg = Config(detector=DetectorConfig(**DET_KW), tracker=TrackerConfig(**TRK_KW),
                 pipeline=PipelineConfig(**pipe_kw))
    port = SegmentPipeline(cfg, fixture_state_dict("pixels_detector"), device="cpu")
    records, stats = port.run_segment(SegmentFrames("denom2", 1, ts, frames))
    assert stats["frames"] == num_frames

    jdet = JaxDetectorConfig(**DET_KW)
    template = JaxRunner(jdet).init_params(jax.random.PRNGKey(0), batch_size=1)
    with open("tests/fixtures/pixels_detector.msgpack", "rb") as f:
        variables = serialization.from_bytes(template, f.read())
    jcfg = JaxConfig(detector=jdet, tracker=JaxTrackerConfig(**TRK_KW),
                     pipeline=JaxPipelineConfig(**pipe_kw))
    jrecords, _ = JaxPipeline(jcfg, params=variables).run_segment(
        JaxFrames(context_name="denom2", camera_name=1, timestamps=ts, frames=frames))

    assert len(records) == len(jrecords) > 0
    got, want = _per_frame(records, num_frames), _per_frame(jrecords, num_frames)
    for t in ts:
        assert [i for i, _ in got[t]] == [i for i, _ in want[t]], f"frame {t}"
        if got[t]:
            np.testing.assert_allclose([b for _, b in got[t]], [b for _, b in want[t]],
                                       atol=0.2, err_msg=f"frame {t}")
    # source pixels: the centres reach past the 256x384 the detector saw
    centres = np.asarray([(r.center_x, r.center_y) for r in records])
    assert centres[:, 0].max() > 384 and centres[:, 1].max() > 256
