"""The port's test-time augmentation against the JAX package, float32 on the
CPU: the batched and single-image TTA detections at a size whose 0.75-scale
view has odd pyramid widths, and ``SegmentPipeline`` records with TTA on the
trained fixture's seed-5 clip and with CenterNet + TTA on random weights
(``tests/integration/test_pipeline.py:94-110`` and ``:176-195``).

Tolerances as in ``test_torch_detector.py`` (boxes 1e-3 px, scores 1e-5,
embeddings 1e-4; valid and classes exact); records as in
``test_torch_pipeline.py`` (ids exact, boxes 0.2 px).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from waymo_2d_tracking_tpu.config import Config as JaxConfig
from waymo_2d_tracking_tpu.config import DetectorConfig as JaxDetectorConfig
from waymo_2d_tracking_tpu.config import PipelineConfig as JaxPipelineConfig
from waymo_2d_tracking_tpu.config import TrackerConfig as JaxTrackerConfig
from waymo_2d_tracking_tpu.models.detector import DetectorRunner as JaxRunner
from waymo_2d_tracking_tpu.pipeline.run import SegmentFrames as JaxFrames
from waymo_2d_tracking_tpu.pipeline.run import SegmentPipeline as JaxPipeline
from waymo_2d_tracking_tpu.pipeline.tta import detect_tta_batch as jax_tta_batch
from waymo_2d_tracking_tpu.pipeline.tta import detect_tta_single as jax_tta_single
from waymo_2d_tracking_tpu.pipeline.tta import scale_image as jax_scale_image

from waymo_2d_tracking_tpu_torch.config import (
    Config,
    DetectorConfig,
    PipelineConfig,
    TrackerConfig,
)
from waymo_2d_tracking_tpu_torch.data.synthetic import SyntheticClipConfig, render_video_clip
from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames, SegmentPipeline
from waymo_2d_tracking_tpu_torch.pipeline.tta import (
    detect_tta_batch,
    detect_tta_single,
    scale_image,
)
from waymo_2d_tracking_tpu_torch.weights import fixture_state_dict, from_flax_numpy

from test_torch_pipeline import DET_KW, TRK_KW, _per_frame

# xdist runs several workers on the machine's cores; a torch thread pool the
# width of the machine in each would oversubscribe them, and the port's CPU
# ops are small, so one thread each is fastest.
torch.set_num_threads(1)

# 64x96 at scale 0.75 is 48x72: P3 6x9, P4 3x5, P5 2x3 (odd widths)
SMALL = dict(
    backbone="resnet18slim", image_size=(64, 96), fpn_channels=32,
    fpn_levels=(3, 4, 5), head_depth=1, head_channels=32, pre_nms_topk=32,
    nms_topk=128, max_detections=16, embed_dim=16, dtype="float32",
    score_threshold=0.01,
)
SCALES = (0.75, 1.0)


def _pair(kw):
    jrunner = JaxRunner(JaxDetectorConfig(**kw))
    variables = jax.tree.map(np.asarray, jax.device_get(
        jrunner.init_params(jax.random.PRNGKey(0), batch_size=1)))
    return jrunner, variables, from_flax_numpy(variables)


def _assert_dets_equal(got, want):
    np.testing.assert_array_equal(got.valid, want.valid)
    assert got.valid.any()
    np.testing.assert_array_equal(got.classes, want.classes)
    np.testing.assert_allclose(got.boxes, want.boxes, atol=1e-3)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-5)
    np.testing.assert_allclose(got.embeds, want.embeds, atol=1e-4)


def test_scale_image_matches_jax():
    images = np.random.default_rng(1).normal(size=(2, 64, 96, 3)).astype(np.float32)
    for s in (0.75, 0.5, 1.25):
        want = np.asarray(jax_scale_image(jnp.asarray(images), s))
        got = scale_image(torch.from_numpy(images), s).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("head_family", ["fcos", "centernet"])
def test_detect_tta_matches_jax(head_family):
    kw = {**SMALL, "head_family": head_family}
    jrunner, variables, sd = _pair(kw)
    runner = DetectorRunner(DetectorConfig(**kw), sd, device="cpu")
    images = np.random.default_rng(0).normal(size=(2, 64, 96, 3)).astype(np.float32)

    want = jax.device_get(jax.jit(
        lambda v, x: jax_tta_batch(jrunner.module, v, x, jrunner.cfg, scales=SCALES, flip=True)
    )(variables, jnp.asarray(images)))
    got = detect_tta_batch(runner, torch.from_numpy(images), scales=SCALES, flip=True)
    _assert_dets_equal(got.to_numpy(), want)

    # one image, the unflipped 1.0-scale view handed in
    head, _ = runner.forward(torch.from_numpy(images[:1]))
    one = {lvl: tuple(t[0] for t in ts) for lvl, ts in head.items()}
    b, s, c, v = detect_tta_single(runner, torch.from_numpy(images[1]), scales=SCALES,
                                   flip=True, base_head_out=None)
    jb, js, jc, jv = jax.jit(
        lambda v, x: jax_tta_single(jrunner.module, v, x, jrunner.cfg, scales=SCALES, flip=True)
    )(variables, jnp.asarray(images[1]))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=1e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    b0, s0, _, v0 = detect_tta_single(runner, torch.from_numpy(images[0]), scales=SCALES,
                                      base_head_out=one)
    assert torch.equal(v0, torch.from_numpy(got.to_numpy().valid[0]))
    np.testing.assert_allclose(b0.numpy(), got.to_numpy().boxes[0], atol=1e-3)


def test_dense_clip_with_tta_matches_jax():
    # The dense clip (seed 11). On the seed-5 clip these settings meet a near
    # tie at frame 4: TTA keeps two overlapping tracks on one object, and
    # detection differences of 5e-4 px flip which of them the auction gives
    # the detection -- the JAX package's own chunked and standalone detect
    # paths disagree there too. ``chip_smoke.py`` phase 2 holds the 80-frame
    # seed-5 clip with TTA to the JAX metrics within 0.01 / 0.01 / 1 IDSW.
    clip = dict(num_frames=16, num_objects=14, image_size=(1024, 1536), seed=11)
    frames, _ = render_video_clip(SyntheticClipConfig(**clip))
    ts = list(range(clip["num_frames"]))
    pipe_kw = dict(chunk_frames=8, interp_max_gap=0, tta_flip=True, tta_scales=(1.0, 0.75))
    cfg = Config(detector=DetectorConfig(**DET_KW), tracker=TrackerConfig(**TRK_KW),
                 pipeline=PipelineConfig(**pipe_kw))
    records, _ = SegmentPipeline(cfg, fixture_state_dict("pixels_detector"),
                                 device="cpu").run_segment(SegmentFrames("tta", 1, ts, frames))

    jdet = JaxDetectorConfig(**DET_KW)
    template = JaxRunner(jdet).init_params(jax.random.PRNGKey(0), batch_size=1)
    with open("tests/fixtures/pixels_detector.msgpack", "rb") as f:
        variables = serialization.from_bytes(template, f.read())
    jcfg = JaxConfig(detector=jdet, tracker=JaxTrackerConfig(**TRK_KW),
                     pipeline=JaxPipelineConfig(**pipe_kw))
    jrecords, _ = JaxPipeline(jcfg, params=variables).run_segment(
        JaxFrames(context_name="tta", camera_name=1, timestamps=ts, frames=frames))
    _assert_records_equal(records, jrecords, ts)


def test_centernet_with_tta_pipeline_matches_jax():
    det = dict(backbone="resnet18slim", image_size=(64, 96), fpn_channels=64,
               fpn_levels=(3, 4, 5), head_family="centernet", centernet_level=3,
               head_depth=1, pre_nms_topk=32, max_detections=8, embed_dim=0,
               dtype="float32", score_threshold=0.01)
    trk = dict(max_tracks=16, max_detections=8, embed_dim=0, score_threshold=0.0,
               birth_score_threshold=0.0, n_init=1)
    pipe_kw = dict(chunk_frames=4, tta_flip=True)
    frames = np.random.default_rng(0).integers(0, 255, size=(6, 96, 128, 3), dtype=np.uint8)
    ts = list(range(6))

    _, variables, sd = _pair(det)
    cfg = Config(detector=DetectorConfig(**det), tracker=TrackerConfig(**trk),
                 pipeline=PipelineConfig(**pipe_kw))
    records, stats = SegmentPipeline(cfg, sd, device="cpu").run_segment(
        SegmentFrames("cn", 1, ts, frames))
    assert stats["frames"] == 6 and records
    jcfg = JaxConfig(detector=JaxDetectorConfig(**det), tracker=JaxTrackerConfig(**trk),
                     pipeline=JaxPipelineConfig(**pipe_kw))
    jrecords, _ = JaxPipeline(jcfg, params=variables).run_segment(
        JaxFrames(context_name="cn", camera_name=1, timestamps=ts, frames=frames))
    _assert_records_equal(records, jrecords, ts)


def _assert_records_equal(records, jrecords, ts):
    got, want = _per_frame(records, len(ts)), _per_frame(jrecords, len(ts))
    assert got.keys() == want.keys()
    assert any(got.values())
    for t in got:
        assert [i for i, _ in got[t]] == [i for i, _ in want[t]], f"frame {t}"
        if got[t]:
            np.testing.assert_allclose([b for _, b in got[t]], [b for _, b in want[t]],
                                       atol=0.2, err_msg=f"frame {t}")
