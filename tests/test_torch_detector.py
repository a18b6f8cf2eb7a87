"""The port's detector modules against the JAX package on the trained
fixtures: letterbox, per-level head outputs, batched Detections (boxes,
scores, classes, ReID embeddings), and the committed ``.npz`` fixtures
against the msgpack originals.

Tolerances: the f32 convolutions sum in another order in PyTorch than in
XLA, so raw head outputs agree to rtol/atol 1e-4, decoded boxes to 1e-3 px,
scores to 1e-5 and unit-norm embeddings to 1e-4; valid and classes are exact.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from waymo_2d_tracking_tpu.config import DetectorConfig as JaxDetectorConfig
from waymo_2d_tracking_tpu.data.preprocess import letterbox_batch as jax_letterbox
from waymo_2d_tracking_tpu.data.preprocess import unletterbox_boxes as jax_unletterbox
from waymo_2d_tracking_tpu.models.detector import DetectorRunner as JaxRunner

from waymo_2d_tracking_tpu_torch.config import DetectorConfig
from waymo_2d_tracking_tpu_torch.data.preprocess import letterbox_batch, unletterbox_boxes
from waymo_2d_tracking_tpu_torch.data.synthetic import (
    SyntheticClipConfig,
    render_video_clip,
)
from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
from waymo_2d_tracking_tpu_torch.weights import FIXTURES_DIR, fixture_state_dict, load_npz

# xdist runs several workers on the machine's cores; a torch thread pool the
# width of the machine in each would oversubscribe them, and the port's CPU
# ops are small, so one thread each is fastest.
torch.set_num_threads(1)

MSGPACK_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURES = {
    # tests/golden/test_pixels_to_mota.py / test_reid_recovery.py configs
    "pixels_detector": dict(embed_dim=0),
    "pixels_detector_reid": dict(embed_dim=32),
}
BASE = dict(
    backbone="resnet18slim", image_size=(256, 384), fpn_channels=32,
    fpn_levels=(3, 4, 5), head_depth=2, head_channels=32,
    pre_nms_topk=128, nms_topk=256, max_detections=32,
    dtype="float32", score_threshold=0.3,
)


def _jax_variables(name, jcfg):
    template = JaxRunner(jcfg).init_params(jax.random.PRNGKey(0), batch_size=1)
    with open(os.path.join(MSGPACK_DIR, f"{name}.msgpack"), "rb") as f:
        return serialization.from_bytes(template, f.read())


def _frames(n=4):
    clip = SyntheticClipConfig(num_frames=12, num_objects=8,
                               image_size=(1024, 1536), seed=5, texture_amp=0.25)
    frames, _ = render_video_clip(clip)
    return frames[::12 // n][:n]


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_npz_fixture_equals_msgpack(name):
    with open(os.path.join(MSGPACK_DIR, f"{name}.msgpack"), "rb") as f:
        want = dict(_flatten(serialization.msgpack_restore(f.read())))
    got = dict(_flatten(load_npz(os.path.join(FIXTURES_DIR, f"{name}.npz"))))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_letterbox_matches_jax():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(2, 60, 90, 3), dtype=np.uint8)
    for dst in ((48, 64), (64, 64), (60, 90)):
        want, wscale = jax_letterbox(jnp.asarray(frames), (60, 90), dst)
        got, scale = letterbox_batch(torch.from_numpy(frames), (60, 90), dst)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        assert scale == pytest.approx(float(wscale))
    boxes = rng.uniform(0, 64, size=(2, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(
        unletterbox_boxes(torch.from_numpy(boxes), scale).numpy(),
        np.asarray(jax_unletterbox(jnp.asarray(boxes), wscale)), rtol=1e-6)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_head_outputs_and_detections_match_jax(name):
    kw = {**BASE, **FIXTURES[name]}
    jcfg, cfg = JaxDetectorConfig(**kw), DetectorConfig(**kw)
    variables = _jax_variables(name, jcfg)
    jrunner = JaxRunner(jcfg)
    runner = DetectorRunner(cfg, fixture_state_dict(name), device="cpu")

    frames = _frames()
    jimages, _ = jax_letterbox(jnp.asarray(frames), frames.shape[1:3], cfg.image_size)
    images = torch.from_numpy(np.array(jimages))

    jhead, _ = jrunner.module.apply(variables, jimages)
    head, _ = runner.forward(images)
    for lvl in cfg.fpn_levels:
        for got, want in zip(head[lvl], jhead[lvl]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                       rtol=1e-4, atol=1e-4, err_msg=f"P{lvl}")

    want = jax.device_get(jrunner.detect(variables, jimages))
    got = runner.detect(images).to_numpy()
    np.testing.assert_array_equal(got.valid, want.valid)
    assert got.valid.any()
    np.testing.assert_array_equal(got.classes, want.classes)
    np.testing.assert_allclose(got.boxes, want.boxes, atol=1e-3)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-5)
    np.testing.assert_allclose(got.embeds, want.embeds, atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(num_frames=6, seed=5, image_size=(1024, 1536)),
    dict(num_frames=6, seed=29, occlusion_gap=(1, 4), texture_amp=0.25),
    dict(num_frames=8, num_objects=20, seed=31, accel=0.35, pan_amplitude=90.0,
         pan_period=40.0, lifespan_frac=(0.2, 0.7), embed_dim=16),
], ids=["solid", "texture", "hostile"])
def test_render_copy_matches_jax(kw):
    from waymo_2d_tracking_tpu.data.synthetic import SyntheticClipConfig as JaxClip
    from waymo_2d_tracking_tpu.data.synthetic import render_video_clip as jax_render

    frames, gt = render_video_clip(SyntheticClipConfig(**kw))
    jframes, jgt = jax_render(JaxClip(**kw))
    np.testing.assert_array_equal(frames, jframes)
    for key in ("boxes", "present", "ids", "classes"):
        np.testing.assert_array_equal(gt[key], jgt[key])


@pytest.mark.parametrize("method", ["approx", "exact"])
def test_candidates_honour_topk_method(method):
    """``topk_method='approx'`` is ``lax.approx_max_k`` in the JAX package,
    exact off the TPU: the port's candidates equal JAX's for both methods,
    ties included, and an unknown method raises."""
    from waymo_2d_tracking_tpu.models.detector import (
        gather_candidates_batched as jax_gather,
    )
    from waymo_2d_tracking_tpu_torch.models.detector import gather_candidates_batched

    kw = dict(BASE, fpn_levels=(3, 4), pre_nms_topk=60, topk_method=method)
    rng = np.random.default_rng(4)
    head = {}
    for lvl, (h, w) in ((3, (12, 16)), (4, (6, 8))):
        # coarse logits: many equal scores, so the order among ties is compared
        cls = (np.round(rng.normal(0, 1, (2, h, w, 3)) * 2) / 2).astype(np.float32)
        ltrb = rng.uniform(0.5, 3.0, (2, h, w, 4)).astype(np.float32)
        ctr = (np.round(rng.normal(0, 1, (2, h, w, 1)))).astype(np.float32)
        head[lvl] = (cls, ltrb, ctr)
    want = jax_gather({k: tuple(jnp.asarray(t) for t in v) for k, v in head.items()},
                      JaxDetectorConfig(**kw))
    got = gather_candidates_batched({k: tuple(torch.from_numpy(t) for t in v)
                                     for k, v in head.items()}, DetectorConfig(**kw))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # sigmoid and sqrt may round one ulp apart in the two frameworks
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    with pytest.raises(ValueError, match="topk method"):
        gather_candidates_batched({k: tuple(torch.from_numpy(t) for t in v)
                                   for k, v in head.items()},
                                  DetectorConfig(**{**kw, "topk_method": "bucketed"}))
