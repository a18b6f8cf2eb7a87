"""The camera-batched tracker and the port's multi-camera and online drivers,
against per-camera runs of the port and against the JAX package.

- ``auction_assign`` / ``greedy_assign`` on a batch of problems, one with
  costs 100x the others' (a reduction over the whole batch in
  ``_build_benefit`` would change its pad and eps0), equal to one call per
  problem bit for bit; the whole ``track_segment`` over three cameras with
  BYTE and ``reid_recovery`` on equal to three single-camera runs, both
  assignment methods.
- The driver-parity inputs of ``tests/integration/test_driver_parity.py``
  (T = 4, C = 2, 64x96, slim float32 detector, flip TTA): the port's
  ``MultiCamPipeline``, ``OnlineTracker`` and ``OnlineMultiCamTracker``
  against the JAX ``MultiCamPipeline`` (which that test holds equal to the
  other JAX drivers): ids, classes and valid exact, floats within 1e-4.
- ``run_segments_group`` on a 16-frame two-camera pixel clip with the
  trained ReID fixture: records and gallery sidecars against the JAX
  package's.
- ``run_context_groups`` resume and ``fail_after``, as
  ``tests/integration/test_multicam_tta.py`` checks it for the JAX package.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.config import Config as JaxConfig
from waymo_2d_tracking_tpu.config import DetectorConfig as JaxDetectorConfig
from waymo_2d_tracking_tpu.config import PipelineConfig as JaxPipelineConfig
from waymo_2d_tracking_tpu.config import TrackerConfig as JaxTrackerConfig
from waymo_2d_tracking_tpu.data.synthetic import SyntheticClipConfig as JaxClipConfig
from waymo_2d_tracking_tpu.data.synthetic import generate_clip
from waymo_2d_tracking_tpu.io_out import submission as jsubm
from waymo_2d_tracking_tpu.models.detector import DetectorRunner as JaxRunner

from waymo_2d_tracking_tpu_torch.config import (
    Config,
    DetectorConfig,
    PipelineConfig,
    TrackerConfig,
)
from waymo_2d_tracking_tpu_torch.data.synthetic import SyntheticClipConfig, render_video_clip
from waymo_2d_tracking_tpu_torch.io_out.submission import read_jsonl
from waymo_2d_tracking_tpu_torch.ops.assign import auction_assign, greedy_assign
from waymo_2d_tracking_tpu_torch.pipeline.multicam import (
    MultiCamPipeline,
    init_multicam_state,
    run_context_groups,
)
from waymo_2d_tracking_tpu_torch.pipeline.online import OnlineMultiCamTracker, OnlineTracker
from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames
from waymo_2d_tracking_tpu_torch.tracker import init_state, track_segment
from waymo_2d_tracking_tpu_torch.types import Detections
from waymo_2d_tracking_tpu_torch.weights import fixture_state_dict, from_flax_numpy

from test_torch_pipeline import DET_KW, TRK_KW, _per_frame

torch.set_num_threads(1)


def _fields_equal(a, b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.shape == y.shape and np.array_equal(x, y), f"{what}: {f.name}"


# ----------------------------------------------------------- batched tracker

@pytest.mark.parametrize("method", ["auction", "greedy"])
def test_batched_assign_equals_one_call_per_problem(method):
    rng = np.random.default_rng(17)
    c, r, d = 3, 24, 20
    cost = rng.uniform(0, 1.5, size=(c, r, d)).astype(np.float32)
    cost[1] *= 100.0                                   # one problem's range 100x
    row_mask = rng.uniform(size=(c, r)) < 0.8
    col_mask = rng.uniform(size=(c, d)) < 0.85
    forbid = rng.uniform(size=(c, r, d)) < 0.3
    forbid[2] = True                                   # one infeasible problem
    fn = auction_assign if method == "auction" else greedy_assign
    kw = dict(eps_scale=0.2, eps_min=1e-2, max_iters=4096) if method == "auction" else {}
    t = torch.from_numpy
    got = fn(t(cost), t(row_mask), t(col_mask), t(forbid), **kw)
    for p in range(c):
        want = fn(t(cost[p]), t(row_mask[p]), t(col_mask[p]), t(forbid[p]), **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[p].numpy(), w.numpy(), err_msg=f"problem {p}")
    assert (got[0][2] == -1).all() and (got[0][:2] >= 0).any()


@pytest.mark.parametrize("method", ["auction", "greedy"])
def test_batched_track_segment_equals_per_camera_runs(method):
    """Three cameras' scripted clips (ReID embeddings, an occlusion gap, BYTE
    low-score detections) stepped together equal three single-camera runs,
    every state field and output bit for bit."""
    cams = []
    for seed in (3, 4, 5):
        dets, _ = generate_clip(JaxClipConfig(num_frames=36, num_objects=6, seed=seed,
                                              occlusion_gap=(10, 20), embed_dim=16,
                                              max_detections=16))
        cams.append(Detections.from_numpy(dets))
    cfg = TrackerConfig(max_tracks=16, max_detections=16, embed_dim=16, appearance_weight=0.3,
                        appearance_gate=0.5, n_init=2, max_age=3, reid_recovery=True,
                        max_lost_age=20, gallery_size=3, birth_iou_threshold=0.5,
                        byte_low_threshold=0.2, score_threshold=0.45, assignment=method)
    stacked = Detections.stack(cams, dim=1)                      # (T, C, D, ...)
    states = init_multicam_state(Config(tracker=cfg), 3, device="cpu")
    assert tuple(states.next_id.shape) == (3,)
    got_state, got_out = track_segment(states, stacked, cfg)
    recovered = False
    for ci, dets in enumerate(cams):
        st, out = track_segment(init_state(cfg, device="cpu"), dets, cfg)
        _fields_equal(got_state[ci], st, f"camera {ci} state")
        _fields_equal(got_out[:, ci], out, f"camera {ci} outputs")
        recovered |= bool((st.status == 2).any() & (st.age > 12).any())
    assert got_out.valid.any() and recovered


# ------------------------------------------------------------- driver parity

T, C = 4, 2
HW = (64, 96)
DET = dict(backbone="resnet18slim", image_size=HW, fpn_channels=32, head_depth=1,
           pre_nms_topk=32, max_detections=8, embed_dim=0, dtype="float32",
           score_threshold=0.01)
TRK = dict(max_tracks=16, max_detections=8, embed_dim=0, score_threshold=0.0,
           birth_score_threshold=0.0, n_init=1)


def _frames():
    rng = np.random.default_rng(7)
    return rng.integers(0, 255, (T, C) + HW + (3,), dtype=np.uint8)


@pytest.fixture(scope="module")
def parity():
    """The JAX MultiCamPipeline's outputs on the driver-parity inputs and the
    weights carried to the port."""
    from waymo_2d_tracking_tpu.pipeline.multicam import MultiCamPipeline as JaxMultiCam
    from waymo_2d_tracking_tpu.pipeline.multicam import init_multicam_state as jax_init

    jcfg = JaxConfig(detector=JaxDetectorConfig(**DET), tracker=JaxTrackerConfig(**TRK),
                     pipeline=JaxPipelineConfig(chunk_frames=T, tta_flip=True))
    params = JaxRunner(jcfg.detector).init_params(jax.random.PRNGKey(3))
    mc = JaxMultiCam(jcfg, num_cams=C, params=params)
    _, outputs, _ = mc._chunk_step(params, jax_init(jcfg, C), jnp.asarray(_frames()), HW)
    outputs = jax.device_get(outputs)
    want = type(outputs)(**{f.name: np.asarray(getattr(outputs, f.name))
                            for f in dataclasses.fields(outputs)})
    sd = from_flax_numpy(jax.tree.map(np.asarray, jax.device_get(params)))
    cfg = Config(detector=DetectorConfig(**DET), tracker=TrackerConfig(**TRK),
                 pipeline=PipelineConfig(chunk_frames=T, tta_flip=True))
    return cfg, sd, want


def _outputs_close(got, want, what):
    for f in dataclasses.fields(want):
        x, y = np.asarray(getattr(got, f.name)), np.asarray(getattr(want, f.name))
        assert x.shape == y.shape, what
        if np.issubdtype(y.dtype, np.floating):
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4, err_msg=f"{what} {f.name}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f.name}")


def _records_close(got, want, what):
    key = lambda r: (r.timestamp_micros, r.camera_name, r.object_id)   # noqa: E731
    got, want = sorted(got, key=key), sorted(want, key=key)
    assert [(key(r), r.object_type) for r in got] == [(key(r), r.object_type) for r in want], what
    for g, w in zip(got, want):
        for name in ("center_x", "center_y", "length", "width", "score"):
            assert abs(getattr(g, name) - getattr(w, name)) <= 1e-4 + 1e-4 * abs(getattr(w, name)), \
                (what, name, g, w)


def _jax_records(want, t, cam_index, camera_name):
    one = type(want)(**{f.name: getattr(want, f.name)[t:t + 1, cam_index]
                        for f in dataclasses.fields(want)})
    return jsubm.records_from_track_outputs(one, "online", [1000 * t], camera_name)


def test_multicam_pipeline_matches_jax(parity):
    cfg, sd, want = parity
    assert want.valid.any()
    pipe = MultiCamPipeline(cfg, num_cams=C, state_dict=sd, device="cpu")
    states, got, scale = pipe.run(_frames())
    assert scale == 1.0 and tuple(states.next_id.shape) == (C,)
    _outputs_close(got, want, "MultiCamPipeline")


def test_online_tracker_matches_jax(parity):
    cfg, sd, want = parity
    frames = _frames()
    for ci in range(C):
        sess = OnlineTracker(cfg, sd, device="cpu", camera_name=ci + 1)
        sess.warmup(HW)
        for t in range(T):
            got = sess.step(frames[t, ci], 1000 * t)
            _records_close(got, _jax_records(want, t, ci, ci + 1), f"camera {ci} frame {t}")
            if t == 1:
                # warmup leaves the live state as it found it
                before = sess.state.to_numpy()
                assert sess.warmup(HW) > 0
                _fields_equal(sess.state.to_numpy(), before, "state after warmup")
        stats = sess.latency_stats()
        assert stats["count"] == T and stats["p99_ms"] >= stats["p50_ms"] > 0
        assert sess.last_latency_ms() > 0 and sess.frames_seen == T
        sess.reset(clear_latency=True)
        assert sess.latency_stats() == {"count": 0} and int(sess.state.next_id) == 0
    with pytest.raises(ValueError, match="JPEG"):     # bytes, but not a whole JPEG
        sess.step(b"\xff\xd8", 0)


def test_online_multicam_tracker_matches_jax(parity):
    cfg, sd, want = parity
    frames = _frames()
    rig = OnlineMultiCamTracker(cfg, camera_names=[1, 2], state_dict=sd, device="cpu")
    rig.warmup(HW)
    assert int(rig.states.next_id.sum()) == 0
    for t in range(T):
        got = rig.step(list(frames[t]), 1000 * t)
        expect = _jax_records(want, t, 0, 1) + _jax_records(want, t, 1, 2)
        _records_close(got, expect, f"rig tick {t}")
    assert rig.latency_stats()["count"] == T
    with pytest.raises(ValueError, match="expected 2 frames"):
        rig.step([frames[0, 0]], 0)


# ------------------------------------------------ multicam segments, resume

REID_TRK = dict(TRK_KW, embed_dim=32, max_lost_age=30, birth_iou_threshold=0.3,
                reid_recovery=True, appearance_gate=0.3, gallery_size=4)


def test_run_segments_group_matches_jax_with_sidecars(tmp_path):
    from flax import serialization

    from waymo_2d_tracking_tpu.pipeline.multicam import MultiCamPipeline as JaxMultiCam
    from waymo_2d_tracking_tpu.pipeline.run import SegmentFrames as JaxFrames

    det = dict(DET_KW, embed_dim=32)
    clips = [render_video_clip(SyntheticClipConfig(num_frames=16, num_objects=n,
                                                   image_size=(1024, 1536), seed=s))[0]
             for n, s in ((8, 5), (6, 29))]
    ts = list(range(16))

    cfg = Config(detector=DetectorConfig(**det), tracker=TrackerConfig(**REID_TRK),
                 pipeline=PipelineConfig(chunk_frames=8, interp_max_gap=0))
    port = MultiCamPipeline(cfg, num_cams=2, state_dict=fixture_state_dict("pixels_detector_reid"),
                            device="cpu")
    stats = port.run_segments_group(
        [SegmentFrames("mc", cam, ts, f) for cam, f in ((2, clips[1]), (1, clips[0]))],
        str(tmp_path / "port"))
    assert [s["camera"] for s in stats] == [1, 2]

    jdet = JaxDetectorConfig(**det)
    template = JaxRunner(jdet).init_params(jax.random.PRNGKey(0), batch_size=1)
    with open("tests/fixtures/pixels_detector_reid.msgpack", "rb") as f:
        variables = serialization.from_bytes(template, f.read())
    jcfg = JaxConfig(detector=jdet, tracker=JaxTrackerConfig(**REID_TRK),
                     pipeline=JaxPipelineConfig(chunk_frames=8, interp_max_gap=0))
    jstats = JaxMultiCam(jcfg, num_cams=2, params=variables).run_segments_group(
        [JaxFrames(context_name="mc", camera_name=cam, timestamps=ts, frames=f)
         for cam, f in ((1, clips[0]), (2, clips[1]))], str(tmp_path / "jax"))
    assert [{k: s[k] for k in ("context", "camera", "frames")} for s in stats] == \
        [{k: s[k] for k in ("context", "camera", "frames")} for s in jstats]

    for cam in (1, 2):
        got = read_jsonl(str(tmp_path / "port" / f"mc_{cam}.jsonl"))
        want = read_jsonl(str(tmp_path / "jax" / f"mc_{cam}.jsonl"))
        assert got, cam
        g, w = _per_frame(got, 16), _per_frame(want, 16)
        for t in range(16):
            assert [i for i, _ in g[t]] == [i for i, _ in w[t]], f"camera {cam} frame {t}"
            if g[t]:
                np.testing.assert_allclose([b for _, b in g[t]], [b for _, b in w[t]], atol=0.2)
        zg = np.load(tmp_path / "port" / f"mc_{cam}.gallery.npz")
        zw = np.load(tmp_path / "jax" / f"mc_{cam}.gallery.npz")
        np.testing.assert_array_equal(zg["track_id"], zw["track_id"])
        np.testing.assert_array_equal(zg["status"], zw["status"])
        np.testing.assert_allclose(zg["embed"], zw["embed"], atol=1e-4)
        assert (zg["track_id"] >= 0).any()


def test_run_context_groups_resume_and_fault_injection(tmp_path):
    cfg = Config(detector=DetectorConfig(**dict(DET, embed_dim=8)),
                 tracker=TrackerConfig(**dict(TRK, embed_dim=8)),
                 pipeline=PipelineConfig(chunk_frames=2))
    pipe = MultiCamPipeline(cfg, num_cams=2, device="cpu")
    rng = np.random.default_rng(0)

    def contexts():
        segs = []
        for name in ("ctxA", "ctxB", "ctxC"):
            stamps = [1000 * i for i in range(3)]
            for cam in (1, 2):
                segs.append(SegmentFrames(name, cam, stamps,
                                          rng.integers(0, 255, (3, 72, 104, 3), dtype=np.uint8)))
        return segs

    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="fault injection"):
        run_context_groups(pipe, contexts(), out, fail_after=1)
    manifest = os.path.join(out, "manifest.jsonl")
    done = [json.loads(line)["key"] for line in open(manifest) if line.strip()]
    assert done == ["ctxA/1", "ctxA/2"]          # one completed context x two cameras
    assert os.path.exists(os.path.join(out, "ctxA_2.gallery.npz"))

    stats = run_context_groups(pipe, contexts(), out)
    assert [(s["context"], s["camera"]) for s in stats] == [
        ("ctxB", 1), ("ctxB", 2), ("ctxC", 1), ("ctxC", 2)]
    done = [json.loads(line)["key"] for line in open(manifest) if line.strip()]
    assert sorted(done) == [f"ctx{c}/{cam}" for c in "ABC" for cam in (1, 2)]
    assert run_context_groups(pipe, contexts(), out) == []      # rerun is a no-op
    with pytest.raises(AssertionError, match="cameras"):
        run_context_groups(pipe, contexts()[:3], str(tmp_path / "other"))
