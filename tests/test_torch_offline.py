"""The port's offline drivers against the JAX package: tracker-only runs over
detection records (``pipeline/offline.py``, config 1), ``run_segments`` with
its manifest resume and gallery sidecars, and the cross-camera ``link_tracks``
rewrite on the same sidecars."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from waymo_2d_tracking_tpu.config import Config as JaxConfig
from waymo_2d_tracking_tpu.config import PipelineConfig as JaxPipelineConfig
from waymo_2d_tracking_tpu.config import TrackerConfig as JaxTrackerConfig
from waymo_2d_tracking_tpu.data.synthetic import SyntheticClipConfig, generate_clip
from waymo_2d_tracking_tpu.io_out import submission as jsubm
from waymo_2d_tracking_tpu.pipeline import link as jlink
from waymo_2d_tracking_tpu.pipeline import offline as joffline

from waymo_2d_tracking_tpu_torch.config import (
    Config,
    DetectorConfig,
    PipelineConfig,
    TrackerConfig,
)
from waymo_2d_tracking_tpu_torch.io_out import submission
from waymo_2d_tracking_tpu_torch.parallel.sharding import make_mesh
from waymo_2d_tracking_tpu_torch.pipeline import link, offline
from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames, SegmentPipeline, run_segments

torch.set_num_threads(1)

TRK = dict(max_tracks=64, max_detections=64, embed_dim=0, n_init=3, max_age=3,
           iou_threshold=0.3)


def _detection_rows():
    """Detection records of two segments: the golden clip's detections on
    camera 1 with every 7th frame dropped whole (the grid must be inferred),
    and a second clip on camera 2."""
    rows = []
    for cam, seed, frames in ((1, 0, 90), (2, 4, 40)):
        dets, _ = generate_clip(SyntheticClipConfig(num_frames=frames, num_objects=10, seed=seed))
        dets = jax.tree.map(np.asarray, dets)
        stamps = [100_000 * t + (7 if t % 3 else 0) for t in range(frames)]   # jitter
        for r in jsubm.records_from_detections(dets, "ctx", stamps, cam):
            t = stamps.index(r.timestamp_micros)
            if cam == 2 or t % 7 != 3:
                rows.append(r)
    return rows


@pytest.mark.parametrize("interp", [0, 3])
def test_track_detection_rows_matches_jax(interp):
    jrows = _detection_rows()
    rows = [submission.TrackRecord(**dataclasses.asdict(r)) for r in jrows]
    want = joffline.track_detection_rows(
        JaxConfig(tracker=JaxTrackerConfig(**TRK), pipeline=JaxPipelineConfig(interp_max_gap=interp)),
        jrows)
    got = offline.track_detection_rows(
        Config(tracker=TrackerConfig(**TRK), pipeline=PipelineConfig(interp_max_gap=interp)),
        rows, device="cpu")
    assert len(got) == len(want) > 500
    for g, w in zip(got, want):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        for k in ("center_x", "center_y", "length", "width", "score"):
            assert abs(g.pop(k) - w.pop(k)) <= 1e-3, k
        assert g == w
    assert {r.camera_name for r in got} == {1, 2}


def test_offline_helpers_match_jax():
    jrows = _detection_rows()
    rows = [submission.TrackRecord(**dataclasses.asdict(r)) for r in jrows]
    groups = offline.group_rows_by_segment(rows)
    assert sorted(groups) == sorted(joffline.group_rows_by_segment(jrows)) == [("ctx", 1), ("ctx", 2)]
    cfg = Config(tracker=TrackerConfig(**TRK))
    stamps, dets = offline.rows_to_detections(cfg, groups[("ctx", 1)], device="cpu")
    jstamps, jdets = joffline.rows_to_detections(JaxConfig(tracker=JaxTrackerConfig(**TRK)),
                                                 joffline.group_rows_by_segment(jrows)[("ctx", 1)])
    assert stamps == jstamps and len(stamps) == 90           # the dropped frames are back
    for f in dataclasses.fields(dets):
        np.testing.assert_array_equal(getattr(dets, f.name).numpy(),
                                      np.asarray(getattr(jdets, f.name)), err_msg=f.name)


def test_check_no_appearance_raises():
    ok = Config(tracker=TrackerConfig(embed_dim=0))
    offline.check_no_appearance(ok)
    for kw in (dict(embed_dim=8, appearance_weight=0.3), dict(embed_dim=8, reid_recovery=True,
                                                            appearance_weight=0.0)):
        with pytest.raises(ValueError, match="embed_dim=0"):
            offline.check_no_appearance(Config(tracker=TrackerConfig(**kw)))
        with pytest.raises(ValueError, match="embed_dim=0"):
            offline.track_detection_rows(Config(tracker=TrackerConfig(**kw)), [], device="cpu")


def test_run_segments_resume_and_sidecars(tmp_path):
    cfg = Config(
        detector=DetectorConfig(backbone="resnet18slim", image_size=(64, 96), fpn_channels=32,
                                head_depth=1, pre_nms_topk=32, max_detections=8, embed_dim=8,
                                dtype="float32", score_threshold=0.01),
        tracker=TrackerConfig(max_tracks=16, max_detections=8, embed_dim=8, score_threshold=0.0,
                              birth_score_threshold=0.0, n_init=1),
        pipeline=PipelineConfig(chunk_frames=2, interp_max_gap=1))
    pipe = SegmentPipeline(cfg, device="cpu")
    rng = np.random.default_rng(1)
    segs = [SegmentFrames(ctx, cam, [0, 1000, 2000],
                          rng.integers(0, 255, (3, 72, 104, 3), dtype=np.uint8))
            for ctx in ("ctxA", "ctxB") for cam in (1, 2)]
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="fault injection"):
        run_segments(pipe, segs, out, fail_after=3)
    manifest = os.path.join(out, "manifest.jsonl")
    done = [json.loads(line)["key"] for line in open(manifest) if line.strip()]
    assert done == ["ctxA/1", "ctxA/2", "ctxB/1"]
    stats = run_segments(pipe, segs, out)
    assert [(s["context"], s["camera"]) for s in stats] == [("ctxB", 2)]
    assert run_segments(pipe, segs, out) == []
    for ctx in ("ctxA", "ctxB"):
        for cam in (1, 2):
            z = np.load(os.path.join(out, f"{ctx}_{cam}.gallery.npz"))
            assert z["embed"].shape == (16, 8) and z["track_id"].shape == (16,)
            assert submission.read_jsonl(os.path.join(out, f"{ctx}_{cam}.jsonl"))


def _write_context(out_dir, ctx, cams, rng):
    """Sidecars and track files of one context: camera 1's tracks 0-3 share
    their embeddings (up to noise) with camera 2's tracks 10-13, and each
    camera has tracks of its own."""
    shared = rng.normal(size=(4, 16)).astype(np.float32)
    for cam in cams:
        own = rng.normal(size=(3, 16)).astype(np.float32)
        noise = rng.normal(scale=0.05, size=shared.shape).astype(np.float32)
        emb = np.concatenate([shared + noise, own, np.zeros((1, 16), np.float32)])
        emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-8)
        ids = np.array([0, 1, 2, 3, 4, 5, 6, -1]) + (10 if cam == 2 else 0)
        ids[-1] = -1
        status = np.array([2, 2, 2, 3, 2, 1, 2, 0], np.int8)
        np.savez(os.path.join(out_dir, f"{ctx}_{cam}.gallery.npz"), track_id=ids,
                 status=status, embed=emb)
        recs = [submission.TrackRecord.from_xyxy(ctx, t, cam, f"{cam}_{int(i)}", 1,
                                                 (t, 2.0, t + 5.0, 9.0), 0.8)
                for t in range(3) for i in ids[:7]]
        submission.write_jsonl(os.path.join(out_dir, f"{ctx}_{cam}.jsonl"), recs)


def test_link_tracks_matches_jax(tmp_path):
    out = str(tmp_path / "out")
    os.makedirs(out)
    rng = np.random.default_rng(2)
    _write_context(out, "ctxA", (1, 2), rng)
    _write_context(out, "ctxB", (1, 2, 3), rng)
    got_cams = link.load_galleries(out)
    want_cams = jlink.load_galleries(out)
    for ctx in want_cams:
        assert link.link_context(got_cams[ctx]) == jlink.link_context(want_cams[ctx])
        assert link.best_cross_camera_matches(got_cams[ctx]) == \
            jlink.best_cross_camera_matches(want_cams[ctx])
    got = link.link_tracks(out, str(tmp_path / "port"))
    want = jlink.link_tracks(out, str(tmp_path / "jax"))
    assert {k: v for k, v in got.items() if k != "out"} == \
        {k: v for k, v in want.items() if k != "out"}
    assert got["cross_camera_merges"] >= 4
    for name in sorted(os.listdir(tmp_path / "jax")):
        assert open(tmp_path / "port" / name).read() == open(tmp_path / "jax" / name).read()
    # the ring-sharded scoring on a world of one equals the dense scoring
    mesh = make_mesh(device="cpu")
    try:
        ring = link.link_tracks(out, str(tmp_path / "ring"), mesh=mesh)
    finally:
        dist.destroy_process_group()
    assert {k: v for k, v in ring.items() if k != "out"} == \
        {k: v for k, v in got.items() if k != "out"}
    for name in sorted(os.listdir(tmp_path / "port")):
        assert open(tmp_path / "ring" / name).read() == open(tmp_path / "port" / name).read()
    with pytest.raises(TypeError, match="DeviceMesh"):
        link.link_tracks(out, mesh=object())
