"""The sharded fan-out (``pipeline/sharded.py``) at a world of 2 ranks (gloo
on the CPU, one spawn for the file) against the port's unsharded drivers on
the same frames and seeded weights, at the configuration of
``tests/distributed/test_multicam_sharded.py`` (slim detector, 64x96, ReID
on, chunk 4): five segments of unequal length (two full groups and a
partial one) through ``run_segments_sharded``, their JSONL byte-equal and
their ``.gallery.npz`` arrays bit-equal to ``run_segments``', the manifest's
keys and JAX's ``shard`` column, a rerun that does nothing, the detections-only
fan-out equal to ``run_segment(detections_only=True)``; the cases of
``test_sharded_grouping_by_resolution_lazy_and_fault_injection`` (groups by
resolution, the stream consumed lazily, ``fail_after`` and the resume), and
the same fault and resume with the writer's manifest appends slowed in the
call that raises, so the other rank starts the resumed call first; and
two 2-camera contexts through ``run_context_groups_sharded`` equal to
``run_context_groups``. Each rank maps the frames from ``.npy`` files."""
import json
import os

import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu_torch.config import (
    Config,
    DetectorConfig,
    PipelineConfig,
    TrackerConfig,
)
from waymo_2d_tracking_tpu_torch.io_out import submission as subm
from waymo_2d_tracking_tpu_torch.parallel.launch import run_ranks
from waymo_2d_tracking_tpu_torch.pipeline.multicam import MultiCamPipeline, run_context_groups
from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames, SegmentPipeline, run_segments
from waymo_2d_tracking_tpu_torch.tools import rank_cases

torch.set_num_threads(1)

WORLD = 2
CFG = Config(
    detector=DetectorConfig(backbone="resnet18slim", image_size=(64, 96), fpn_channels=64,
                            head_depth=1, pre_nms_topk=32, max_detections=8, embed_dim=8,
                            dtype="float32", score_threshold=0.01),
    tracker=TrackerConfig(max_tracks=16, max_detections=8, embed_dim=8, appearance_weight=0.2,
                          score_threshold=0.0, birth_score_threshold=0.0, n_init=1),
    pipeline=PipelineConfig(chunk_frames=4, cameras=("FRONT", "FRONT_LEFT")),
)
LENGTHS = [6, 9, 5, 13, 6]
SLOW_APPEND_S = 2.0
MIXED = [("a", (12, 16)), ("b", (8, 16)), ("c", (12, 16)), ("d", (8, 16)), ("e", (12, 16))]
STAT_KEYS = {"context", "camera", "frames", "tracks", "records", "shard"}


def _save(d, name, frames):
    path = os.path.join(d, f"{name}.npy")
    np.save(path, frames)
    return path


def _plans(d):
    segs, mixed, ctxs = [], [], []
    for i, t in enumerate(LENGTHS):
        frames = np.random.default_rng(i).integers(0, 255, (t, 96, 128, 3), dtype=np.uint8)
        segs.append({"context": f"seg{i}", "camera": 1, "timestamps": [1000 * k for k in range(t)],
                     "path": _save(d, f"seg{i}", frames)})
    for name, hw in MIXED:
        frames = np.random.default_rng(ord(name)).integers(0, 255, (2,) + hw + (3,), np.uint8)
        mixed.append({"context": name, "camera": 1, "timestamps": [0, 1000],
                      "path": _save(d, f"mixed_{name}", frames)})
    for i, t in enumerate((6, 9)):
        rng = np.random.default_rng(50 + i)
        for cam in (1, 2):
            frames = rng.integers(0, 255, (t, 96, 128, 3), dtype=np.uint8)
            ctxs.append({"context": f"ctx{i}", "camera": cam,
                         "timestamps": [1000 * k for k in range(t)],
                         "path": _save(d, f"ctx{i}_{cam}", frames)})
    return segs, mixed, ctxs


def _frames(plan):
    return [SegmentFrames(p["context"], p["camera"], p["timestamps"], frames=np.load(p["path"]))
            for p in plan]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sharded"))
    segs, mixed, ctxs = _plans(d)
    out_root = os.path.join(d, "shd")
    # seed 0, then the writer's slowed appends
    res = run_ranks(rank_cases.fanout_case, WORLD, "cpu", CFG, out_root, segs, mixed, CFG, ctxs,
                    0, SLOW_APPEND_S, device="cpu", threads=1, timeout=300,
                    workdir=os.path.join(d, "ranks"))
    return {"res": res, "root": out_root, "dir": d, "segs": segs, "ctxs": ctxs}


def _same_outputs(got_dir, want_dir, names):
    for name in names:
        base = os.path.join(want_dir, name)
        with open(os.path.join(got_dir, name), "rb") as g, open(base, "rb") as w:
            assert g.read() == w.read(), name
        gal = name[: -len(".jsonl")] + ".gallery.npz"
        zg, zw = np.load(os.path.join(got_dir, gal)), np.load(os.path.join(want_dir, gal))
        assert sorted(zg.files) == sorted(zw.files) == ["embed", "status", "track_id"]
        for k in zw.files:
            assert zg[k].dtype == zw[k].dtype
            np.testing.assert_array_equal(zg[k], zw[k], err_msg=f"{gal}:{k}")


def test_segments_equal_run_segments(run, tmp_path):
    pipe = SegmentPipeline(CFG, device="cpu", seed=0)
    want = run_segments(pipe, _frames(run["segs"]), str(tmp_path))
    names = [f"seg{i}_1.jsonl" for i in range(len(LENGTHS))]
    _same_outputs(os.path.join(run["root"], "tracks"), str(tmp_path), names)
    assert sum(len(subm.read_jsonl(os.path.join(tmp_path, n))) for n in names) > 0
    for res in run["res"]:
        rows = res["tracks"]
        assert [r["context"] for r in rows] == [f"seg{i}" for i in range(len(LENGTHS))]
        assert [r["shard"] for r in rows] == [0, 1, 0, 1, 0]
        for r, w in zip(rows, want):
            assert set(r) == STAT_KEYS
            assert {k: r[k] for k in STAT_KEYS - {"shard"}} == \
                {k: w[k] for k in STAT_KEYS - {"shard"}}


def test_manifest_keys_shard_and_rerun(run):
    with open(os.path.join(run["root"], "tracks", "manifest.jsonl")) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    assert [m["key"] for m in lines] == [f"seg{i}/1" for i in range(len(LENGTHS))]
    assert [m["shard"] for m in lines] == [0, 1, 0, 1, 0]
    assert all(set(m) == STAT_KEYS | {"key"} for m in lines)
    assert [res["rerun"] for res in run["res"]] == [[]] * WORLD


def test_detections_only_equals_detect_path(run, tmp_path):
    pipe = SegmentPipeline(CFG, device="cpu", seed=0)
    det_dir = os.path.join(run["root"], "detect")
    for seg in _frames(run["segs"]):
        records, _ = pipe.run_segment(seg, detections_only=True)
        name = f"{seg.context_name}_{seg.camera_name}.jsonl"
        subm.write_jsonl(str(tmp_path / name), records)
        assert open(os.path.join(det_dir, name), "rb").read() == \
            open(tmp_path / name, "rb").read()
        assert not os.path.exists(os.path.join(det_dir, name[:-6] + ".gallery.npz"))
    assert [r["shard"] for r in run["res"][0]["detect"]] == [0, 1, 0, 1, 0]


def test_grouping_by_resolution_lazy_and_fault_injection(run):
    """``tests/distributed/test_sharded_pipeline.py``'s logic case on real
    ranks: groups never mix resolutions, a full group runs as soon as it
    fills (before the stream yields the next segment), ``fail_after``
    stops after whole groups with the manifest holding them, and a rerun
    finishes the rest."""
    for rank, res in enumerate(run["res"]):
        rows = res["mixed"]
        assert [(r["context"], r["shard"]) for r in rows] == \
            [("a", 0), ("c", 1), ("b", 0), ("d", 1), ("e", 0)]
        assert res["consumed"] == [n for n, _ in MIXED]
        assert "fault injection: stopping after 2 segments" in res["fault"]
        assert res["fault_manifest"] == ["a/1", "c/1"]
        assert [r["context"] for r in res["resumed"]] == ["b", "d", "e"]
        assert sorted(res["resumed_manifest"]) == sorted(f"{n}/1" for n, _ in MIXED)
    # rank 0 writes the manifest: by the time the stream yields d, the
    # (a, c) group of 12x16 segments has run and been recorded
    seen = dict(run["res"][0]["seen"])
    assert seen["c"] == [] and seen["d"] == ["a/1", "c/1"]
    assert seen["e"] == ["a/1", "c/1", "b/1", "d/1"]


def test_resume_after_a_fault_with_a_slow_writer(run):
    """The writer is still appending the first group's rows when the other
    rank raises and starts the resumed call: every rank must still skip the
    same segments (the writer reads the done keys after a barrier and
    broadcasts them), so both return the same rows and the manifest holds
    each key once."""
    first, *others = run["res"]
    assert "fault injection: stopping after 2 segments" in first["slow_fault"]
    for res in others:
        assert res["slow_fault"] == first["slow_fault"]
        assert res["slow_resumed"] == first["slow_resumed"]
        assert res["slow_resumed_manifest"] == first["slow_resumed_manifest"]
    assert [(r["context"], r["shard"]) for r in first["slow_resumed"]] == \
        [("b", 0), ("d", 1), ("e", 0)]
    keys = first["slow_resumed_manifest"]
    assert len(keys) == len(set(keys)) == len(MIXED)
    assert keys == ["a/1", "c/1", "b/1", "d/1", "e/1"]


def test_contexts_equal_run_context_groups(run, tmp_path):
    mc = MultiCamPipeline(CFG, num_cams=2, device="cpu", seed=0)
    want = run_context_groups(mc, _frames(run["ctxs"]), str(tmp_path))
    names = [f"ctx{i}_{c}.jsonl" for i in range(2) for c in (1, 2)]
    _same_outputs(os.path.join(run["root"], "contexts"), str(tmp_path), names)
    for res in run["res"]:
        rows = res["contexts"]
        assert [(r["context"], r["camera"], r["shard"]) for r in rows] == \
            [("ctx0", 1, 0), ("ctx0", 2, 0), ("ctx1", 1, 1), ("ctx1", 2, 1)]
        assert [{k: v for k, v in r.items() if k != "shard"} for r in rows] == want
        assert res["contexts_rerun"] == []
        assert "context ctx0 has 1 cameras, pipeline expects 2" in res["short_context"]
        assert set(res["launches"].values()) == {0}
