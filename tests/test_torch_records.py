"""The records layer (``io_out/submission.py``) against the JAX package's
``io_out/submission.py``, the reference: ``records_from_track_outputs``
and ``records_from_detections`` build from whole arrays the records that
the reference's loop over the valid slots builds, one
``TrackRecord.from_xyxy`` a slot, and ``write_jsonl`` writes from its
template the bytes of the reference's
``json.dumps(dataclasses.asdict(r), sort_keys=True)`` a line, or raises
what that raises. Its two counters count the lines under a profiler, and
both offline pipelines write the reference's bytes."""
import dataclasses
import glob
import math
import os
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from waymo_2d_tracking_tpu.io_out import submission as jsubm
from waymo_2d_tracking_tpu_torch.config import (
    Config,
    DetectorConfig,
    PipelineConfig,
    TrackerConfig,
)
from waymo_2d_tracking_tpu_torch.io_out import submission as subm
from waymo_2d_tracking_tpu_torch.pipeline import multicam, run
from waymo_2d_tracking_tpu_torch.utils import profiling

torch.set_num_threads(1)


# --- inputs -----------------------------------------------------------------

def _outputs(frames, slots, share, seed=0, ids=None):
    rng = np.random.default_rng(seed)
    xy = rng.random((frames, slots, 2), dtype=np.float32) * 900
    wh = rng.random((frames, slots, 2), dtype=np.float32) * 200
    if ids is None:
        ids = rng.integers(0, 5000, (frames, slots))
    return types.SimpleNamespace(
        valid=rng.random((frames, slots)) < share,
        track_id=np.asarray(ids, dtype=np.int32),
        boxes=np.concatenate([xy, xy + wh], -1),
        scores=rng.random((frames, slots), dtype=np.float32),
        classes=rng.integers(0, 3, (frames, slots)).astype(np.int32))


def _stamps(frames):
    return [100000 * k for k in range(frames)]


def _same_records(got, want):
    """The port's records hold the reference's values field for field: equal
    tuples, and every field of the same type and, for floats, the same bits
    (``==`` takes -0.0 for 0.0)."""
    assert type(got) is list and all(type(g) is subm.TrackRecord for g in got)
    assert all(type(w) is jsubm.TrackRecord for w in want)
    assert list(map(dataclasses.astuple, got)) == list(map(dataclasses.astuple, want))
    for g, w in zip(got, want):
        for a, b in zip(dataclasses.astuple(g), dataclasses.astuple(w)):
            assert type(a) is type(b) and repr(a) == repr(b), (a, b)


_LARGE_IDS = np.array([-1, -2 ** 31, 2 ** 31 - 1, 0, 7, -40000])


@pytest.mark.parametrize("build", ["tracks", "detections"])
@pytest.mark.parametrize("case", [
    ((198, 128), 0.0, 1.0), ((198, 128), 0.3, 1.0), ((198, 128), 1.0, 1.0),
    ((198, 128), 0.0, 0.5), ((198, 128), 0.3, 0.5), ((198, 128), 1.0, 0.5),
    ((198, 128), 0.3, 0.7501), ((0, 128), 0.3, 1.0), ((1, 128), 0.3, 1.0),
    ((1, 128), 1.0, 0.5), ((6, 6), "ids", 1.0), ((4, 16), "empty frame", 0.5),
], ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}-s{c[2]}")
def test_builds_equal_to_the_oracle(build, case):
    (frames, slots), share, scale = case
    if share == "ids":                       # negative and large ids, all valid
        out = _outputs(frames, slots, 1.0, ids=np.resize(_LARGE_IDS, (frames, slots)))
    elif share == "empty frame":             # frame 1 empty, frame 2 full
        out = _outputs(frames, slots, 0.5)
        out.valid[1] = False
        out.valid[2] = True
    else:
        out = _outputs(frames, slots, share)
    ts = _stamps(frames)
    if build == "tracks":
        got = subm.records_from_track_outputs(out, "ctx00001", ts, 3, scale=scale)
        want = jsubm.records_from_track_outputs(out, "ctx00001", ts, 3, scale=scale)
    else:
        dets = types.SimpleNamespace(valid=out.valid, boxes=out.boxes, scores=out.scores,
                                     classes=out.classes)
        got = subm.records_from_detections(dets, "ctx00001", ts, 3, scale=scale)
        want = jsubm.records_from_detections(dets, "ctx00001", ts, 3, scale=scale)
    _same_records(got, want)
    assert len(got) == int(np.asarray(out.valid).sum())


@pytest.mark.parametrize("variant", ["numpy camera and stamps", "interpolated",
                                     "torch tensors", "int64 ids and float classes"])
def test_builds_equal_to_the_oracle_on_other_inputs(variant):
    out = _outputs(40, 32, 0.4, seed=5)
    ts, cam, kw = _stamps(40), 2, {}
    if variant == "numpy camera and stamps":
        ts, cam = np.asarray(ts, dtype=np.int64), np.int32(2)
    elif variant == "interpolated":
        out.track_id = np.resize(np.arange(6), out.track_id.shape).astype(np.int32)
        kw = {"interp_max_gap": 3}
    elif variant == "torch tensors":
        out = types.SimpleNamespace(**{k: torch.from_numpy(np.asarray(v))
                                       for k, v in vars(out).items()})
    else:
        out.track_id = out.track_id.astype(np.int64) * (2 ** 33) - 5
        out.classes = out.classes.astype(np.float32) + 0.5
    got = subm.records_from_track_outputs(out, "ctx", ts, cam, scale=0.5, **kw)
    want = jsubm.records_from_track_outputs(out, "ctx", ts, cam, scale=0.5, **kw)
    _same_records(got, want)
    assert got


@pytest.mark.parametrize("build", ["tracks", "detections"])
@pytest.mark.parametrize("bad", [3, -1, 17])
def test_unmapped_class_raises_the_oracles_error(build, bad):
    out = _outputs(8, 16, 1.0)
    out.classes[2, 5] = bad
    out.classes[6, 1] = -7                   # later in loop order: not the one named
    ts = _stamps(8)
    if build == "tracks":
        fns = (subm.records_from_track_outputs, jsubm.records_from_track_outputs)
    else:
        fns = (subm.records_from_detections, jsubm.records_from_detections)
    msgs = []
    for fn in fns:
        with pytest.raises(ValueError) as e:
            fn(out, "ctx", ts, 1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and f"class id {bad} " in msgs[0]


def _record(**kw):
    base = dict(context_name="ctx00001", timestamp_micros=1900000, camera_name=3,
                object_id="3_1234", object_type=1, center_x=181.3724365234375,
                center_y=732.876708984375, length=84.71389770507812, width=51.9764404296875,
                score=0.24419814348220825)
    return subm.TrackRecord(**dict(base, **kw))


@dataclasses.dataclass
class _Wider(subm.TrackRecord):
    extra: int = 5


_BYTE_CASES = {
    "plain": [_record(), _record(object_id="3_-7", timestamp_micros=0)],
    "negative zero": [_record(center_x=-0.0, length=0.0, score=-0.0)],
    "subnormals": [_record(center_y=5e-324, width=-2.2250738585072014e-308)],
    "exponent reprs": [_record(center_x=1e16, center_y=1e-7, length=-1.5e300,
                               width=1e22, score=2.5e-5)],
    "large ints": [_record(timestamp_micros=2 ** 70, camera_name=-3, object_type=2 ** 40)],
    "nan": [_record(), _record(score=float("nan")), _record()],
    "infinities": [_record(center_x=float("inf")), _record(width=float("-inf"))],
    "overflowing sum": [_record(center_x=1.7e308, center_y=1.7e308)],
    "non-ascii context": [_record(context_name="Zürich_日本_ ", object_id="ñ")],
    "quotes and backslashes": [_record(context_name='a"b\\c\n\t\x01', object_id='"\\"')],
    "np.float64": [_record(), _record(center_x=np.float64(1.25), score=np.float64(0.1))],
    "np.float32": [_record(), _record(score=np.float32(0.5)), _record()],
    "np.int64": [_record(), _record(timestamp_micros=np.int64(5)), _record()],
    "bools": [_record(camera_name=True, object_type=False)],
    "int where float": [_record(center_x=3, score=1)],
    "unserialisable": [_record(), _record(object_id=object()), _record()],
    "subclass": [_record(), _Wider(**dataclasses.asdict(_record()))],
    "empty": [],
}


def _interpolated(mod=subm):
    out = _outputs(30, 16, 0.5, seed=2)
    out.track_id = np.resize(np.arange(5), out.track_id.shape).astype(np.int32)
    return mod.records_from_track_outputs(out, "ctx", _stamps(30), 4, scale=0.75,
                                          interp_max_gap=4)


def _read_back(tmp_path, mod=subm):
    path = str(tmp_path / "in.jsonl")
    jsubm.write_jsonl(path, _BYTE_CASES["plain"] + _BYTE_CASES["exponent reprs"]
                      + _BYTE_CASES["negative zero"] + _BYTE_CASES["non-ascii context"])
    return mod.read_jsonl(path)


@pytest.mark.parametrize("case", sorted(_BYTE_CASES) + ["interpolated", "read back",
                                                        "a generator", "built, 30 %"])
def test_write_jsonl_bytes_equal_to_the_oracle(tmp_path, case):
    """The port's writer on the port's records against the reference's writer
    on the reference's: for built, interpolated and read-back records each
    side builds or reads its own, otherwise both write the same list."""
    def recs_of(mod):
        if case == "interpolated":
            return _interpolated(mod)
        if case == "read back":
            return _read_back(tmp_path, mod)
        if case == "built, 30 %":
            return mod.records_from_track_outputs(_outputs(198, 128, 0.3), "ctx",
                                                  _stamps(198), 5, scale=1 / 1.3333333)
        return _BYTE_CASES["plain"] * 3 if case == "a generator" else _BYTE_CASES[case]
    results = []
    for name, mod in (("got", subm), ("want", jsubm)):
        path, fn, recs = str(tmp_path / f"{name}.jsonl"), mod.write_jsonl, recs_of(mod)
        src = (r for r in recs) if case == "a generator" else recs
        try:
            res = ("returned", fn(path, src))
        except Exception as e:              # noqa: BLE001 - the same exception is the test
            res = ("raised", type(e), str(e))
        with open(path, "rb") as f:
            results.append((res, f.read()))
    assert results[0] == results[1]
    assert (results[0][0][0] == "raised") == (case in ("np.float32", "np.int64",
                                                       "unserialisable"))


@pytest.mark.parametrize("case, lines, slow", [
    ("plain", 2, 0), ("nan", 3, 1), ("np.float64", 2, 1), ("bools", 1, 1), ("empty", 0, 0),
    ("subclass", 2, 1), ("unserialisable", 1, 0), ("interpolated", None, 0),
    ("read back", 5, 0),
])
def test_counters_are_exact_under_a_profiler(tmp_path, case, lines, slow):
    recs = {"interpolated": _interpolated, "read back": lambda: _read_back(tmp_path)}.get(
        case, lambda: _BYTE_CASES[case])()
    lines = len(recs) if lines is None else lines
    path = str(tmp_path / "out.jsonl")
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        try:
            subm.write_jsonl(path, recs)
        except TypeError:
            assert case == "unserialisable"  # the lines before it are counted
        subm.write_jsonl(path, [])
    assert profiling.counters() == {"records_lines": lines, "records_lines_slow": slow}
    profiling.reset_counters()
    subm.write_jsonl(path, recs[:lines])    # no profiler: no counter
    assert profiling.counters() == {}


def test_online_tick_build_is_not_slower():
    """The online session builds one frame a tick, (1, 128) slots: the array
    build gives the reference's records at the rig's 30 % occupancy, and
    costs no more than the reference's loop. The two are timed in turns, the
    best of each kept, with room for a loaded host: the card host reads the
    loop at 2.7-2.9 times the array build (PERF.md)."""
    out = _outputs(1, 128, 0.3, seed=9)
    assert out.valid.sum() > 20
    _same_records(subm.records_from_track_outputs(out, "online", [123], 2, scale=0.5),
                  jsubm.records_from_track_outputs(out, "online", [123], 2, scale=0.5))

    def timed(fn, n=200):
        t = time.perf_counter()
        for _ in range(n):
            fn(out, "online", [123], 2, scale=0.5)
        return (time.perf_counter() - t) / n
    new, old = [], []
    for _ in range(5):
        new.append(timed(subm.records_from_track_outputs))
        old.append(timed(jsubm.records_from_track_outputs))
    assert min(new) <= 1.5 * min(old), (new, old)


# --- both offline pipelines on a tiny CPU clip --------------------------------

FRAMES, CHUNK, CAMS, HW = 10, 4, 2, (72, 104)
CFG = Config(
    detector=DetectorConfig(backbone="resnet18slim", image_size=(64, 96), fpn_channels=32,
                            head_depth=1, pre_nms_topk=32, max_detections=8, embed_dim=8,
                            dtype="float32", score_threshold=0.01),
    tracker=TrackerConfig(max_tracks=16, max_detections=8, embed_dim=8, score_threshold=0.0,
                          birth_score_threshold=0.0, n_init=1),
    pipeline=PipelineConfig(chunk_frames=CHUNK, interp_max_gap=1))


@pytest.mark.parametrize("driver", ["run_segments", "run_segments_group"])
def test_drivers_write_the_oracles_bytes(tmp_path, monkeypatch, driver):
    """Each track file is the reference writer's bytes of the records the
    pipeline built, and those records are the reference builder's on the
    same fetched outputs."""
    frames = np.random.default_rng(3).integers(0, 255, (CAMS, FRAMES) + HW + (3,),
                                               dtype=np.uint8)
    segs = [run.SegmentFrames("ctx", c + 1, _stamps(FRAMES), frames[c]) for c in range(CAMS)]
    built = {}
    real = subm.records_from_track_outputs

    def recorded(outputs, context_name, timestamps, camera_name, **kw):
        recs = real(outputs, context_name, timestamps, camera_name, **kw)
        _same_records(recs, jsubm.records_from_track_outputs(outputs, context_name, timestamps, camera_name,
                                           **kw))
        built[f"{context_name}_{camera_name}.jsonl"] = recs
        return recs
    monkeypatch.setattr(subm, "records_from_track_outputs", recorded)
    out_dir = str(tmp_path / "out")
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        if driver == "run_segments":
            run.run_segments(run.SegmentPipeline(CFG, device="cpu"), segs[:1], out_dir)
        else:
            os.makedirs(out_dir)
            multicam.MultiCamPipeline(CFG, num_cams=CAMS, device="cpu").run_segments_group(
                segs, out_dir)
    files = sorted(glob.glob(os.path.join(out_dir, "*.jsonl")))
    files = [p for p in files if not p.endswith("manifest.jsonl")]
    assert sorted(map(os.path.basename, files)) == sorted(built)
    assert len(built) == (1 if driver == "run_segments" else CAMS)
    for p in files:
        recs = built[os.path.basename(p)]
        assert recs and all(math.isfinite(r.score) for r in recs)
        jsubm.write_jsonl(str(tmp_path / "want.jsonl"), recs)
        with open(p, "rb") as a, open(tmp_path / "want.jsonl", "rb") as b:
            assert a.read() == b.read()
    n = sum(map(len, built.values()))
    assert profiling.counters()["records_lines"] == n
    assert profiling.counters()["records_lines_slow"] == 0
