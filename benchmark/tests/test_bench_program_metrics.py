"""The readers of the metrics that read the program's own spans and
counters (``w2t/`` ranges and ``utils/profiling.py counters()``): on
hand-made profiler events and counter dicts, each ``None`` where what it
reads is absent (a program without the spans or the counters); on a traced
tiny run on the CPU; and on the card, a traced stretch of
``headline.segments`` and of ``headline.jpeg_segments`` that reports them
all."""
import json
import os
import types

import pytest
import torch

from benchmark.conftest import DATA
from benchmark.harness import core, peaks, spec
from benchmark.harness.trace import Trace

torch.set_num_threads(1)
SEED = 2 ** 31 + 1601
SPAN_READERS = ("records_ms_per_frame.segments", "host_staging_ms_per_frame.segments",
                "idle_unexplained_share.segments")
COUNTER_READERS = ("prefetch_fill_ms_per_frame.segments", "pad_frame_share.segments",
                   "track_slot_occupancy.segments", "det_slot_occupancy.segments")
CFG = {"tracker": {"max_tracks": 64}, "detector": {"max_detections": 32}}


def _reader(name):
    return spec.reader({}, name)


def _event(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _view(events, cam_frames=4):
    return types.SimpleNamespace(trace=Trace(events), cfg=CFG, info={"cam_frames": cam_frames})


def _events(program_spans=True):
    """A stretch of 100 us: the unit span over all of it; the driving thread
    waits for the prefetcher over [0, 20], runs a chunk over [20, 60] (its
    kernel on the device over [25, 55]), builds records over [70, 90]
    (inside the probe's own range), and is in no span over [60, 70] and
    [90, 100]. A span on another thread names nothing."""
    ev = [_event("user_annotation", "bench/stretch", 0, 100),
          _event("user_annotation", "bench/records", 72, 16),
          _event("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=5),
          _event("kernel", "k", 25, 30, tid=99, corr=5),
          _event("user_annotation", "w2t/records", 0, 100, tid=2)]
    if program_spans:
        ev += [_event("user_annotation", "w2t/segment", 0, 100),
               _event("user_annotation", "w2t/prefetch_wait", 0, 20),
               _event("user_annotation", "w2t/chunk", 20, 40),
               _event("user_annotation", "w2t/records", 70, 20)]
    return ev


def test_span_readers_on_hand_made_events():
    view = _view(_events())
    # 20 us a reader over 4 camera-frames
    assert _reader("records_ms_per_frame.segments").read(view) == pytest.approx(20e-3 / 4)
    assert _reader("host_staging_ms_per_frame.segments").read(view) == pytest.approx(20e-3 / 4)
    # idle 70 us, of it inside spans below the unit: [0, 25], [55, 60], [70, 90]
    got = _reader("idle_unexplained_share.segments").read(view)
    assert got == pytest.approx(100.0 * 20 / 70)


def test_stack_counts_as_host_staging_and_the_unit_explains_nothing():
    ev = [_event("user_annotation", "bench/stretch", 0, 100),
          _event("user_annotation", "w2t/group", 0, 100),
          _event("user_annotation", "w2t/stack", 10, 30),
          _event("user_annotation", "w2t/stack", 30, 20),       # overlaps: counted once
          _event("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=5),
          _event("kernel", "k", 60, 40, tid=99, corr=5)]
    view = _view(ev, cam_frames=10)
    assert _reader("host_staging_ms_per_frame.segments").read(view) == pytest.approx(40e-3 / 10)
    assert _reader("records_ms_per_frame.segments").read(view) is None
    # idle [0, 60]; the stack names [10, 50]
    assert _reader("idle_unexplained_share.segments").read(view) == pytest.approx(100 * 20 / 60)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_none_without_the_programs_spans(name):
    assert _reader(name).read(_view(_events(program_spans=False))) is None
    if name != "idle_unexplained_share.segments":
        assert _reader(name).read(_view(_events(), cam_frames=0)) is None
    else:           # no device operation: no idle to share out
        assert _reader(name).read(_view([e for e in _events() if e["cat"] != "kernel"])) \
            is None


COUNTS = {"frames_real": 396, "frames_pad": 116, "prefetch_fill_s": 0.99,
          "track_live": 396 * 16, "det_valid": 396 * 32, "det_birth": 396 * 8}
WANT = {"prefetch_fill_ms_per_frame.segments": 2.5,
        "pad_frame_share.segments": 100.0 * 116 / 512,
        "track_slot_occupancy.segments": 25.0,
        "det_slot_occupancy.segments": 25.0}


@pytest.mark.parametrize("name", COUNTER_READERS)
def test_counter_readers(monkeypatch, name):
    from waymo_2d_tracking_tpu_torch.utils import profiling
    view = _view([])
    monkeypatch.setattr(profiling, "counters", lambda: dict(COUNTS))
    assert _reader(name).read(view) == pytest.approx(WANT[name])
    monkeypatch.setattr(profiling, "counters", lambda: {"frames_real": 396})
    assert _reader(name).read(view) is None
    monkeypatch.setattr(profiling, "counters", lambda: dict(COUNTS, frames_real=0))
    assert _reader(name).read(view) is None
    monkeypatch.delattr(profiling, "counters")          # a program without counters
    assert _reader(name).read(view) is None


def _reset_counters():
    """The registry lives as long as the process: a run of the harness
    has it to itself, a test run of several cells does not."""
    from waymo_2d_tracking_tpu_torch.utils import profiling
    profiling.reset_counters()


def _traced_view(cell, res):
    info = res["trace"]
    return types.SimpleNamespace(trace=Trace(info["events"]), cfg=cell["config"]["config"],
                                 info=info, peaks=peaks)


def test_readers_on_a_traced_tiny_run():
    """A traced CPU run of the tiny single-camera cell: 2 segments of 10
    frames in chunks of 4 (2 pad frames each). The CPU has no device
    operations, so the idle share has nothing to read."""
    with open(os.path.join(DATA, "bench.json")) as f:
        cell = spec.resolve("tiny.segments", json.load(f), DATA)
    _reset_counters()
    res = core.run(cell, SEED, 0.0, True, "cpu")
    view = _traced_view(cell, res)
    got = {name: _reader(name).read(view) for name in SPAN_READERS + COUNTER_READERS}
    assert got["idle_unexplained_share.segments"] is None
    assert got["pad_frame_share.segments"] == pytest.approx(100.0 * 4 / 24)
    for name in ("records_ms_per_frame.segments", "host_staging_ms_per_frame.segments",
                 "prefetch_fill_ms_per_frame.segments"):
        assert got[name] > 0, name
    for name in ("track_slot_occupancy.segments", "det_slot_occupancy.segments"):
        assert 0 < got[name] <= 100, name


@pytest.mark.card
@pytest.mark.parametrize("name", ["headline.segments", "headline.jpeg_segments"])
def test_traced_headline_reports_the_programs_metrics(card, name):
    from waymo_2d_tracking_tpu_torch.utils import profiling
    cell = spec.resolve(name)
    _reset_counters()
    res = core.run(cell, SEED, 0.0, True, "cuda")
    assert profiling.counters().get("graph_captures", 0) == 0
    out = core.result_line(cell, res)
    assert out["correct"], out["checks"]
    for name in SPAN_READERS + COUNTER_READERS:
        assert name in out["metrics"], name
    for m in cell["per_layer"]:
        assert m["name"] in out["metrics"], m["name"]
