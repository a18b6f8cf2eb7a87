"""The port's spans and counters (``utils/profiling.py``) on the CPU at a
tiny size: under ``torch.profiler`` the offline drivers and the online step
open their ``w2t/`` spans, nested as their modules' docstrings state; the
counters are exact against what the drivers produced; with no profiler no
span is entered, no counter moves, and every output is byte for byte what a
traced run writes; ``trace(dir)`` writes the counters beside the Chrome
trace."""
import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from waymo_2d_tracking_tpu_torch.config import (
    Config,
    DetectorConfig,
    PipelineConfig,
    TrackerConfig,
)
from waymo_2d_tracking_tpu_torch.pipeline import multicam, online, run
from waymo_2d_tracking_tpu_torch.utils import profiling

torch.set_num_threads(1)

FRAMES, CHUNK, CAMS, HW = 10, 4, 2, (72, 104)
CFG = Config(
    detector=DetectorConfig(backbone="resnet18slim", image_size=(64, 96), fpn_channels=32,
                            head_depth=1, pre_nms_topk=32, max_detections=8, embed_dim=8,
                            dtype="float32", score_threshold=0.01),
    tracker=TrackerConfig(max_tracks=16, max_detections=8, embed_dim=8, score_threshold=0.0,
                          birth_score_threshold=0.0, n_init=1),
    pipeline=PipelineConfig(chunk_frames=CHUNK, interp_max_gap=1))
DRIVERS = ("segments", "group", "online")
UNIT = {"segments": "segment", "group": "group", "online": "tick"}
# child span -> the spans it lies in, by driver; ``records`` lies in the
# unit and in the driver's tail after it (track file, sidecar, manifest)
NESTING = {
    "segments": {"chunk": "segment", "prefetch_wait": "segment", "fetch": "segment",
                 "staging": "chunk", "detect": "chunk", "track": "chunk"},
    "group": {"chunk": "group", "prefetch_wait": "group", "fetch": "group",
              "staging": "chunk", "detect": "chunk", "track": "chunk"},
    "online": {"stack": "tick", "staging": "tick", "detect": "tick", "track": "tick",
               "fetch": "tick"},
}


def _frames(cams=CAMS, seed=3):
    return np.random.default_rng(seed).integers(0, 255, (cams, FRAMES) + HW + (3,),
                                                dtype=np.uint8)


def _segments(frames):
    stamps = [100000 * k for k in range(FRAMES)]
    return [run.SegmentFrames("ctx", c + 1, stamps, frames[c]) for c in range(len(frames))]


def _drive(driver, out_dir):
    """One unit of ``driver`` into ``out_dir``; returns (the files it wrote,
    by name, as bytes; its final state, host arrays)."""
    os.makedirs(out_dir, exist_ok=True)
    frames = _frames()
    if driver == "segments":
        pipe = run.SegmentPipeline(CFG, device="cpu")
        run.run_segments(pipe, _segments(frames[:1]), out_dir)
        state = pipe.last_state
    elif driver == "group":
        pipe = multicam.MultiCamPipeline(CFG, num_cams=CAMS, device="cpu")
        multicam.run_context_groups(pipe, _segments(frames), out_dir)
        state = None
    else:
        sess = online.OnlineMultiCamTracker(CFG, camera_names=[1, 2], device="cpu")
        rows = [sess.step(list(frames[:, t]), 100000 * t) for t in range(FRAMES)]
        with open(os.path.join(out_dir, "ctx.jsonl"), "w") as f:
            f.write(repr(rows))
        state = sess.state.to_numpy()
    files = {os.path.basename(p): open(p, "rb").read()
             for p in sorted(glob.glob(os.path.join(out_dir, "*")))
             if not p.endswith("manifest.jsonl")}      # the manifest holds wall times
    return files, state


def _traced(driver, out_dir):
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        files, state = _drive(driver, out_dir)
    spans = [(e.name[len(profiling.PREFIX):], e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith(profiling.PREFIX)]
    return files, state, spans, profiling.counters()


@pytest.mark.parametrize("driver", DRIVERS)
def test_spans_nest_inside_the_unit(tmp_path, driver):
    _, _, spans, _ = _traced(driver, str(tmp_path))
    names = {n for n, _, _ in spans}
    assert names >= set(NESTING[driver]) | {UNIT[driver], "records"}, names
    for child, parent in NESTING[driver].items():
        outer = [(s, e) for n, s, e in spans if n == parent]
        for n, s, e in spans:
            if n == child:
                assert any(ps <= s and e <= pe for ps, pe in outer), (child, parent)
    units = [(s, e) for n, s, e in spans if n == UNIT[driver]]
    inside = [any(us <= s and e <= ue for us, ue in units)
              for n, s, e in spans if n == "records"]
    assert any(inside) == (driver != "online") and not all(inside)
    # no span inside the tracker's step: a frame's work is one span a chunk
    per_unit = len([n for n, _, _ in spans if n == "track"])
    assert per_unit == (FRAMES if driver == "online" else -(-FRAMES // CHUNK))


def _recorders(monkeypatch, driver):
    """Keep every detection batch and every chunk's outputs the driver
    produces (the wrapped functions do the counting)."""
    dets, outs = [], []
    mod = {"segments": run, "group": multicam, "online": online}[driver]
    detect = mod.dispatch_detect

    def dispatch(*a):
        d = detect(*a)
        dets.append(d)
        return d
    monkeypatch.setattr(mod, "dispatch_detect", dispatch)
    if driver == "online":
        step = online._Session._device_step

        def device_step(self, *a):
            o = step(self, *a)
            outs.append(o[0])
            return o
        monkeypatch.setattr(online._Session, "_device_step", device_step)
    else:
        cls = run.SegmentPipeline if driver == "segments" else multicam.MultiCamPipeline
        chunk_step = cls.chunk_step

        def recorded(self, *a):
            o = chunk_step(self, *a)
            outs.append(o[1].to_numpy())
            return o
        monkeypatch.setattr(cls, "chunk_step", recorded)
    return dets, outs


@pytest.mark.parametrize("driver", DRIVERS)
def test_counters_are_exact(tmp_path, monkeypatch, driver):
    dets, outs = _recorders(monkeypatch, driver)
    _, _, _, got = _traced(driver, str(tmp_path))
    cams = 1 if driver == "segments" else CAMS
    assert got["frames_real"] == FRAMES * cams
    # 10 frames in chunks of 4: the last chunk repeats its last frame twice
    assert got["frames_pad"] == (0 if driver == "online" else 2 * cams)
    if driver == "online":
        det_valid = sum(int(d.valid.sum()) for d in dets)
        live = sum(int(o.valid.sum()) for o in outs)
    else:
        det_valid = sum(int(d.valid[:max(0, FRAMES - i * CHUNK) * cams].sum())
                        for i, d in enumerate(dets))
        live = int(np.concatenate([o.valid for o in outs])[:FRAMES].sum())
    assert got["det_valid"] == det_valid and det_valid > 0
    # the tiny preset births from every score: all valid detections count
    assert CFG.tracker.birth_score_threshold == 0.0 and got["det_birth"] == det_valid
    assert got["track_live"] == live and live > 0
    # the offline drivers are fed by the prefetcher, a chunk at a time
    prefetched = driver != "online"
    for name in ("prefetch_fill_s", "prefetch_chunks", "prefetch_ready"):
        assert (name in got) == prefetched, name
    assert got.get("prefetch_fill_s", 1.0) > 0
    assert got.get("prefetch_chunks", -(-FRAMES // CHUNK)) == -(-FRAMES // CHUNK)
    assert 0 <= got.get("prefetch_ready", 0) <= got.get("prefetch_chunks", 0)
    assert all(isinstance(got.get(n, 0), int) for n in ("prefetch_chunks", "prefetch_ready"))
    assert "graph_captures" not in got       # no CUDA graph on the CPU


@pytest.mark.parametrize("cams", [1, CAMS])
def test_online_warmup_is_not_counted(monkeypatch, cams):
    """``cli track --online --profile`` and ``serve --profile`` trace the
    warm-up too: its all-zero frames are no camera-frames."""
    dets, outs = _recorders(monkeypatch, "online")
    frames = _frames(cams)
    if cams == 1:
        sess = online.OnlineTracker(CFG, device="cpu")
        step = lambda t: sess.step(frames[0, t], 100000 * t)    # noqa: E731
    else:
        sess = online.OnlineMultiCamTracker(CFG, camera_names=[1, 2], device="cpu")
        step = lambda t: sess.step(list(frames[:, t]), 100000 * t)  # noqa: E731
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        sess.warmup(HW)
        for t in range(FRAMES):
            step(t)
    got = profiling.counters()
    assert len(dets) == len(outs) == FRAMES + 1          # the warm-up's first
    assert got["frames_real"] == FRAMES * cams and got["frames_pad"] == 0
    assert got["det_valid"] == sum(int(d.valid.sum()) for d in dets[1:])
    assert got["track_live"] == sum(int(o.valid.sum()) for o in outs[1:])


@pytest.mark.parametrize("real", [None, 2])
def test_count_detections_takes_the_real_rows_and_the_birth_gate(real):
    from waymo_2d_tracking_tpu_torch.types import Detections
    scores = torch.tensor([[0.9, 0.7, 0.3, 0.0], [0.5, 0.6, 0.2, 0.8], [0.9, 0.9, 0.9, 0.9]])
    valid = torch.tensor([[True, True, True, False], [True, True, False, True],
                          [True, True, True, True]])
    dets = Detections(boxes=torch.zeros(3, 4, 4), scores=scores,
                      classes=torch.zeros(3, 4, dtype=torch.int32),
                      embeds=torch.zeros(3, 4, 1), valid=valid)
    profiling.reset_counters()
    run.count_detections(dets, real, 0.6)             # no profiler: nothing
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        run.count_detections(dets, real, 0.6)
    want = {None: (10, 8), 2: (6, 4)}[real]           # (valid, at or above 0.6)
    assert profiling.counters() == {"det_valid": want[0], "det_birth": want[1]}


@pytest.mark.parametrize("driver", DRIVERS)
def test_untraced_enters_no_span_and_writes_the_traced_bytes(tmp_path, monkeypatch, driver):
    profiling.reset_counters()

    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.autograd.profiler, "record_function", refuse)
        files, state = _drive(driver, str(tmp_path / "off"))
    assert profiling.counters() == {}
    traced_files, traced_state, spans, _ = _traced(driver, str(tmp_path / "on"))
    assert spans and files and files == traced_files
    if state is not None:
        for f in state.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(state, f), getattr(traced_state, f))


def test_trace_dir_writes_the_counters_beside_the_chrome_trace(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("stale", 1)
    out = tmp_path / "tr"
    with profiling.trace(str(out)):
        _drive("segments", str(tmp_path / "run"))
    names = sorted(os.listdir(out))
    assert len(names) == 2 and names[0].startswith("counters-") and names[1].startswith("trace-")
    assert names[0][len("counters-"):] == names[1][len("trace-"):]
    counts = json.load(open(out / names[0]))
    assert "stale" not in counts                     # emptied on entry
    assert counts["frames_real"] == FRAMES and counts["frames_pad"] == 2
    assert counts == profiling.counters()
    assert '"w2t/segment"' in open(out / names[1]).read()


def test_counter_registry():
    profiling.reset_counters()
    profiling.count("n", 2)                          # no profiler: nothing
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.tracing()
        profiling.count("n", 2)
        profiling.count("n", torch.tensor([True, True, False]).sum())
        profiling.count("s", 0.25)
        profiling.count("s", torch.tensor(0.5))
        with profiling.span("x"):
            pass
    got = profiling.counters()
    assert got == {"n": 4, "s": 0.75} and isinstance(got["n"], int)
    profiling.reset_counters()
    assert profiling.counters() == {} and not profiling.tracing()
