"""The tracker's own stream (``tracker/graph.py``: ``track_chunk`` on a lane,
``ChunkDone``, ``to_host``, ``join``).

On the CPU ``track_chunk`` is the eager ``track_segment``: no lane, no
event, no ``track_*`` counter, and the drivers' fetches are plain copies. On
the card (``card`` tests, skipped here) a rig's group tracked on the lane,
with its chunks' tracker work held back so that the next chunk's staging
and forward are queued beside it, and with the caller's freed blocks
refilled on the driver's stream after every chunk, writes the JSONL bytes
and sidecar arrays and ends in the state that the same detections give
when tracked a chunk at a time with a device synchronize after each; and
the overlap counters read above 0. Run on the card:

    python -m pytest --noconftest -p no:cacheprovider -q -m card tests/test_torch_track_stream.py
"""
import dataclasses
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
from waymo_2d_tracking_tpu_torch.pipeline import multicam
from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames
from waymo_2d_tracking_tpu_torch.tracker import init_multicam_state, init_state, track_segment
from waymo_2d_tracking_tpu_torch.tracker.graph import (
    chunk_done,
    clone_record,
    join,
    to_host,
    track_chunk,
)
from waymo_2d_tracking_tpu_torch.types import Detections
from waymo_2d_tracking_tpu_torch.utils import profiling

torch.set_num_threads(1)

CAMS, CHUNK, FRAMES, HW = 2, 4, 13, (64, 96)      # 4 chunks, the last padded
# 100 ms of a 1.98 GHz SM clock: a chunk's tracker is held back long enough
# for the host to queue the next chunk's staging and forward beside it
HOLD_CYCLES = 200_000_000


def _cfg() -> Config:
    return Config(
        detector=DetectorConfig(backbone="resnet18slim", image_size=HW, fpn_channels=64,
                                head_depth=1, pre_nms_topk=32, max_detections=8, embed_dim=8,
                                dtype="float32", score_threshold=0.01),
        tracker=TrackerConfig(max_tracks=16, max_detections=8, embed_dim=8,
                              appearance_weight=0.2, score_threshold=0.0,
                              birth_score_threshold=0.0, n_init=1),
        pipeline=PipelineConfig(chunk_frames=CHUNK, interp_max_gap=1))


def _segments(context: str):
    rng = np.random.default_rng(23)
    frames = rng.integers(0, 255, (CAMS, FRAMES) + HW + (3,), dtype=np.uint8)
    ts = [100_000 * t for t in range(FRAMES)]
    return [SegmentFrames(context, c + 1, ts, frames[c]) for c in range(CAMS)]


def _dets(frames: int, seed: int) -> Detections:
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand((frames, 8, 2), generator=g) * 80
    return Detections(boxes=torch.cat([xy, xy + 8 + 16 * torch.rand((frames, 8, 2), generator=g)],
                                      -1),
                      scores=torch.rand((frames, 8), generator=g),
                      classes=torch.zeros((frames, 8), dtype=torch.int32),
                      embeds=torch.nn.functional.normalize(torch.randn((frames, 8, 8),
                                                                       generator=g), dim=-1),
                      valid=torch.rand((frames, 8), generator=g) > 0.3)


def _fields_equal(a, b, what):
    for f in dataclasses.fields(a):
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what}.{f.name}"
        np.testing.assert_array_equal(x, y, err_msg=f"{what}.{f.name}")


def _read_dir(path):
    """{file: its bytes (JSONL) or its arrays (gallery sidecars, whose zip
    entries carry the time they were written)}."""
    out = {}
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if name.endswith(".npz"):
            with np.load(full) as z:
                out[name] = {k: z[k] for k in z.files}
        else:
            with open(full, "rb") as f:
                out[name] = f.read()
    return out


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_track_chunk_on_the_cpu_is_eager_and_counts_nothing(traced):
    """The CPU path is ``track_segment`` as it was: the same state and
    outputs, nothing added to the cache, no ``track_*`` counter even while
    a profiler records."""
    cfg = _cfg().tracker
    dets = _dets(6, 1)
    graphs = {}
    profiling.reset_counters()
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            got = track_chunk(init_state(cfg, device="cpu"), dets, cfg, graphs)
    else:
        got = track_chunk(init_state(cfg, device="cpu"), dets, cfg, graphs)
    want = track_segment(init_state(cfg, device="cpu"), dets, cfg)
    _fields_equal(got[0].to_numpy(), want[0].to_numpy(), "state")
    _fields_equal(got[1].to_numpy(), want[1].to_numpy(), "outputs")
    assert graphs == {}
    assert not [k for k in profiling.counters() if k.startswith("track_")]


def test_cpu_fetch_is_the_plain_copy():
    """On the CPU there is no chunk event: ``to_host`` is ``to_numpy`` and
    ``join`` does nothing."""
    cfg = _cfg().tracker
    graphs = {}
    state, outs = track_chunk(init_state(cfg, device="cpu"), _dets(3, 2), cfg, graphs)
    assert chunk_done(graphs, "cpu") is None
    join(graphs, "cpu")
    _fields_equal(to_host(outs, None), outs.to_numpy(), "outputs")
    _fields_equal(to_host(state, chunk_done(graphs, "cpu")), state.to_numpy(), "state")


def test_cpu_group_counts_no_tracker_stream(tmp_path):
    """A rig's group on the CPU, traced: the drivers' counters are there,
    the tracker stream's are not, and the group writes a track file a
    camera."""
    pipe = multicam.MultiCamPipeline(_cfg(), num_cams=CAMS, device="cpu")
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.run_segments_group(_segments("cpu"), str(tmp_path))
    c = profiling.counters()
    assert c["frames_real"] == FRAMES * CAMS
    assert not [k for k in c if k.startswith("track_") and k != "track_live"]
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"cpu_{c}{ext}" for c in range(1, CAMS + 1) for ext in (".jsonl", ".gallery.npz"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


@pytest.mark.card
def test_card_lane_equals_chunks_tracked_one_at_a_time(tmp_path, monkeypatch, card):
    from benchmark.harness import spec

    pipe = multicam.MultiCamPipeline(_cfg(), num_cams=CAMS, device=card)
    pipe.run_segments_group(_segments("warm"), str(tmp_path / "warm"))   # kernels, graph
    torch.cuda.synchronize(card)

    real_track, real_step = multicam.track_chunk, multicam.MultiCamPipeline.chunk_step
    main = torch.cuda.current_stream(card)
    hold = torch.cuda.Stream(device=card)
    seen, states = [], []

    def held_track(st, dets, cfg, graphs):
        """The seam, its chunk held back: the lane waits on the caller's
        current stream, here one whose last work is a sleep, so the next
        chunk's staging and forward are queued while this one waits."""
        seen.append(clone_record(dets))
        hold.wait_stream(main)
        with torch.cuda.stream(hold):
            torch.cuda._sleep(HOLD_CYCLES)
            out = real_track(st, dets, cfg, graphs)
        states.append(out[0])
        return out

    def refilling_step(self, st, frames, *a):
        """After each chunk, fresh tensors of the detections' sizes filled
        on the driver's stream take back the blocks the chunk freed."""
        out = real_step(self, st, frames, *a)
        junk = [torch.full_like(getattr(seen[-1], f.name), 7)
                for f in dataclasses.fields(Detections) for _ in range(2)]
        del junk
        return out

    monkeypatch.setattr(multicam, "track_chunk", held_track)
    monkeypatch.setattr(multicam.MultiCamPipeline, "chunk_step", refilling_step)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.run_segments_group(_segments("lane"), str(tmp_path / "lane"))
        torch.cuda.synchronize(card)
    counts = profiling.counters()
    share = spec.reader({}, "track_overlap_share.segments").read(None)
    final = states[-1].to_numpy()
    n_chunks = -(-FRAMES // CHUNK)
    assert len(seen) == n_chunks and counts["track_chunks"] == n_chunks
    assert counts["track_overlapped"] >= 1 and share > 0, counts

    ref_graphs, ref_states = {}, []
    st = init_multicam_state(pipe.cfg, CAMS, device=card)

    def synchronized_track(st_in, dets, cfg, graphs):
        """The same detections, in order, tracked a chunk at a time on a
        cache of its own with a device synchronize after each."""
        nonlocal st
        st, out = real_track(st, seen[len(ref_states)], cfg, ref_graphs)
        torch.cuda.synchronize(card)
        ref_states.append(st)
        return st, out

    monkeypatch.setattr(multicam, "track_chunk", synchronized_track)
    monkeypatch.setattr(multicam.MultiCamPipeline, "chunk_step", real_step)
    pipe.run_segments_group(_segments("lane"), str(tmp_path / "ref"))
    torch.cuda.synchronize(card)
    assert len(ref_states) == n_chunks
    _fields_equal(final, ref_states[-1].to_numpy(), "final state")
    got, want = _read_dir(tmp_path / "lane"), _read_dir(tmp_path / "ref")
    assert sorted(got) == sorted(want) and len(got) == 2 * CAMS
    for name in got:
        if isinstance(got[name], dict):
            assert sorted(got[name]) == sorted(want[name]), name
            for k in got[name]:
                np.testing.assert_array_equal(got[name][k], want[name][k], err_msg=name)
        else:
            assert got[name] == want[name], name
