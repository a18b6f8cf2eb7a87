"""The port's ``DevicePrefetcher`` on the CPU (``device="cpu"``), with the
cases of ``tests/unit/test_prefetch.py``: order with a slow consumer and with
a slow producer, the transform in the worker, an exception surfacing, empty
input, back-pressure, an early exit releasing the worker and the source, the
context manager, ``run_segment`` closing the prefetcher on a failing chunk,
and ``RollingFetch``'s window; a rig's chunk (a list of per-camera blocks)
gathered byte for byte as ``np.stack(blocks, axis=1)``, its
equal-resolution check, its sources closed in the worker's thread; the
counters ``prefetch_chunks`` and ``prefetch_ready``. The card's pinned ring
is held by ``chip_smoke.py``, and a ``card`` test runs a rig's group on it:

    python -m pytest --noconftest -p no:cacheprovider -q -m card tests/test_torch_prefetch.py
"""
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from waymo_2d_tracking_tpu_torch.data.prefetch import DevicePrefetcher, prefetch_to_device
from waymo_2d_tracking_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.mark.parametrize("depth", [1, 2])
def test_order_preserved_fast_producer_slow_consumer(depth):
    items = [np.full((4,), i, np.int32) for i in range(50)]
    out = []
    for x in prefetch_to_device(items, depth=depth, device="cpu"):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        time.sleep(0.002)  # slow consumer
        out.append(int(x[0]))
    assert out == list(range(50)), "chunks reordered or dropped"


def test_order_preserved_slow_producer():
    def produce():
        for i in range(20):
            time.sleep(0.002)
            yield np.full((2,), i, np.int32)

    out = [int(x[0]) for x in prefetch_to_device(produce(), depth=2, device="cpu")]
    assert out == list(range(20))


def test_transform_applied_in_worker():
    worker = []

    def double(i):
        worker.append(threading.current_thread() is not threading.main_thread())
        return np.int32(i * 2)

    out = [int(x) for x in prefetch_to_device(list(range(10)), depth=2, transform=double,
                                              device="cpu")]
    assert out == [2 * i for i in range(10)]
    assert worker and all(worker)


def test_producer_exception_propagates():
    def produce():
        yield np.zeros(2)
        raise RuntimeError("decode failed")

    it = prefetch_to_device(produce(), depth=2, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        list(it)


def test_empty_iterable():
    assert list(prefetch_to_device([], depth=2, device="cpu")) == []


def test_backpressure_bounded_queue():
    """The producer does not run arbitrarily ahead of the consumer."""
    produced = []

    def produce():
        for i in range(100):
            produced.append(i)
            yield np.int32(i)

    it = iter(DevicePrefetcher(produce(), depth=2, device="cpu"))
    next(it)
    time.sleep(0.1)  # time for the worker to run ahead if unbounded
    # depth 2 queue + 1 in flight + 1 consumed -> far less than 100
    assert len(produced) <= 5, f"no backpressure: produced {len(produced)}"
    assert [int(x) for x in it] == list(range(1, 100))


def test_early_exit_consumer_releases_worker_and_source():
    closed = threading.Event()
    produced = []

    def produce():
        try:
            for i in range(1000):
                produced.append(i)
                yield np.full((2,), i, np.int32)
        finally:
            closed.set()

    pf = DevicePrefetcher(produce(), depth=2, device="cpu")
    it = iter(pf)
    assert int(next(it)[0]) == 0
    pf.close()     # the consumer stops early
    assert closed.wait(timeout=5.0), "the source generator's finally never ran"
    pf._thread.join(timeout=5.0)
    assert not pf._thread.is_alive(), "worker thread leaked"
    assert len(produced) < 1000, "the worker ran the whole stream after close"
    pf.close()  # idempotent


def test_context_manager_early_break():
    with DevicePrefetcher([np.int32(i) for i in range(100)], depth=2, device="cpu") as pf:
        for _ in pf:
            break
    assert not pf._thread.is_alive()


def test_arrays_become_contiguous_tensors():
    strided = np.arange(6, dtype=np.uint8).reshape(2, 3)[:, ::2]
    (got,) = list(prefetch_to_device([strided], depth=1, device="cpu"))
    assert got.dtype == torch.uint8 and got.is_contiguous() and got.tolist() == [[0, 2], [3, 5]]


def test_run_segment_closes_prefetcher_on_chunk_error(monkeypatch):
    """A failing chunk inside ``run_segment``'s loop leaks neither the worker
    thread nor the chunk iterator."""
    from waymo_2d_tracking_tpu_torch.config import (
        Config, DetectorConfig, PipelineConfig, TrackerConfig,
    )
    from waymo_2d_tracking_tpu_torch.pipeline import run as run_mod

    cfg = Config(
        detector=DetectorConfig(
            backbone="resnet18slim", image_size=(64, 96), fpn_channels=32,
            head_depth=1, pre_nms_topk=32, max_detections=8, embed_dim=0,
            dtype="float32", score_threshold=0.01,
        ),
        tracker=TrackerConfig(max_tracks=16, max_detections=8, embed_dim=0, n_init=1),
        pipeline=PipelineConfig(chunk_frames=2),
    )
    pipe = run_mod.SegmentPipeline(cfg, device="cpu")

    def boom(*a, **k):
        raise RuntimeError("chunk step failed")

    monkeypatch.setattr(run_mod, "track_chunk", boom)
    closed = threading.Event()

    class Frames(run_mod.SegmentFrames):
        def chunk_iter(self, chunk, scale_denom=1, device="cpu"):
            try:
                yield from super().chunk_iter(chunk, scale_denom, device)
            finally:
                closed.set()

    rng = np.random.default_rng(0)
    seg = Frames("c", 1, [1000 * i for i in range(8)],
                 rng.integers(0, 255, (8, 72, 104, 3), dtype=np.uint8))
    n_before = threading.active_count()
    with pytest.raises(RuntimeError, match="chunk step failed"):
        pipe.run_segment(seg)
    assert closed.wait(timeout=5.0), "the chunk iterator was not closed"
    time.sleep(0.3)
    assert threading.active_count() <= n_before, "prefetch worker leaked"


def test_rolling_fetch_bounds_in_flight_window():
    """``RollingFetch`` keeps at most ``depth`` chunks on the device (the
    oldest is fetched when the window fills); ``finish`` returns every output
    in order, on the host."""
    from waymo_2d_tracking_tpu_torch.pipeline.run import RollingFetch
    from waymo_2d_tracking_tpu_torch.types import TrackOutputs

    def outputs(i):
        return TrackOutputs(track_id=torch.full((2,), i), boxes=torch.zeros(2, 4),
                            scores=torch.zeros(2), classes=torch.zeros(2, dtype=torch.int32),
                            valid=torch.ones(2, dtype=torch.bool))

    f = RollingFetch(depth=2)
    for i in range(7):
        f.push(outputs(i))
        assert len(f._dev) <= 2, "in-flight window exceeded depth"
        assert len(f._host) == max(i + 1 - 2, 0)
    out = f.finish()
    assert [int(o.track_id[0]) for o in out] == list(range(7))
    assert all(isinstance(o.track_id, np.ndarray) for o in out)


# a rig's chunk: a list of per-camera (chunk, H, W, 3) uint8 blocks
RIG_FRAMES, RIG_CHUNK, RIG_CAMS, RIG_HW = 10, 4, 3, (12, 20)


def _rig_segments(hws=None, cams=RIG_CAMS, frames=RIG_FRAMES, seed=5):
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames
    rng = np.random.default_rng(seed)
    stamps = [100000 * k for k in range(frames)]
    return [SegmentFrames("ctx", c + 1, stamps,
                          rng.integers(0, 255, (frames,) + (hws or [RIG_HW] * cams)[c] + (3,),
                                       dtype=np.uint8))
            for c in range(cams)]


@pytest.mark.parametrize("which", ["full", "padded"])
@pytest.mark.parametrize("kind", [list, tuple])
def test_rig_chunk_is_the_stack_of_its_cameras(which, kind):
    """chunk 0 is full; chunk 2 holds 2 real frames and chunk_iter's 2
    repeats of the last."""
    blocks = [list(s.chunk_iter(RIG_CHUNK))[0 if which == "full" else 2]
              for s in _rig_segments()]
    (got,) = list(prefetch_to_device([kind(blocks)], depth=1, device="cpu"))
    want = np.stack(blocks, axis=1)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    assert got.shape == want.shape == (RIG_CHUNK, RIG_CAMS) + RIG_HW + (3,)
    assert got.numpy().tobytes() == want.tobytes()
    if which == "padded":
        assert (want[2:] == want[1:2]).all()


@pytest.mark.parametrize("via", ["prefetcher", "driver"])
def test_rig_mixed_resolution_raises_on_the_consumer_side(tmp_path, via):
    segs = _rig_segments(hws=[RIG_HW, (16, 20), RIG_HW])
    msg = "equal-resolution cameras, got \\[\\(12, 20\\), \\(16, 20\\)\\]"
    if via == "prefetcher":
        items = [list(b) for b in zip(*(s.chunk_iter(RIG_CHUNK) for s in segs))]
        with pytest.raises(AssertionError, match=msg):
            list(prefetch_to_device(items, depth=2, device="cpu"))
    else:
        from waymo_2d_tracking_tpu_torch.pipeline.multicam import MultiCamPipeline
        pipe = MultiCamPipeline(_tiny_cfg(), num_cams=RIG_CAMS, device="cpu")
        with pytest.raises(AssertionError, match=msg):
            pipe.run_segments_group(segs, str(tmp_path))


@pytest.mark.parametrize("how", ["break", "raise"])
def test_rig_sources_close_in_the_workers_thread(how):
    """An early exit of the consumer, and an exception in one camera's
    source, close every camera's iterator, in the worker's own thread."""
    from waymo_2d_tracking_tpu_torch.pipeline.multicam import _rig_chunks
    closed = {}

    def camera(c):
        try:
            for i in range(1000):
                if how == "raise" and c == 1 and i == 3:
                    raise RuntimeError("camera 1 failed")
                yield np.full((2, 4, 6, 3), i, np.uint8)
        finally:
            closed[c] = threading.current_thread()

    pf = DevicePrefetcher(_rig_chunks([camera(c) for c in range(RIG_CAMS)]), depth=2,
                          device="cpu")
    with pf:
        if how == "break":
            for k, x in enumerate(pf):
                assert int(x[0, 0, 0, 0, 0]) == k
                if k == 1:
                    break
        else:
            with pytest.raises(RuntimeError, match="camera 1 failed"):
                list(pf)
    pf._thread.join(timeout=5.0)
    assert not pf._thread.is_alive(), "worker thread leaked"
    assert sorted(closed) == list(range(RIG_CAMS))
    assert all(t is pf._thread for t in closed.values()), "a source closed outside the worker"


@pytest.mark.parametrize("kind", ["array", "dict"])
def test_single_array_and_dict_items_keep_their_path(monkeypatch, kind):
    def no_gather(self, item):
        raise AssertionError("a single array or a dict took the rig's gather")
    monkeypatch.setattr(DevicePrefetcher, "_gather_to_device", no_gather)
    a = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    item = a if kind == "array" else {"images": a, "boxes": a[:, :1].astype(np.float32)}
    (got,) = list(prefetch_to_device([item], depth=1, device="cpu"))
    if kind == "array":
        assert isinstance(got, torch.Tensor) and got.numpy().tobytes() == a.tobytes()
    else:
        assert sorted(got) == ["boxes", "images"]
        for k, v in item.items():
            assert got[k].dtype == torch.from_numpy(v).dtype
            assert got[k].numpy().tobytes() == v.tobytes()


@pytest.mark.parametrize("producer", ["fast", "slow"])
def test_prefetch_counters_count_exactly(producer):
    """A fast producer keeps every chunk queued ahead of a slow consumer;
    a slow one makes the consumer wait for each. Counted only while a
    profiler records."""
    n = 6

    def produce():
        for i in range(n):
            if producer == "slow":
                time.sleep(0.2)
            yield [np.full((1, 2, 2, 3), i, np.uint8)] * 2

    profiling.reset_counters()
    got = []
    with profile(activities=[ProfilerActivity.CPU]):
        with DevicePrefetcher(produce(), depth=2, device="cpu") as pf:
            it = iter(pf)
            while True:
                if producer == "fast":
                    time.sleep(0.1)      # the worker queues the next chunk meanwhile
                x = next(it, None)
                if x is None:
                    break
                got.append(int(x[0, 1, 0, 0, 0]))
    assert got == list(range(n))
    c = profiling.counters()
    assert c["prefetch_chunks"] == n
    assert c["prefetch_ready"] == (n if producer == "fast" else 0)
    profiling.reset_counters()
    list(prefetch_to_device(produce(), depth=2, device="cpu"))    # no profiler
    assert profiling.counters() == {}


def _tiny_cfg():
    from waymo_2d_tracking_tpu_torch.config import (
        Config, DetectorConfig, PipelineConfig, TrackerConfig,
    )
    return Config(
        detector=DetectorConfig(backbone="resnet18slim", image_size=(64, 96), fpn_channels=32,
                                head_depth=1, pre_nms_topk=32, max_detections=8, embed_dim=8,
                                dtype="float32", score_threshold=0.01),
        tracker=TrackerConfig(max_tracks=16, max_detections=8, embed_dim=8, score_threshold=0.0,
                              birth_score_threshold=0.0, n_init=1),
        pipeline=PipelineConfig(chunk_frames=RIG_CHUNK, interp_max_gap=1))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


@pytest.mark.card
def test_card_group_crosses_pinned_and_matches_the_stacked_path(tmp_path, monkeypatch, card):
    """On the card a rig's group stages through the pinned ring: under the
    profiler every chunk crosses from pinned memory, and no host-to-device
    copy of a camera-frame or more reads pageable memory (the letterbox's
    12-byte mean and std still do). Every chunk step receives the CPU
    prefetcher's bytes, and returns what the clip method (its cameras
    stacked on the host) returns for the same frames."""
    from waymo_2d_tracking_tpu_torch.pipeline import multicam
    segs = _rig_segments(hws=[(72, 104)] * RIG_CAMS)
    pipe = multicam.MultiCamPipeline(_tiny_cfg(), num_cams=RIG_CAMS, device=card)
    seen = []
    step = multicam.MultiCamPipeline.chunk_step

    def recorded(self, states, frames, *a):
        out = step(self, states, frames, *a)
        seen.append((torch.as_tensor(frames).cpu().numpy().copy(), out[1].to_numpy()))
        return out
    monkeypatch.setattr(multicam.MultiCamPipeline, "chunk_step", recorded)
    pipe.run_segments_group(segs, str(tmp_path / "warm"))        # builds the graphs
    seen.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.run_segments_group(segs, str(tmp_path / "traced"))
        torch.cuda.synchronize(card)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        copies = [(e["name"], e["args"]["bytes"]) for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "gpu_memcpy" and e["name"].startswith("Memcpy HtoD")]
    frame = 72 * 104 * 3
    assert [b for n, b in copies if "Pinned" in n and b >= frame] == \
        [RIG_CHUNK * RIG_CAMS * frame] * -(-RIG_FRAMES // RIG_CHUNK), copies
    assert all(b < frame for n, b in copies if "Pageable" in n), copies
    group = seen[:]
    seen.clear()
    pipe.run(np.stack([s.frames for s in segs], axis=1))
    cpu = list(prefetch_to_device(multicam._rig_chunks(
        [s.chunk_iter(RIG_CHUNK) for s in segs]), depth=2, device="cpu"))
    assert len(group) == len(seen) == len(cpu) == -(-RIG_FRAMES // RIG_CHUNK)
    for (frames, out), (clip_frames, clip_out), host in zip(group, seen, cpu):
        assert frames.tobytes() == host.numpy().tobytes() == clip_frames.tobytes()
        for f in out.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(out, f), getattr(clip_out, f))
