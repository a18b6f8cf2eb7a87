"""The port's ``DevicePrefetcher`` on the CPU (``device="cpu"``), with the
cases of ``tests/unit/test_prefetch.py``: order with a slow consumer and with
a slow producer, the transform in the worker, an exception surfacing, empty
input, back-pressure, an early exit releasing the worker and the source, the
context manager, ``run_segment`` closing the prefetcher on a failing chunk,
and ``RollingFetch``'s window. The card's pinned ring is held by
``chip_smoke.py``."""
import threading
import time

import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu_torch.data.prefetch import DevicePrefetcher, prefetch_to_device

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
        def chunk_iter(self, chunk, scale_denom=1):
            try:
                yield from super().chunk_iter(chunk, scale_denom)
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
