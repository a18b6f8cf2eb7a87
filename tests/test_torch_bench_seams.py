"""The seams the benchmark wraps in the program.

``benchmark/traffic/segments.py`` and ``benchmark/traffic/live.py`` (their
``setup``) hand the names below to ``benchmark/harness/probe.py``, which
replaces each, by name, with itself inside a layer's range: the module
functions of the drivers, the online session's ``_track`` and the
detector runner's ``forward`` and ``postprocess``. The per-layer metrics
read those ranges. So each name must stay an attribute of its owner (the
probe's ``getattr`` raises inside the benchmark's set-up otherwise), and the
staging, detect, track and records seams must be what the driver that owns
them calls, looked up by name at the call: one tiny CPU run of each driver
(``run_segments`` at ``decode_scale_denom`` 2, ``run_segments_group`` with
2 cameras, one step of each online session, ReID on so the sidecars are
written) records the calls through every seam. ``multicam.area_downscale``
runs only on the card, where the frames cross at source size, so for it
only the name is held.
"""
import collections

import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu_torch.config import (
    Config,
    DetectorConfig,
    PipelineConfig,
    TrackerConfig,
)
from waymo_2d_tracking_tpu_torch.io_out import submission
from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
from waymo_2d_tracking_tpu_torch.pipeline import link, multicam, online
from waymo_2d_tracking_tpu_torch.pipeline import run as run_mod

torch.set_num_threads(1)

MODULES = {"run": run_mod, "multicam": multicam, "link": link, "submission": submission,
           "online": online}
SESSIONS = (online.OnlineTracker, online.OnlineMultiCamTracker)

# (owner, name, the drivers whose run must call it)
SEAMS = [
    ("run", "area_downscale", ("segments",)),
    ("run", "letterbox_batch", ("segments",)),
    ("run", "track_chunk", ("segments",)),
    ("multicam", "area_downscale", ()),
    ("multicam", "letterbox_batch", ("group",)),
    ("multicam", "track_chunk", ("group",)),
    ("multicam", "write_gallery_sidecar", ("group",)),
    ("link", "write_gallery_sidecar", ("segments",)),
    ("submission", "records_from_track_outputs", ("segments", "group", "online")),
    ("submission", "write_jsonl", ("segments", "group")),
    ("online", "letterbox_batch", ("online",)),
    ("session", "_track", ("online",)),
    ("runner", "forward", ("segments", "group", "online")),
    ("runner", "postprocess", ("segments", "group", "online")),
]

TINY = dict(
    detector=dict(backbone="resnet18slim", image_size=(64, 96), fpn_channels=64,
                  head_depth=1, pre_nms_topk=32, max_detections=8, embed_dim=8,
                  dtype="float32", score_threshold=0.01),
    tracker=dict(max_tracks=16, max_detections=8, embed_dim=8, appearance_weight=0.2,
                 score_threshold=0.0, birth_score_threshold=0.0, n_init=1),
)


def _cfg(denom: int = 1) -> Config:
    return Config(detector=DetectorConfig(**TINY["detector"]),
                  tracker=TrackerConfig(**TINY["tracker"]),
                  pipeline=PipelineConfig(chunk_frames=4, decode_scale_denom=denom))


def _frames(t, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (t, h, w, 3), dtype=np.uint8)


def _record(mp, owner, name, key, calls):
    """Replace ``owner.name`` by itself, counting its calls under ``key``, as
    the probe replaces it by itself inside a range."""
    fn = getattr(owner, name)

    def counted(*args, **kwargs):
        calls[key] += 1
        return fn(*args, **kwargs)

    mp.setattr(owner, name, counted)


def _record_modules(mp, calls):
    for owner, name, _ in SEAMS:
        if owner in MODULES:
            _record(mp, MODULES[owner], name, f"{owner}.{name}", calls)


def _record_runner(mp, runner, calls):
    for name in ("forward", "postprocess"):
        _record(mp, runner, name, f"runner.{name}", calls)


@pytest.fixture(scope="module")
def driver_calls(tmp_path_factory):
    """{driver: Counter of the seams its tiny run called}."""
    out = {}
    ts = list(range(5))                         # chunk 4: the second chunk is padded

    calls = collections.Counter()
    pipe = run_mod.SegmentPipeline(_cfg(denom=2), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        _record_modules(mp, calls)
        _record_runner(mp, pipe.detector, calls)
        run_mod.run_segments(pipe, [run_mod.SegmentFrames("seam", 1, ts, _frames(5, 128, 192))],
                             str(tmp_path_factory.mktemp("segments")))
    out["segments"] = calls

    calls = collections.Counter()
    rig = multicam.MultiCamPipeline(_cfg(), num_cams=2, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        _record_modules(mp, calls)
        _record_runner(mp, rig.detector, calls)
        rig.run_segments_group([run_mod.SegmentFrames("seam", c, ts, _frames(5, 64, 96, c))
                                for c in (1, 2)], str(tmp_path_factory.mktemp("group")))
    out["group"] = calls

    calls = collections.Counter()
    sessions = (online.OnlineTracker(_cfg(), device="cpu"),
                online.OnlineMultiCamTracker(_cfg(), camera_names=[1, 2], device="cpu"))
    with pytest.MonkeyPatch.context() as mp:
        _record_modules(mp, calls)
        for sess in sessions:
            _record_runner(mp, sess.detector, calls)
            _record(mp, sess, "_track", "session._track", calls)
        sessions[0].step(_frames(1, 64, 96)[0], 0)
        sessions[1].step(list(_frames(2, 64, 96)), 0)
    for sess in sessions:
        sess.close()
    out["online"] = calls
    return out


@pytest.mark.parametrize("owner,name,drivers", SEAMS,
                         ids=[f"{owner}.{name}" for owner, name, _ in SEAMS])
def test_probe_seam_is_kept(owner, name, drivers, driver_calls):
    if owner == "session":
        assert all(callable(getattr(cls, name, None)) for cls in SESSIONS)
    elif owner == "runner":
        assert callable(getattr(DetectorRunner, name, None))
    else:
        assert callable(getattr(MODULES[owner], name, None))
    for driver in drivers:
        assert driver_calls[driver][f"{owner}.{name}"] > 0, (driver, dict(driver_calls[driver]))
