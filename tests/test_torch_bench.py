"""The benchmark path of the port on the CPU: ``SegmentPipeline.chunk_step``
against the JAX package's ``_chunk_step`` on two chunks (the trained pixel
detector of ``tests/test_torch_pipeline.py``, its weights carried across by
``weights.from_flax_numpy``), the three ``pipeline/bench_e2e.py`` rows at a
tiny size with ``device="cpu"`` (the JAX metric names and unit forms, and the
last timed outputs equal to ``run_segment`` on the same frames), the
harness's rows and flags against the root ``bench.py``'s, its one-line JSON
contract (``tests/integration/test_bench_contract.py``) and its refusal to run
without a card unless given ``--device cpu``."""
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu_torch import bench
from waymo_2d_tracking_tpu_torch.config import (
    Config,
    DetectorConfig,
    PipelineConfig,
    TrackerConfig,
)
from waymo_2d_tracking_tpu_torch.io_out import submission as subm
from waymo_2d_tracking_tpu_torch.pipeline import bench_e2e
from waymo_2d_tracking_tpu_torch.pipeline.multicam import MultiCamPipeline
from waymo_2d_tracking_tpu_torch.pipeline.online import _Session
from waymo_2d_tracking_tpu_torch.pipeline.run import (
    SegmentFrames,
    SegmentPipeline,
    concat_host,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_torch_pipeline.py's detector and tracker (the trained pixel fixture)
PIX_DET = dict(
    backbone="resnet18slim", image_size=(256, 384), fpn_channels=32,
    fpn_levels=(3, 4, 5), head_depth=2, head_channels=32,
    pre_nms_topk=128, nms_topk=256, max_detections=32, embed_dim=0,
    dtype="float32", score_threshold=0.3,
)
PIX_TRK = dict(
    max_tracks=32, max_detections=32, embed_dim=0,
    n_init=2, max_age=5, iou_threshold=0.3,
    score_threshold=0.55, birth_score_threshold=0.65, birth_iou_threshold=0.3,
)

# a tiny config whose random weights still birth tracks (tests/test_torch_sharded.py)
TINY = Config(
    detector=DetectorConfig(backbone="resnet18slim", image_size=(64, 96), fpn_channels=64,
                            head_depth=1, pre_nms_topk=32, max_detections=8, embed_dim=8,
                            dtype="float32", score_threshold=0.01),
    tracker=TrackerConfig(max_tracks=16, max_detections=8, embed_dim=8, appearance_weight=0.2,
                          score_threshold=0.0, birth_score_threshold=0.0, n_init=1),
    pipeline=PipelineConfig(chunk_frames=4),
)
UNIT_LATENCY = re.compile(
    r"ms/(frame|rig tick \(\d+ cams\)) \(device step incl\. dispatch; n=\d+, "
    r"p90=\d+\.\d{3}, p99=\d+\.\d{3}, max=\d+\.\d{3}; "
    r"vs_baseline = 10Hz-camera real-time margin, 100ms/p50\)")


def test_chunk_step_matches_jax_chunk_step():
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from waymo_2d_tracking_tpu.config import (
        Config as JaxConfig,
        DetectorConfig as JaxDetectorConfig,
        PipelineConfig as JaxPipelineConfig,
        TrackerConfig as JaxTrackerConfig,
    )
    from waymo_2d_tracking_tpu.models.detector import DetectorRunner as JaxRunner
    from waymo_2d_tracking_tpu.pipeline.run import SegmentPipeline as JaxPipeline
    from waymo_2d_tracking_tpu.tracker import init_state as jax_init_state

    from waymo_2d_tracking_tpu_torch.data.synthetic import SyntheticClipConfig, render_video_clip
    from waymo_2d_tracking_tpu_torch.tracker import init_state
    from waymo_2d_tracking_tpu_torch.weights import from_flax_numpy

    chunk = 4
    frames, _ = render_video_clip(SyntheticClipConfig(num_frames=2 * chunk, num_objects=8,
                                                      image_size=(1024, 1536), seed=5))
    src_hw = tuple(frames.shape[1:3])
    jdet = JaxDetectorConfig(**PIX_DET)
    template = JaxRunner(jdet).init_params(jax.random.PRNGKey(0), batch_size=1)
    with open(os.path.join(ROOT, "tests", "fixtures", "pixels_detector.msgpack"), "rb") as f:
        variables = serialization.from_bytes(template, f.read())
    jcfg = JaxConfig(detector=jdet, tracker=JaxTrackerConfig(**PIX_TRK),
                     pipeline=JaxPipelineConfig(chunk_frames=chunk))
    jpipe = JaxPipeline(jcfg, params=variables)
    jstate, want = jax_init_state(jcfg.tracker), []
    for start in (0, chunk):
        jstate, jout, jscale = jpipe._chunk_step(jpipe.params, jstate,
                                                 jnp.asarray(frames[start:start + chunk]),
                                                 src_hw=src_hw)
        want.append((jax.tree.map(np.asarray, jout), float(jscale)))
    state_dict = from_flax_numpy(jax.tree.map(np.asarray, variables))

    # denom 2: frames twice the size, downscaled on the device by chunk_step
    # (the area downscale of a 2x nearest upscale gives the frames back)
    for sd in (1, 2):
        cfg = Config(detector=DetectorConfig(**PIX_DET), tracker=TrackerConfig(**PIX_TRK),
                     pipeline=PipelineConfig(chunk_frames=chunk, decode_scale_denom=sd))
        pipe = SegmentPipeline(cfg, state_dict, device="cpu")
        big = frames.repeat(sd, axis=1).repeat(sd, axis=2)
        state, n_valid = init_state(cfg.tracker, device="cpu"), 0
        for k, (jout, jscale) in enumerate(want):
            block = torch.from_numpy(big[k * chunk:(k + 1) * chunk])
            state, out, scale = pipe.chunk_step(state, block, src_hw)
            assert float(scale) == pytest.approx(jscale, rel=1e-6)
            valid = jout.valid
            np.testing.assert_array_equal(out.valid.numpy(), valid)
            np.testing.assert_array_equal(out.track_id.numpy()[valid], jout.track_id[valid])
            np.testing.assert_array_equal(out.classes.numpy()[valid], jout.classes[valid])
            np.testing.assert_allclose(out.boxes.numpy()[valid], jout.boxes[valid], atol=0.2)
            np.testing.assert_allclose(out.scores.numpy()[valid], jout.scores[valid], atol=1e-4)
            n_valid += int(valid.sum())
        assert n_valid > chunk      # tracks are confirmed and reported


def _recorder(monkeypatch, cls, name):
    """Wrap ``cls.name`` to keep what each call returns."""
    calls = []
    fn = getattr(cls, name)

    def wrapped(self, *args):
        out = fn(self, *args)
        calls.append(out)
        return out

    monkeypatch.setattr(cls, name, wrapped)
    return calls


def _segment_records(frames, scale, outputs, cam=1):
    """Records of one camera's outputs (numpy, leading axis T), as
    ``run_segment`` writes them."""
    stacked = concat_host(outputs, frames.shape[0])
    ts = list(range(frames.shape[0]))
    return subm.records_from_track_outputs(stacked, "bench", ts, cam, scale=float(scale),
                                           interp_max_gap=TINY.pipeline.interp_max_gap)


def _run_segment(frames, cam=1):
    pipe = SegmentPipeline(TINY, device="cpu", seed=0)
    records, _ = pipe.run_segment(SegmentFrames("bench", cam, list(range(frames.shape[0])),
                                                frames))
    assert records
    return records


def _close_records(got, want):
    """Equal records but for boxes within 0.2 and scores within 1e-4: the
    online step's detector batch is one frame (a rig tick's cameras), the
    chunk's is four, and the CPU's convolutions round by batch size."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        for k in ("center_x", "center_y", "length", "width"):
            assert abs(g.pop(k) - w.pop(k)) <= 0.2, k
        assert abs(g.pop("score") - w.pop("score")) <= 1e-4
        assert g == w


def _frames(shape):
    return np.random.default_rng(0).integers(0, 255, shape, dtype=np.uint8)


def test_detect_track_row_and_its_last_outputs(monkeypatch):
    calls = _recorder(monkeypatch, SegmentPipeline, "chunk_step")
    n, hw = 6, TINY.detector.image_size
    row = bench_e2e.run_detect_track_bench(num_frames=n, repeats=2, config=TINY, device="cpu")
    assert set(row) == {"metric", "value", "unit", "vs_baseline"}
    assert row["metric"] == "detect_track_frames_per_sec_per_chip"
    assert row["unit"] == "frames/sec/chip"
    assert row["value"] > 0 and row["vs_baseline"] == round(row["value"] / 1500.0, 3)
    # two warm-up blocks (4 frames and the trailing 2), then 3 groups of 2 passes
    assert [tuple(c[1].valid.shape) for c in calls[:2]] == [(4, 16), (2, 16)]
    assert len(calls) == 2 + 3 * 2 * 2
    last = calls[-2:]
    got = _segment_records(_frames((n,) + hw + (3,)), last[-1][2],
                           [c[1].to_numpy() for c in last])
    assert got == _run_segment(_frames((n,) + hw + (3,)))


@pytest.mark.parametrize("multicam", [False, True])
def test_online_latency_row_and_its_outputs(monkeypatch, multicam):
    calls = _recorder(monkeypatch, _Session, "_device_step")
    n, cams, hw = 5, 2, TINY.detector.image_size
    row = bench_e2e.run_online_latency_bench(num_frames=n, config=TINY, multicam=multicam,
                                             num_cams=cams, device="cpu")
    assert set(row) == {"metric", "value", "unit", "vs_baseline"}
    assert row["metric"] == ("online_multicam_serving_latency_p50_ms" if multicam
                             else "online_serving_latency_p50_ms")
    assert UNIT_LATENCY.fullmatch(row["unit"]), row["unit"]
    assert (f"rig tick ({cams} cams)" in row["unit"]) == multicam
    assert row["value"] > 0 and row["vs_baseline"] == round(100.0 / row["value"], 3)
    timed = calls[-n:]          # after the warm-up step
    assert len(calls) == n + 1
    lead = (n, cams) if multicam else (n,)
    frames = _frames(lead + hw + (3,))
    for cam in range(cams if multicam else 1):
        cam_frames = frames[:, cam] if multicam else frames
        outs = [type(o)(**{f.name: getattr(o, f.name)[cam:cam + 1] if multicam
                           else getattr(o, f.name)[None] for f in dataclasses.fields(o)})
                for o, _ in timed]
        got = _segment_records(cam_frames, timed[-1][1], outs, cam + 1)
        _close_records(got, _run_segment(np.ascontiguousarray(cam_frames), cam + 1))


def test_multicam_row_and_its_last_outputs(monkeypatch):
    calls = _recorder(monkeypatch, MultiCamPipeline, "chunk_step")
    monkeypatch.setattr(bench_e2e, "preset_config", lambda preset: TINY)
    n, cams, hw = 8, 2, TINY.detector.image_size
    row = bench_e2e.run_multicam_bench(num_frames=n, repeats=1, num_cams=cams, chunk=4,
                                       preset="production", device="cpu")
    assert set(row) == {"metric", "value", "unit", "vs_baseline"}
    assert row["metric"] == "detect_track_multicam_camframes_per_sec_per_chip"
    assert row["unit"] == "camera-frames/sec/chip" and row["value"] > 0
    assert len(calls) == 1 + 3 * 2
    frames = _frames((n, cams) + hw + (3,))
    for cam in range(cams):
        outs = [type(o)(**{f.name: getattr(o, f.name)[:, cam].numpy()
                           for f in dataclasses.fields(o)}) for _, o, _ in calls[-2:]]
        got = _segment_records(frames[:, cam], calls[-1][2], outs, cam + 1)
        assert got == _run_segment(np.ascontiguousarray(frames[:, cam]), cam + 1)
    assert bench_e2e.run_multicam_bench(num_frames=4, repeats=1, num_cams=cams, chunk=4,
                                        preset="headline", device="cpu")["metric"] == \
        "detect_track_multicam_headline_camframes_per_sec_per_chip"


# root bench.py's rows: (flags, the port function and its arguments)
ROWS = [
    ([], "detect", dict(src_hw=(640, 960), metric="detect_track_frames_per_sec_per_chip")),
    (["--src-full"], "detect",
     dict(src_hw=(1280, 1920), metric="detect_track_frames_per_sec_per_chip")),
    (["--src-net"], "detect", dict(src_hw=None, metric="detect_track_frames_per_sec_per_chip")),
    (["--fast"], "detect", dict(preset="fast")),
    (["--production"], "detect", dict(preset="production")),
    (["--int8"], "detect", dict(preset="headline_int8", src_hw=(640, 960))),
    (["--config1"], "tracker", dict(num_frames=200, repeats=20)),
    (["--config4"], "multicam", dict(num_frames=64, chunk=16, preset="production",
                                     src_hw=(640, 960))),
    (["--config4", "--headline"], "multicam", dict(num_frames=64, chunk=16, preset="headline",
                                                   src_hw=(640, 960))),
    (["--config4", "--int8"], "multicam", dict(num_frames=64, chunk=16,
                                               preset="headline_int8", src_hw=(640, 960))),
    (["--config5"], "tta", {}),
    (["--host"], "host", {}),
    (["--latency"], "latency", dict(multicam=False)),
    (["--latency", "--multicam"], "latency", dict(multicam=True)),
]


@pytest.mark.parametrize("flags,which,kwargs", ROWS,
                         ids=[" ".join(r[0]) or "default" for r in ROWS])
def test_harness_rows_follow_the_jax_flags(monkeypatch, flags, which, kwargs):
    seen = []

    def fake(name):
        def fn(*args, **kw):
            seen.append((name, args, kw))
            return {"metric": name}
        return fn

    for name, attr in (("detect", "bench_detect_track"), ("tracker", "bench_tracker_only"),
                       ("tta", "bench_tta"), ("host", "bench_host_ingestion")):
        monkeypatch.setattr(bench, attr, fake(name))
    for name, attr in (("multicam", "run_multicam_bench"), ("latency", "run_online_latency_bench")):
        monkeypatch.setattr(bench_e2e, attr, fake(name))
    args = bench.build_parser().parse_args(flags + ["--device", "cpu"])
    assert bench.run_row(args) == {"metric": which}
    (name, pos, kw), = seen
    assert not pos
    kw.pop("device", None)
    assert kw == kwargs


def test_harness_prints_one_json_line():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    # the config-1 row over a 20-frame clip, 2 passes (its 200 x 20 take
    # over a minute on a CPU)
    code = ("import sys; from waymo_2d_tracking_tpu_torch import bench; "
            "bench.CONFIG1.update(num_frames=20, repeats=2); sys.exit(bench.main())")
    r = subprocess.run([sys.executable, "-c", code, "--config1", "--device", "cpu"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [line for line in r.stdout.strip().splitlines() if line.strip()]
    assert len(lines) == 1, lines
    payload = json.loads(lines[0])
    assert set(payload) == {"metric", "value", "unit", "vs_baseline"}
    assert payload["metric"] == "tracker_only_frames_per_sec_per_chip"
    assert payload["unit"] == "frames/sec/chip" and payload["value"] > 0
    assert "# kernel launches: " in r.stderr and "# device: cpu" in r.stderr


def test_bench_verb_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-m", "waymo_2d_tracking_tpu_torch.cli", "bench"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "--device cpu" in r.stderr
