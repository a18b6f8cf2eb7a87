"""The port's ``track`` and ``detect`` verbs against the JAX package's ``w2t``
on the same directory segments and weights (the JAX side reads them as an
orbax ``--params`` directory, the port as the same tree in a flat ``.npz``):
chunked, ``--multicam``, ``--online``, ``--online --multicam``, ``--video``
and ``detect``, on the CPU. Records equal: ids, types, frames exactly,
boxes within 0.2 px, scores within 1e-4."""
import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu import cli as jcli
from waymo_2d_tracking_tpu.config import load_config as jax_load_config
from waymo_2d_tracking_tpu.data import waymo as jwaymo
from waymo_2d_tracking_tpu.io_out import submission as jsubm
from waymo_2d_tracking_tpu.models.detector import DetectorRunner as JaxRunner

from waymo_2d_tracking_tpu_torch import cli

torch.set_num_threads(1)

TINY = [
    "detector.backbone=resnet18slim", "detector.image_size=[64,96]",
    "detector.fpn_channels=32", "detector.head_depth=1",
    "detector.pre_nms_topk=32", "detector.max_detections=8",
    "detector.embed_dim=0", "detector.dtype=float32",
    "detector.score_threshold=0.01",
    "tracker.max_tracks=16", "tracker.max_detections=8",
    "tracker.embed_dim=0", "tracker.score_threshold=0.0",
    "tracker.birth_score_threshold=0.0", "tracker.n_init=1",
    "pipeline.chunk_frames=2",
]
TWO_CAMS = 'pipeline.cameras=["FRONT","FRONT_LEFT"]'


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Weights in both forms, single-camera segments, a two-camera context
    and a video file."""
    import orbax.checkpoint as ocp

    d = tmp_path_factory.mktemp("clitrack")
    jcfg = jax_load_config(None, jcli._parse_overrides(TINY))
    params = jax.device_get(JaxRunner(jcfg.detector).init_params(jax.random.PRNGKey(0),
                                                                 batch_size=1))
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(d / "orbax"), params, force=True)
    ckptr.wait_until_finished()
    np.savez(d / "params.npz", **dict(_flat(params)))
    rng = np.random.default_rng(0)

    def frames(n):
        out = rng.integers(0, 255, (n, 64, 96, 3), dtype=np.uint8)
        out[:, 16:40, 20:60] = 255
        return out

    for name in ("segA", "segB"):
        jwaymo.materialize_directory_segment(str(d / "segs"), name, frames(5),
                                             [100 * t for t in range(5)])
    for cam in (1, 2):
        jwaymo.materialize_directory_segment(str(d / "rig"), "segM", frames(4),
                                             [100 * t for t in range(4)], camera_id=cam)
    video = str(d / "clip.avi")
    w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (96, 64))
    for f in frames(5):
        w.write(f[:, :, ::-1])
    w.release()
    return {"dir": d, "orbax": str(d / "orbax"), "npz": str(d / "params.npz"),
            "segs": str(d / "segs"), "rig": str(d / "rig"), "video": video}


def _both(data, argv, capsys, tag):
    """Run ``argv`` through both CLIs, each writing under its own out dir;
    returns ((jax stdout lines, jax dir), (port stdout lines, port dir))."""
    outs = []
    for name, main, params in (("jax", jcli.main, ["--params", data["orbax"]]),
                               ("port", cli.main, ["--params", data["npz"], "--device", "cpu"])):
        out = str(data["dir"] / f"{tag}_{name}")
        full = [a.replace("{out}", out) for a in argv] + params
        capsys.readouterr()
        main(full)
        outs.append(([json.loads(x) for x in capsys.readouterr().out.strip().splitlines()], out))
    return outs


def _same_files(jdir, pdir, names=None):
    names = names or sorted(f for f in os.listdir(jdir) if f.endswith(".jsonl")
                            and f != "manifest.jsonl")
    assert names and names == sorted(f for f in os.listdir(pdir) if f in names)
    total = 0
    for f in names:
        _same_records(os.path.join(pdir, f), os.path.join(jdir, f))
        total += len(jsubm.read_jsonl(os.path.join(jdir, f)))
    assert total > 0


def _same_records(got_path, want_path):
    key = lambda r: (r.timestamp_micros, r.camera_name, r.object_id)   # noqa: E731
    got = sorted(jsubm.read_jsonl(got_path), key=key)
    want = sorted(jsubm.read_jsonl(want_path), key=key)
    assert [(key(r), r.object_type, r.context_name) for r in got] == \
        [(key(r), r.object_type, r.context_name) for r in want], got_path
    for g, w in zip(got, want):
        for k in ("center_x", "center_y", "length", "width"):
            assert abs(getattr(g, k) - getattr(w, k)) <= 0.2, (k, g, w)
        assert abs(g.score - w.score) <= 1e-4


def _drop(lines, *keys):
    return [{k: v for k, v in d.items() if k not in keys} for d in lines]


def test_track_segments_matches_jax(data, capsys):
    (jl, jd), (pl, pd) = _both(data, ["track", "--segments-dir", data["segs"], "--out-dir",
                                      "{out}", "--set"] + TINY, capsys, "chunked")
    assert _drop(pl, "wall_s", "fps") == _drop(jl, "wall_s", "fps") and len(pl) == 2
    _same_files(jd, pd, ["segA_1.jsonl", "segB_1.jsonl"])
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))


def test_track_multicam_matches_jax(data, capsys):
    (jl, jd), (pl, pd) = _both(data, ["track", "--multicam", "--segments-dir", data["rig"],
                                      "--out-dir", "{out}", "--set", TWO_CAMS] + TINY,
                               capsys, "multicam")
    assert len(pl) == len(jl) == 2
    _same_files(jd, pd, ["segM_1.jsonl", "segM_2.jsonl"])


def test_track_online_matches_jax(data, capsys):
    (jl, jd), (pl, pd) = _both(data, ["track", "--online", "--segments-dir", data["segs"],
                                      "--out-dir", "{out}", "--set"] + TINY, capsys, "online")
    assert _drop(pl, "latency") == _drop(jl, "latency") and len(pl) == 2
    assert all(x["latency"]["count"] == 5 for x in pl)
    _same_files(jd, pd)


def test_track_online_multicam_matches_jax(data, capsys):
    (jl, jd), (pl, pd) = _both(data, ["track", "--online", "--multicam", "--segments-dir",
                                      data["rig"], "--out-dir", "{out}", "--set", TWO_CAMS]
                               + TINY, capsys, "online_mc")
    assert _drop(pl, "latency") == _drop(jl, "latency") and pl[0]["cameras"] == [1, 2]
    _same_files(jd, pd, ["segM_1.jsonl", "segM_2.jsonl"])


def test_track_video_matches_jax(data, capsys):
    (jl, jd), (pl, pd) = _both(data, ["track", "--video", data["video"], "--out-dir", "{out}",
                                      "--set"] + TINY, capsys, "video")
    assert _drop(pl, "latency") == _drop(jl, "latency") and pl[0]["frames"] == 5
    _same_files(jd, pd, ["clip_1.jsonl"])


def test_detect_matches_jax(data, capsys):
    (jl, _), (pl, pd) = _both(data, ["detect", "--segments-dir", data["segs"], "--out",
                                     "{out}.jsonl", "--set"] + TINY, capsys, "detect")
    assert pl[0]["records"] == jl[0]["records"] > 0
    _same_records(pd + ".jsonl", str(data["dir"] / "detect_jax.jsonl"))


def test_track_config2_preset_matches_the_driver(data, capsys):
    """``track --config configs/config2_detector_iou.yaml`` with the tracker
    and pipeline sections as shipped (gates 0.5 / 0.6, chunk 8, S = D =
    128) and the detector narrowed by ``TINY``'s detector overrides writes
    the bytes that ``SegmentPipeline.run_segment`` gives for the same
    directory segments read back by ``iter_segments``. The weights are the
    fixture's with the class-logit bias raised by 2.5, so that scores reach
    the shipped gates (as in ``test_torch_presets_e2e.py``)."""
    from waymo_2d_tracking_tpu_torch.config import load_config
    from waymo_2d_tracking_tpu_torch.data.waymo import iter_segments
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm
    from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentPipeline
    from waymo_2d_tracking_tpu_torch.weights import from_flax_numpy, load_npz

    preset = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "config2_detector_iou.yaml")
    det = [a for a in TINY if a.startswith("detector.")]
    flat = dict(np.load(data["npz"]))
    flat["params/heads/cls_logits/bias"] = flat["params/heads/cls_logits/bias"] + np.float32(2.5)
    params = str(data["dir"] / "params_shifted.npz")
    np.savez(params, **flat)
    out = str(data["dir"] / "config2_cli")
    capsys.readouterr()
    cli.main(["track", "--config", preset, "--segments-dir", data["segs"], "--out-dir", out,
              "--params", params, "--device", "cpu", "--set", *det])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]

    cfg = load_config(preset, cli._parse_overrides(det))
    assert (cfg.pipeline.chunk_frames, cfg.tracker.max_tracks, cfg.tracker.score_threshold,
            cfg.tracker.birth_score_threshold) == (8, 128, 0.5, 0.6)
    pipe = SegmentPipeline(cfg, from_flax_numpy(load_npz(params)), device="cpu")
    total = 0
    for seg, line in zip(iter_segments(data["segs"], cameras=cfg.pipeline.cameras), lines):
        records, stats = pipe.run_segment(seg)
        assert line["records"] == stats["records"] == len(records)
        direct = str(data["dir"] / f"config2_direct_{seg.context_name}.jsonl")
        subm.write_jsonl(direct, records)
        with open(direct, "rb") as a, open(os.path.join(out, f"{seg.context_name}_1.jsonl"),
                                           "rb") as b:
            assert a.read() == b.read()
        total += len(records)
    assert len(lines) == 2 and total > 0
