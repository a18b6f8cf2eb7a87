"""The ``--sharded`` verbs as a user starts them: two processes (spawned,
gloo over TCP on 127.0.0.1) given ``W2T_COORDINATOR``, ``W2T_NUM_PROCESSES``
and ``W2T_PROCESS_ID``. First ``initialize_multihost`` and an all-reduce of
``process id + 1``, which gives 3 in both (``tests/distributed/
test_multihost.py``'s check); then ``track --sharded``, ``track --multicam
--sharded``, ``detect --sharded``, ``link --sharded`` and ``train --sharded
--steps 1``, each joining and leaving its own group, against the same verbs
unsharded in this process on the CPU: the same files byte for byte (the
gallery sidecars' arrays bit for bit), the same stats rows (the sharded rows
carry JAX's ``shard`` and no timing), the same training export (the first
update's scheduled rate is 0, so the parameters stay, and the BatchNorm
statistics are the global batch's bits). Only process 0 prints."""
import json
import os
import socket

import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.data import waymo as jwaymo

from waymo_2d_tracking_tpu_torch import cli
from waymo_2d_tracking_tpu_torch.parallel.launch import run_ranks
from waymo_2d_tracking_tpu_torch.tools import rank_cases

torch.set_num_threads(1)

WORLD = 2
TINY = [
    "detector.backbone=resnet18slim", "detector.image_size=[64,96]",
    "detector.fpn_channels=32", "detector.head_depth=1",
    "detector.pre_nms_topk=32", "detector.max_detections=8",
    "detector.embed_dim=8", "detector.dtype=float32",
    "detector.score_threshold=0.01",
    "tracker.max_tracks=16", "tracker.max_detections=8",
    "tracker.embed_dim=8", "tracker.score_threshold=0.0",
    "tracker.birth_score_threshold=0.0", "tracker.n_init=1",
    "pipeline.chunk_frames=2",
]
TWO_CAMS = 'pipeline.cameras=["FRONT","FRONT_LEFT"]'
TRAIN = ["train.batch_size=4", "train.warmup_steps=2", "train.total_steps=10",
         "train.ema_decay=0.9"]


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def verbs(d, out):
    """The five command lines, writing under ``out``."""
    return [
        ["track", "--sharded", "--segments-dir", d["segs"], "--out-dir", f"{out}/track",
         "--device", "cpu", "--set"] + TINY,
        ["track", "--multicam", "--sharded", "--segments-dir", d["rig"], "--out-dir",
         f"{out}/rig", "--device", "cpu", "--set", TWO_CAMS] + TINY,
        ["detect", "--sharded", "--segments-dir", d["segs"], "--out", f"{out}/det.jsonl",
         "--device", "cpu", "--set"] + TINY,
        ["link", "--sharded", "--out-dir", f"{out}/rig", "--linked-dir", f"{out}/linked",
         "--threshold", "0.0", "--device", "cpu"],
        ["train", "--sharded", "--steps", "1", "--device", "cpu", "--set",
         f"train.checkpoint_dir={out}/ckpt"] + TINY + TRAIN,
    ]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("clisharded")
    rng = np.random.default_rng(0)

    def frames(n):
        out = rng.integers(0, 255, (n, 64, 96, 3), dtype=np.uint8)
        out[:, 16:40, 20:60] = 255
        return out

    for name, t in (("segA", 5), ("segB", 3), ("segC", 4)):
        jwaymo.materialize_directory_segment(str(d / "segs"), name, frames(t),
                                             [100 * k for k in range(t)])
    for ctx in ("segM", "segN"):
        for cam in (1, 2):
            jwaymo.materialize_directory_segment(str(d / "rig"), ctx, frames(4),
                                                 [100 * k for k in range(4)], camera_id=cam)
    paths = {"dir": d, "segs": str(d / "segs"), "rig": str(d / "rig")}
    shd = str(d / "shd")
    paths["ranks"] = run_ranks(rank_cases.cli_case, WORLD, "cpu", free_ports(6),
                               verbs(paths, shd), device="cpu", threads=1, timeout=300,
                               workdir=str(d / "work"), join=False)
    paths["shd"] = shd
    return paths


def _plain(argv):
    return [a for a in argv if a != "--sharded"]


def _lines(text):
    """The JSON lines of a verb's output (``train`` also logs its steps)."""
    return [json.loads(x) for x in text.strip().splitlines() if x.startswith("{")]


def _same_dir(got, want):
    names = sorted(f for f in os.listdir(want) if f.endswith((".jsonl", ".npz"))
                   and f != "manifest.jsonl")
    assert names and names == sorted(f for f in os.listdir(got) if f in names)
    for f in names:
        if f.endswith(".npz"):
            zg, zw = np.load(os.path.join(got, f)), np.load(os.path.join(want, f))
            for k in zw.files:
                np.testing.assert_array_equal(zg[k], zw[k])
        else:
            assert open(os.path.join(got, f), "rb").read() == \
                open(os.path.join(want, f), "rb").read(), f


def test_two_processes_through_the_w2t_variables(data):
    for r in data["ranks"]:
        assert r["joined"] and r["world"] == WORLD and r["total"] == 3.0


@pytest.fixture(scope="module")
def plain(data, tmp_path_factory):
    """The same verbs unsharded in this process, with their stdout."""
    import contextlib
    import io

    out = str(tmp_path_factory.mktemp("plain"))
    printed = []
    for argv in verbs(data, out):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(_plain(argv))
        printed.append(buf.getvalue())
    return {"dir": out, "printed": printed}


def test_track_and_multicam_sharded_equal_unsharded(data, plain):
    for i, sub in ((0, "track"), (1, "rig")):
        got, want = _lines(data["ranks"][0]["outs"][i]), _lines(plain["printed"][i])
        assert data["ranks"][1]["outs"][i] == ""
        keys = ("context", "camera", "frames", "tracks", "records")
        assert [{k: g[k] for k in keys} for g in got] == [{k: w[k] for k in keys} for w in want]
        assert all("shard" in g for g in got) and sum(w["records"] for w in want) > 0
        _same_dir(os.path.join(data["shd"], sub), os.path.join(plain["dir"], sub))


def test_detect_sharded_merges_this_runs_segments(data, plain):
    got, want = _lines(data["ranks"][0]["outs"][2]), _lines(plain["printed"][2])
    assert got[-1]["records"] == want[-1]["records"] > 0
    assert open(os.path.join(data["shd"], "det.jsonl"), "rb").read() == \
        open(os.path.join(plain["dir"], "det.jsonl"), "rb").read()


def test_link_sharded_equals_unsharded(data, plain):
    got, want = _lines(data["ranks"][0]["outs"][3]), _lines(plain["printed"][3])
    assert {k: v for k, v in got[0].items() if k != "out"} == \
        {k: v for k, v in want[0].items() if k != "out"}
    assert got[0]["cross_camera_merges"] > 0
    _same_dir(os.path.join(data["shd"], "linked"), os.path.join(plain["dir"], "linked"))


def test_train_sharded_equals_unsharded(data, plain):
    got, want = _lines(data["ranks"][0]["outs"][4]), _lines(plain["printed"][4])
    assert data["ranks"][1]["outs"][4] == ""
    assert got[0]["step"] == want[0]["step"] == 1
    eg = torch.load(got[0]["export"], weights_only=True)
    ew = torch.load(want[0]["export"], weights_only=True)
    assert set(eg) == set(ew)
    for k in ew:
        assert torch.equal(eg[k], ew[k]), k
