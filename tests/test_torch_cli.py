"""The port's command line (``cli.py``) against the JAX package's ``w2t`` on
the same inputs: the verbs that need no detector (track --from-detections,
tune, interp, eval with --hota / --per-class / --workers / --ignore, eval-det,
submit, import-mot, export-mot), the verb list, ``doctor``, the flags the
port refuses (``--sharded``) and the card default of ``--device``."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu import cli as jcli
from waymo_2d_tracking_tpu.data.synthetic import SyntheticClipConfig, generate_clip
from waymo_2d_tracking_tpu.io_out import submission as jsubm

from waymo_2d_tracking_tpu_torch import cli

torch.set_num_threads(1)

TRK = ["--set", "tracker.max_detections=32", "tracker.embed_dim=0", "tracker.n_init=2"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A synthetic clip's detections (two contexts, mixed classes) and its
    ground truth as JSONL, and the JAX package's track output on them."""
    d = tmp_path_factory.mktemp("cli")
    det_rows, gt_rows = [], []
    for ctx, seed in (("ctx0", 0), ("ctx1", 5)):
        dets, gt = generate_clip(SyntheticClipConfig(num_frames=30, num_objects=5,
                                                     max_detections=32, embed_dim=1, seed=seed))
        dets = type(dets)(**{f.name: np.asarray(getattr(dets, f.name))
                             for f in dataclasses.fields(dets)})
        stamps = [1000 * t for t in range(30)]
        det_rows += jsubm.records_from_detections(dets, ctx, stamps, camera_name=1)
        gt_rows += [jsubm.TrackRecord.from_xyxy(ctx, stamps[t], 1, f"gt{k}", (1, 2, 4)[k % 3],
                                                gt["boxes"][t, k], 1.0)
                    for t in range(30) for k in np.flatnonzero(gt["present"][t])]
    paths = {k: str(d / f"{k}.jsonl") for k in ("dets", "gt", "jax_tracks")}
    jsubm.write_jsonl(paths["dets"], det_rows)
    jsubm.write_jsonl(paths["gt"], gt_rows)
    jcli.main(["track", "--from-detections", paths["dets"], "--out", paths["jax_tracks"]] + TRK)
    return paths


def _run(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


def _same_tracks(got_path, want_path):
    got, want = jsubm.read_jsonl(got_path), jsubm.read_jsonl(want_path)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        for k in ("center_x", "center_y", "length", "width"):
            assert abs(g.pop(k) - w.pop(k)) <= 0.2, k
        assert abs(g.pop("score") - w.pop("score")) <= 1e-4
        assert g == w


def test_help_lists_every_jax_verb_but_bench():
    def verbs(parser):
        return set(parser._subparsers._group_actions[0].choices)

    want = verbs(jcli.build_parser()) - {"bench"}
    got = verbs(cli.build_parser())
    assert want <= got and "bench" not in got
    assert got - want == {"export"}


def test_track_from_detections_matches_jax(files, tmp_path, capsys):
    out = str(tmp_path / "tracks.jsonl")
    status = json.loads(_run(cli.main, ["track", "--from-detections", files["dets"], "--out",
                                        out, "--device", "cpu"] + TRK, capsys))
    assert status == {"records": len(jsubm.read_jsonl(files["jax_tracks"])), "out": out}
    _same_tracks(out, files["jax_tracks"])
    with pytest.raises(SystemExit, match="appearance"):
        cli.main(["track", "--from-detections", files["dets"], "--out", out, "--device", "cpu",
                  "--set", "tracker.appearance_weight=0.5"])


def test_tune_matches_jax(files, tmp_path, capsys):
    argv = ["tune", "--from-detections", files["dets"], "--gt", files["gt"], "--trials", "4",
            "--seed", "2", "--set", "tracker.max_detections=32", "tracker.embed_dim=0"]
    want = json.loads(_run(jcli.main, argv + ["--out", str(tmp_path / "j.json")], capsys))
    got = json.loads(_run(cli.main, argv + ["--out", str(tmp_path / "p.json"), "--device", "cpu"],
                          capsys))
    for d in (got, want):
        d.pop("out")
    assert got == want
    jr, pr = json.load(open(tmp_path / "j.json")), json.load(open(tmp_path / "p.json"))
    assert [(r["trial"], r["knobs"], r["mota"], r["idf1"]) for r in pr["results"]] == \
        [(r["trial"], r["knobs"], r["mota"], r["idf1"]) for r in jr["results"]]


def test_interp_matches_jax(files, tmp_path, capsys):
    a, b = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    sj = json.loads(_run(jcli.main, ["interp", files["jax_tracks"], "--out", a, "--max-gap", "3"],
                         capsys))
    sp = json.loads(_run(cli.main, ["interp", files["jax_tracks"], "--out", b, "--max-gap", "3"],
                         capsys))
    assert {k: v for k, v in sp.items() if k != "out"} == \
        {k: v for k, v in sj.items() if k != "out"} and sp["interpolated"] > 0
    assert open(a).read() == open(b).read()


@pytest.mark.parametrize("flags", [[], ["--hota"], ["--per-class"], ["--hota", "--workers", "2"]])
def test_eval_matches_jax(files, capsys, flags):
    argv = ["eval", "--pred", files["jax_tracks"], "--gt", files["gt"]] + flags
    got = json.loads(_run(cli.main, argv, capsys))
    assert got == json.loads(_run(jcli.main, argv, capsys))
    assert "OVERALL" in got and ("hota" in got["OVERALL"]) == ("--hota" in flags)
    if "--per-class" in flags:
        assert {"CLASS_VEHICLE", "CLASS_PEDESTRIAN", "CLASS_CYCLIST"} <= set(got)


def test_eval_det_matches_jax(files, capsys):
    argv = ["eval-det", "--pred", files["dets"], "--gt", files["gt"]]
    got = _run(cli.main, argv, capsys)
    assert json.loads(got) == json.loads(_run(jcli.main, argv, capsys))
    assert json.loads(got)["mAP"] > 0


def test_submit_pb_bytes_equal_jax(files, tmp_path, capsys):
    a, b = str(tmp_path / "j.pb"), str(tmp_path / "p.pb")
    sj = json.loads(_run(jcli.main, ["submit", files["jax_tracks"], files["dets"], "--out", a],
                         capsys))
    sp = json.loads(_run(cli.main, ["submit", files["jax_tracks"], files["dets"], "--out", b],
                         capsys))
    assert sp["objects"] == sj["objects"] > 0
    assert open(a, "rb").read() == open(b, "rb").read()


def test_mot_import_export_and_ignore_match_jax(files, tmp_path, capsys):
    gt = tmp_path / "gt.txt"
    gt.write_text("1,1,10,10,20,40,1,1,1.0\n1,2,100,10,20,40,1,1,1.0\n1,3,200,10,20,40,0,1,1\n"
                  "2,1,12,10,20,40,1,1,1.0\n2,2,102,10,20,40,1,7,1.0\n2,4,300,5,5,5,1,9,1\n")
    res = tmp_path / "res.txt"
    res.write_text("1,7,10,10,20,40,0.9\n1,8,100,10,20,40,0.9\n1,9,200,10,20,40,0.8\n"
                   "2,7,12,10,20,40,0.9\n2,8,102,10,20,40,0.9\n")
    outs = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        d = tmp_path / name
        d.mkdir()
        g, r = str(d / "gt.jsonl"), str(d / "res.jsonl")
        s1 = json.loads(_run(main, ["import-mot", str(gt), "--out", g, "--gt", "--context",
                                    "MOT-seq"], capsys))
        s2 = json.loads(_run(main, ["import-mot", str(res), "--out", r, "--context", "MOT-seq"],
                             capsys))
        ev = _run(main, ["eval", "--pred", r, "--gt", g, "--ignore",
                         str(d / "gt.ignore.jsonl")], capsys)
        ex = json.loads(_run(main, ["export-mot", r, "--out-dir", str(d / "mot")], capsys))
        outs[name] = (s1, s2, ev, ex, {f: open(p).read() for f, p in
                                       ((f, os.path.join(d, f)) for f in
                                        ("gt.jsonl", "res.jsonl", "gt.ignore.jsonl"))},
                      {f: open(d / "mot" / f).read() for f in os.listdir(d / "mot")})
    j, p = outs["jax"], outs["port"]
    strip = lambda s: {k: v for k, v in s.items() if not k.endswith("out")}   # noqa: E731
    assert strip(p[0]) == strip(j[0]) and p[0]["skipped_ignore"] == 2
    assert strip(p[1]) == strip(j[1])
    assert p[2] == j[2] and "suppressed_on_ignore_regions" in p[2]
    assert p[3]["files"] == j[3]["files"] == {"MOT-seq.txt": 5}
    assert p[4] == j[4] and p[5] == j[5]
    with pytest.raises(SystemExit):
        cli.main(["import-mot", str(tmp_path / "jax"), "--out", str(tmp_path / "x.jsonl"),
                  "--context", "X"])


def test_sharded_flags_raise(files, tmp_path):
    for argv in (["track", "--sharded", "--segments-dir", str(tmp_path)],
                 ["detect", "--sharded", "--segments-dir", str(tmp_path)],
                 ["train", "--sharded", "--steps", "1"],
                 ["link", "--sharded", "--out-dir", str(tmp_path)]):
        with pytest.raises(NotImplementedError, match="item 9"):
            cli.main(argv + (["--device", "cpu"] if argv[0] != "link" else []))


def test_device_defaults_to_the_card(files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["track", "--from-detections", files["dets"], "--out",
                  str(tmp_path / "t.jsonl")] + TRK)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["serve", "--socket", str(tmp_path / "s.sock"), "--set",
                  "detector.backbone=resnet18slim", "detector.embed_dim=0"])


def test_doctor_reports_and_needs_a_card(capsys):
    rc = cli.main(["doctor", "--compile-cache", "off"])
    report = json.loads(capsys.readouterr().out)
    assert {"torch", "kernels", "native", "optional_deps", "presets", "status"} <= set(report)
    assert "headline" in report["presets"]
    assert report["kernels"]["built"] == [] and report["native"]["tfrecord_scanner"] is True
    assert isinstance(report["native"]["jpeg_decoder"], bool)
    if torch.cuda.is_available():
        assert rc == 0 and report["status"] == "ok"
    else:
        assert rc == 1 and report["status"] == "degraded"
