"""The port's remaining verbs against the JAX package's ``w2t``: ``draw``
(the same JPEG bytes), ``link`` (the same linked files), ``convert`` (the
same COCO annotations), ``import-weights`` (the same imported weights), and
``train`` on the CPU, whose exported state dict and checkpoint both serve
through ``--params``."""
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu import cli as jcli
from waymo_2d_tracking_tpu.data import waymo as jwaymo
from waymo_2d_tracking_tpu.io_out import submission as jsubm

from waymo_2d_tracking_tpu_torch import cli
from waymo_2d_tracking_tpu_torch.weights import from_flax_numpy

torch.set_num_threads(1)

SMALL = ["detector.backbone=resnet18slim", "detector.image_size=[64,96]",
         "detector.fpn_channels=32", "detector.head_depth=1", "detector.pre_nms_topk=32",
         "detector.max_detections=8", "detector.dtype=float32", "detector.score_threshold=0.01"]
TRK = ["tracker.max_tracks=16", "tracker.max_detections=8", "tracker.score_threshold=0.0",
       "tracker.birth_score_threshold=0.0", "tracker.n_init=1", "pipeline.chunk_frames=2"]


@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cliverbs")
    rng = np.random.default_rng(0)
    labels = [jsubm.TrackRecord.from_xyxy("segA", 100 * t, 1, "a", 1, (20, 16, 60, 40), 1.0)
              for t in range(4)]
    for cam in (1, 2):
        frames = rng.integers(0, 255, (4, 64, 96, 3), dtype=np.uint8)
        frames[:, 16:40, 20:60] = 255
        jwaymo.materialize_directory_segment(str(d / "segs"), "segA", frames,
                                             [100 * t for t in range(4)], camera_id=cam,
                                             labels=labels if cam == 2 else None)
    return d


def _out(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]


def test_draw_matches_jax(segs, capsys):
    tracks = str(segs / "tracks.jsonl")
    jsubm.write_jsonl(tracks, [jsubm.TrackRecord.from_xyxy("segA", 100 * t, 1, f"1_{k}", 1,
                                                           (5 + 10 * k, 5 + t, 30 + 10 * k, 30 + t),
                                                           0.9) for t in range(4) for k in range(2)])
    outs = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        capsys.readouterr()
        main(["draw", "--tracks", tracks, "--segments-dir", str(segs / "segs"), "--out-dir",
              str(segs / f"viz_{name}"), "--max-frames", "3"])
        outs[name] = _out(capsys)[0]
    assert outs["port"]["frames"] == outs["jax"]["frames"] == 3
    names = sorted(os.listdir(segs / "viz_jax"))
    assert names == sorted(os.listdir(segs / "viz_port")) and len(names) == 3
    for n in names:
        assert (segs / "viz_jax" / n).read_bytes() == (segs / "viz_port" / n).read_bytes()


def test_link_matches_jax(segs, capsys):
    """Gallery sidecars from the port's multicam run (ReID on), linked by
    each package's ``link`` on its own copy of the directory."""
    out = str(segs / "mc")
    cli.main(["track", "--multicam", "--segments-dir", str(segs / "segs"), "--out-dir", out,
              "--device", "cpu", "--set", 'pipeline.cameras=["FRONT","FRONT_LEFT"]',
              "detector.embed_dim=16", "tracker.embed_dim=16"] + SMALL + TRK)
    assert os.path.exists(os.path.join(out, "segA_1.gallery.npz"))
    reports = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        shutil.copytree(out, str(segs / f"link_{name}"))
        capsys.readouterr()
        main(["link", "--out-dir", str(segs / f"link_{name}"), "--threshold", "0.0"])
        reports[name] = _out(capsys)[0]
    strip = lambda r: {k: v for k, v in r.items() if k != "out"}   # noqa: E731
    assert strip(reports["port"]) == strip(reports["jax"])
    jd, pd = (segs / "link_jax"), (segs / "link_port")
    for root, _, fs in os.walk(jd):
        for f in fs:
            if f.endswith(".jsonl") and f != "manifest.jsonl":
                rel = os.path.relpath(os.path.join(root, f), jd)
                assert (pd / rel).read_text() == (jd / rel).read_text(), rel


def test_convert_matches_jax(segs, capsys):
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        main(["convert", "--segments-dir", str(segs / "segs"), "--out-dir",
              str(segs / f"coco_{name}")])
    j, p = _out(capsys)
    assert p["images"] == j["images"] == 8
    ja = json.load(open(segs / "coco_jax" / "annotations.json"))
    pa = json.load(open(segs / "coco_port" / "annotations.json"))
    assert pa == ja and pa["annotations"]


def test_import_weights_matches_jax(tmp_path, capsys):
    """A torchvision ResNet-18 state dict through both CLIs: every imported
    weight equal (the JAX side read back from its orbax output)."""
    import orbax.checkpoint as ocp

    from waymo_2d_tracking_tpu_torch.config import DetectorConfig
    from waymo_2d_tracking_tpu_torch.models.detector import Detector

    rng = np.random.default_rng(0)
    sd = {}
    model = Detector(DetectorConfig(backbone="resnet18", stem="conv7", embed_dim=0))
    for key, value in model.state_dict().items():
        if key.startswith("backbone.stem_conv"):
            sd["conv1.weight"] = value
        elif key.startswith("backbone.stage") and "num_batches" not in key:
            stage, rest = key[len("backbone.stage"):].split("_block")
            b, layer, leaf = rest.split(".")
            layer = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(
                layer, layer)
            sd[f"layer{stage}.{b}.{layer}.{leaf}"] = value
    sd = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
          for k, v in sd.items()}
    torch.save(sd, tmp_path / "r18.pth")
    argv = ["import-weights", str(tmp_path / "r18.pth"), "--set", "detector.backbone=resnet18",
            "detector.image_size=[64,96]", "detector.fpn_channels=32", "detector.head_depth=1",
            "detector.embed_dim=0", "detector.dtype=float32"]
    capsys.readouterr()
    jcli.main(argv + ["--out", str(tmp_path / "jax")])
    cli.main(argv + ["--out", str(tmp_path / "port.pt")])
    j, p = _out(capsys)
    assert {k: p[k] for k in ("n_imported", "n_skipped_shape", "n_missing")} == \
        {k: j[k] for k in ("n_imported", "n_skipped_shape", "n_missing")}
    assert p["n_imported"] == len(sd)
    want = from_flax_numpy(jax.tree.map(np.asarray, ocp.StandardCheckpointer().restore(
        str(tmp_path / "jax"))))
    got = torch.load(tmp_path / "port.pt", weights_only=True)
    checked = 0
    for key, value in model.state_dict().items():
        if key.startswith("backbone.") and not key.startswith("backbone.stem_bn") \
                and "num_batches" not in key:
            np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
            checked += 1
    assert checked == len(sd)


def test_train_cli_and_params_forms(segs, tmp_path, capsys):
    """``train`` on synthetic batches writes a checkpoint and the serving
    state dict; ``detect --params`` gives the same detections from either
    (EMA parameters served from the checkpoint)."""
    ckpt = str(tmp_path / "ckpt")
    argv = SMALL + ["detector.embed_dim=0", "train.batch_size=2", "train.warmup_steps=1",
                    "train.total_steps=2", "train.ema_decay=0.9", f"train.checkpoint_dir={ckpt}",
                    "train.checkpoint_every=100"]
    cli.main(["train", "--steps", "2", "--val-every", "2", "--val-batches", "1", "--device",
              "cpu", "--set"] + argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("step 2:") and "loss=" in line for line in lines)
    assert any("val" in line and "mAP=" in line for line in lines)
    done = json.loads(lines[-1])
    assert done["step"] == 2 and os.path.isfile(done["export"])
    assert os.path.isfile(os.path.join(ckpt, "step_2"))
    recs = {}
    for name, params in (("export", done["export"]), ("ckpt", os.path.join(ckpt, "step_2"))):
        out = str(tmp_path / f"{name}.jsonl")
        cli.main(["detect", "--segments-dir", str(segs / "segs"), "--out", out, "--device",
                  "cpu", "--params", params, "--set"] + argv)
        recs[name] = [dataclasses.asdict(r) for r in jsubm.read_jsonl(out)]
    assert recs["export"] == recs["ckpt"] and recs["export"]
