"""The port's host-only modules against the JAX package's: HOTA
(``eval/hota.py``), MOTChallenge text (``io_out/motchallenge.py``), the Waymo
protobuf codec (``io_out/submission.py``), the drawing tool
(``utils/viz.py``), the kernels' build directory (``utils/compile_cache.py``),
the profiler hook (``utils/profiling.py``) and the torchvision weight import
(``train/port_torch.py``)."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.config import DetectorConfig as JaxDetectorConfig
from waymo_2d_tracking_tpu.eval import hota as jhota
from waymo_2d_tracking_tpu.io_out import motchallenge as jmot
from waymo_2d_tracking_tpu.io_out import submission as jsubm
from waymo_2d_tracking_tpu.models.detector import DetectorRunner as JaxRunner
from waymo_2d_tracking_tpu.pipeline.run import SegmentFrames as JaxSegmentFrames
from waymo_2d_tracking_tpu.train import port_torch as jport
from waymo_2d_tracking_tpu.utils import viz as jviz

from waymo_2d_tracking_tpu_torch.config import DetectorConfig
from waymo_2d_tracking_tpu_torch.eval import hota
from waymo_2d_tracking_tpu_torch.io_out import motchallenge, submission
from waymo_2d_tracking_tpu_torch.ops import _cuda
from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames
from waymo_2d_tracking_tpu_torch.train import port_torch
from waymo_2d_tracking_tpu_torch.utils import compile_cache, profiling, viz
from waymo_2d_tracking_tpu_torch.weights import from_flax_numpy

torch.set_num_threads(1)


def _clip_frames(seed, n_frames=12, n_ids=5, drop=0.2, jitter=4.0):
    """Per-frame (ids, xyxy boxes) of a ground truth and a noisy hypothesis
    with misses, false positives and one id switch."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 200, (n_ids, 2))
    gt, hyp = [], []
    for t in range(n_frames):
        ids = np.arange(n_ids)
        boxes = np.concatenate([base + 3 * t, base + 3 * t + 30], 1)
        gt.append((ids, boxes))
        keep = rng.uniform(size=n_ids) > drop
        hid = np.where(ids == 2, 2 if t < n_frames // 2 else 9, ids)[keep]
        hb = boxes[keep] + rng.normal(0, jitter, (keep.sum(), 4))
        if t % 3 == 0:
            hid = np.append(hid, 50 + t)
            hb = np.vstack([hb, rng.uniform(0, 200, (1, 2)).repeat(2, 1) + [0, 0, 25, 25]])
        hyp.append((hid, hb))
    return gt, hyp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hota_matches_jax(seed):
    gt, hyp = _clip_frames(seed)
    got, want = hota.evaluate_hota(gt, hyp), jhota.evaluate_hota(gt, hyp)
    assert got.as_dict() == want.as_dict() and 0.0 < got.hota < 1.0
    np.testing.assert_array_equal(got.counts, want.counts)
    parts = [hota.evaluate_hota(*_clip_frames(s)) for s in (3, 4)]
    jparts = [jhota.evaluate_hota(*_clip_frames(s)) for s in (3, 4)]
    assert hota.combine_hota(parts).as_dict() == jhota.combine_hota(jparts).as_dict()
    with pytest.raises(ValueError, match="duplicate"):
        hota.evaluate_hota([(np.array([1, 1]), np.zeros((2, 4)))],
                           [(np.array([1]), np.zeros((1, 4)))])


def _records(n=40, seed=0, cams=(1,)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x, y = rng.uniform(0, 500, 2)
        out.append(jsubm.TrackRecord.from_xyxy(
            f"ctx{i % 2}", 100_000 * (1 + i // 4) + (3 if i % 5 == 0 else 0),
            cams[i % len(cams)], f"{cams[i % len(cams)]}_{i % 6}", (1, 2, 4)[i % 3],
            (x, y, x + rng.uniform(5, 80), y + rng.uniform(5, 80)), rng.uniform(0.1, 1.0)))
    return out


def _port(rows):
    return [submission.TrackRecord(**dataclasses.asdict(r)) for r in rows]


def test_waymo_pb_bytes_equal_jax(tmp_path):
    rows = _records(cams=(1, 2, 3))
    a, b = str(tmp_path / "jax.pb"), str(tmp_path / "port.pb")
    assert jsubm.write_waymo_pb(a, rows) == submission.write_waymo_pb(b, _port(rows)) == len(rows)
    assert open(a, "rb").read() == open(b, "rb").read()
    back = submission.read_waymo_pb(a)
    assert [dataclasses.asdict(r) for r in back] == \
        [dataclasses.asdict(r) for r in jsubm.read_waymo_pb(b)]
    assert [(r.object_id, r.center_x, r.timestamp_micros) for r in back] == \
        [(r.object_id, r.center_x, r.timestamp_micros) for r in rows]
    assert submission.WAYMO_TYPE_NAMES == jsubm.WAYMO_TYPE_NAMES


def test_motchallenge_matches_jax(tmp_path):
    rows = _records(cams=(1, 2))
    ja, po = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jmot.write_mot(rows, ja) == motchallenge.write_mot(_port(rows), po)
    for name in sorted(os.listdir(ja)):
        assert open(os.path.join(ja, name)).read() == open(os.path.join(po, name)).read()
    gt = tmp_path / "gt.txt"
    gt.write_text("1,1,10,20,30,40,1,1,1\n1,2,50,60,20,20,0,1,1\n2,1,12,21,30,40,1,3,1\n"
                  "2,3,80,80,10,10,1,7,1\n3,4,5,5,5,5,1,10,1\n3,5,9,9,9,9,1,4,0.5\n")
    for kw in ({"gt": True}, {"gt": False}):
        (got, gs), (want, ws) = motchallenge.read_mot(str(gt), **kw), jmot.read_mot(str(gt), **kw)
        assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
        assert (gs.kept, gs.skipped_ignore, gs.skipped_class) == \
            (ws.kept, ws.skipped_ignore, ws.skipped_class)
        assert [dataclasses.asdict(r) for r in gs.ignore] == \
            [dataclasses.asdict(r) for r in ws.ignore]
    got, _ = motchallenge.read_mot_tree(ja)
    want, _ = jmot.read_mot_tree(ja)
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]


def test_viz_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (3, 64, 96, 3), dtype=np.uint8)
    rows = [jsubm.TrackRecord.from_xyxy("seg", t, 1, f"1_{k}", 1,
                                        (10 + 5 * k, 10 + t, 40 + 5 * k, 30 + t), 0.5 + 0.1 * k)
            for t in range(3) for k in range(3)]
    for oid in ("1_0", "7_12", "x"):
        assert viz.id_color(oid) == jviz.id_color(oid)
    np.testing.assert_array_equal(viz.draw_frame(frames[0], _port(rows[:3])),
                                  jviz.draw_frame(frames[0], rows[:3]))
    ja, po = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jviz.render_segment(JaxSegmentFrames("seg", 1, [0, 1, 2], frames), rows, ja) == \
        viz.render_segment(SegmentFrames("seg", 1, [0, 1, 2], frames), _port(rows), po) == 3
    for name in sorted(os.listdir(ja)):
        assert open(os.path.join(ja, name), "rb").read() == \
            open(os.path.join(po, name), "rb").read()


def test_compile_cache_resolution(tmp_path, monkeypatch):
    """--compile-cache, then W2T_COMPILE_CACHE, then the package's _build/;
    'off' is a directory of this process's own; the kernels' build directory
    follows, and the built kernels are listed from it."""
    saved = _cuda.BUILD_DIR
    try:
        monkeypatch.delenv("W2T_COMPILE_CACHE", raising=False)
        assert compile_cache.resolve_cache_dir() == compile_cache.DEFAULT_DIR
        monkeypatch.setenv("W2T_COMPILE_CACHE", str(tmp_path / "env"))
        assert compile_cache.resolve_cache_dir() == str(tmp_path / "env")
        assert compile_cache.resolve_cache_dir(str(tmp_path / "arg")) == str(tmp_path / "arg")
        assert compile_cache.resolve_cache_dir("OFF") is None
        assert compile_cache.enable_compile_cache(str(tmp_path / "arg")) == _cuda.BUILD_DIR
        assert os.path.isdir(tmp_path / "arg") and compile_cache.built_kernels() == []
        open(_cuda._lib_path("nms"), "wb").close()
        assert compile_cache.built_kernels() == ["nms"]
        off = compile_cache.enable_compile_cache("off")
        assert os.path.isdir(off) and off != str(tmp_path / "env") and _cuda.BUILD_DIR == off
    finally:
        _cuda.BUILD_DIR = saved


def test_profiling_trace_and_timer(tmp_path):
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(8).add_(1)
    (name,) = os.listdir(tmp_path / "tr")
    assert name.endswith(".json") and "aten::add_" in open(tmp_path / "tr" / name).read()
    timer = profiling.PhaseTimer()
    for _ in range(2):
        with timer.phase("a"):
            pass
    assert timer.report()["a"]["calls"] == 2 and '"a"' in timer.dump()


def _torchvision_sd(cfg, rng):
    """A torchvision-layout state dict (detection-model prefixes) with the
    shapes of ``cfg``'s conv7 detector, plus one mis-shaped and one unknown
    key."""
    from waymo_2d_tracking_tpu_torch.models.detector import Detector

    names = {"backbone.stem_conv": "backbone.body.conv1", "backbone.stem_bn": "backbone.body.bn1",
             "heads.cls_logits": "head.classification_head.cls_logits",
             "heads.box_ltrb": "head.regression_head.bbox_reg",
             "heads.centerness": "head.regression_head.bbox_ctrness",
             "fpn.p6": "backbone.fpn.extra_blocks.p6", "fpn.p7": "backbone.fpn.extra_blocks.p7"}
    for i, lvl in enumerate((3, 4, 5)):
        names[f"fpn.lateral{lvl}"] = f"backbone.fpn.inner_blocks.{i}.0"
        names[f"fpn.smooth{lvl}"] = f"backbone.fpn.layer_blocks.{i}.0"
    for i in range(cfg.head_depth):
        for tower, src in (("cls_tower", "classification_head"), ("box_tower", "regression_head")):
            names[f"heads.{tower}.conv{i}"] = f"head.{src}.conv.{i}.0"
            names[f"heads.{tower}.gn{i}"] = f"head.{src}.conv.{i}.1"
    sd = {}
    for key, value in Detector(dataclasses.replace(cfg, stem="conv7")).state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked" or mod == "heads":
            continue
        if mod in names:
            src = names[mod]
        elif mod.startswith("backbone.stage"):
            stage, rest = mod[len("backbone.stage"):].split("_block")
            b, layer = rest.split(".")
            layer = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(
                layer, layer)
            src = f"backbone.body.layer{stage}.{b}.{layer}"
        else:
            continue
        sd[f"{src}.{leaf}"] = torch.from_numpy(
            rng.standard_normal(tuple(value.shape)).astype(np.float32))
    sd["backbone.body.layer1.0.conv1.weight"] = torch.zeros(3, 3, 3, 3)   # wrong shape
    sd["head.classification_head.extra.weight"] = torch.zeros(2)          # ignored
    return sd


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
def test_port_torch_matches_jax_import(tmp_path, stem):
    """The same torchvision state dict through the JAX package's import and
    ``from_flax_numpy`` equals the port's import over the same template, key
    for key; the 7x7 stem into s2d is exact."""
    kw = dict(backbone="resnet18", image_size=(64, 96), fpn_channels=32, head_depth=2,
              embed_dim=0, dtype="float32", stem=stem)
    cfg, jcfg = DetectorConfig(**kw), JaxDetectorConfig(**kw)
    sd = _torchvision_sd(cfg, np.random.default_rng(0))
    torch.save({"model": sd}, tmp_path / "tv.pth")
    loaded = port_torch.load_torch_state_dict(str(tmp_path / "tv.pth"))
    template = jax.device_get(JaxRunner(jcfg).init_params(jax.random.PRNGKey(0), batch_size=1))
    jvar, jrep = jport.torch_to_flax_variables(
        jport.load_torch_state_dict(str(tmp_path / "tv.pth")), template, jcfg)
    want = from_flax_numpy(jvar)
    got, rep = port_torch.torch_to_port_state_dict(
        loaded, from_flax_numpy(jax.tree.map(np.asarray, template)), cfg)
    # the same keys imported, missing and skipped (the skip message gives
    # each package's own layout of the shapes)
    assert {k: rep[k] for k in ("imported", "missing")} == \
        {k: jrep[k] for k in ("imported", "missing")} and len(rep["imported"]) > 100
    assert [m.split(":")[0] for m in rep["skipped_shape"]] == \
        [m.split(":")[0] for m in jrep["skipped_shape"]]
    assert len(rep["skipped_shape"]) == 1 and rep["missing"] == []
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    w7 = sd["backbone.body.conv1.weight"]
    if stem == "s2d":
        assert tuple(got["backbone.stem_conv.weight"].shape) == (64, 12, 4, 4)
        assert float(got["backbone.stem_conv.weight"].abs().sum()) == \
            pytest.approx(float(w7.abs().sum()), rel=1e-6)
    else:
        assert torch.equal(got["backbone.stem_conv.weight"], w7)
    report = port_torch.import_weights(str(tmp_path / "tv.pth"), str(tmp_path / "out.pt"), cfg)
    assert report["n_imported"] == len(rep["imported"]) and report["n_skipped_shape"] == 1
    saved = torch.load(tmp_path / "out.pt", weights_only=True)
    assert torch.equal(saved["backbone.stage2_block1.conv2.weight"],
                       got["backbone.stage2_block1.conv2.weight"])
