"""The Swin configuration's pieces of the benchmark: its own reference
``benchmark/reference_swin`` driven through every stage of a run (as
``test_bench_reference.py`` drives a copy), the counting function of
``window_attn_roofline.segments`` against the program's counters, and the two
window-attention readers on hand-made traces (each ``None`` where what it
reads is absent, as on a program without the kernel). On the card: a traced
stretch of ``config4_swin_t.segments`` reports both. The stored
``class_bias_shift`` of ``config4_swin_t`` is re-derived on the card by
``test_bench_harness.py``, which takes every configuration of
``BENCHMARK.json``."""
import json
import sys
import types

import pytest
import torch

from benchmark.conftest import DATA
from benchmark.harness import core, peaks, spec
from benchmark.harness.trace import Trace

torch.set_num_threads(1)
SEED = 2 ** 31 + 1907
CELL = "config4_swin_t.segments"
PKG = "benchmark.reference_swin"
# each entry point of the reference notes its calls here while a test patches it
NOTED = {"model": ("Detector.forward", "init_weights", "set_fake_quant"),
         "preprocess": ("letterbox",), "postprocess": ("select",), "tracker": ("step",)}


def _reader(name):
    return spec.reader({}, name)


@pytest.fixture
def tiny_swin(tmp_path, tiny_bench, monkeypatch):
    """(the tiny bench with ``tiny`` turned into a Swin-T configuration that
    names ``benchmark/reference_swin``, the list of the reference's calls)."""
    entry = next(c for c in tiny_bench["configs"] if c["name"] == "tiny")
    conf = spec.load_json(f"{spec.ROOT}/{entry['file']}")
    conf["reference"] = "benchmark/reference_swin"
    conf["config"]["detector"]["backbone"] = "swin_t"
    (tmp_path / "tiny_swin.json").write_text(json.dumps(conf))
    bench = dict(tiny_bench, configs=[dict(c, file=str(tmp_path / "tiny_swin.json"))
                                      if c["name"] == "tiny" else c
                                      for c in tiny_bench["configs"]])
    calls = []
    for mod, names in NOTED.items():
        m = __import__(f"{PKG}.{mod}", fromlist=["_"])
        for name in names:
            owner, attr = (m, name) if "." not in name else (getattr(m, name.split(".")[0]),
                                                            name.split(".")[1])
            fn = getattr(owner, attr)

            def noted(*a, _fn=fn, _name=f"{mod}.{name}", **kw):
                calls.append(_name)
                return _fn(*a, **kw)
            monkeypatch.setattr(owner, attr, noted)
    return bench, calls


def test_the_swin_configuration_gets_its_own_reference():
    cell = spec.resolve(CELL)
    assert cell["reference"].package == PKG
    assert cell["config"]["config"]["detector"]["backbone"] == "swin_t"
    assert cell["config"]["reduced"] == []
    for mod in spec.REFERENCE_MODULES:
        assert getattr(cell["reference"], mod) is sys.modules[f"{PKG}.{mod}"]


def test_swin_flops_count_the_attention_matmuls():
    """The FLOP count that ``mfu.segments`` reads is the reference's, with
    the window attention's two batched products in it."""
    from torch.utils.flop_counter import FlopCounterMode
    cell = spec.resolve(CELL)
    cfg, ref = cell["config"]["config"], cell["reference"]
    total = core.flops_per_image(ref, cfg)
    with torch.device("meta"):
        model = ref.model.Detector(cfg["detector"]).eval()
        x = torch.empty((1,) + tuple(cfg["detector"]["image_size"]) + (3,))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.backbone(x)
    by_op = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    attn = by_op.get("aten.bmm", 0)
    tokens = sum(t for t, _, _ in _roofline().launches_per_image(cfg["detector"]["image_size"]))
    # two products of 49 x 32 x 49 a (token, head), 2 FLOPs a multiply-add
    per_block = [2 * 2 * 49 * c * t for t, c, _ in
                 _roofline().launches_per_image(cfg["detector"]["image_size"])]
    assert attn == sum(per_block) and tokens > 0
    assert total > counter.get_total_flops() > attn > 0


def _roofline():
    return _reader("window_attn_roofline.segments")


def test_tiny_swin_cell_runs_through_its_reference(tiny_swin):
    bench, calls = tiny_swin
    cell = spec.resolve("tiny.segments", bench, DATA)
    assert cell["reference"].package == PKG
    out = core.result_line(cell, core.run(cell, SEED, 1.0, False, "cpu"))
    assert out["correct"], out["checks"]
    for name in ("model.init_weights", "preprocess.letterbox", "model.Detector.forward",
                 "postprocess.select", "tracker.step"):
        assert name in calls, name
    calls.clear()
    out = core.result_line(cell, core.run(cell, SEED, 1.0, False, "cpu", control=True))
    assert not out["correct"]
    assert "model.set_fake_quant" in calls


def test_roofline_counting_matches_the_programs_counters():
    """The reader's padded tokens a frame are what the program counts."""
    from waymo_2d_tracking_tpu_torch.config import DetectorConfig
    from waymo_2d_tracking_tpu_torch.models.detector import Detector
    from waymo_2d_tracking_tpu_torch.utils import profiling
    hw = (72, 104)
    det = Detector(DetectorConfig(backbone="swin_t", image_size=hw, fpn_channels=32,
                                  head_depth=1, head_channels=32, embed_dim=0,
                                  dtype="float32")).eval()
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            det(torch.zeros((2,) + hw + (3,)))
    got = profiling.counters()
    profiling.reset_counters()
    per_image = _roofline().launches_per_image(hw)
    assert got["window_attn_launches"] == len(per_image) == 12
    assert got["window_attn_tokens"] == 2 * sum(t for t, _, _ in per_image)
    assert [c for _, c, _ in per_image] == [96] * 2 + [192] * 2 + [384] * 6 + [768] * 2


def _event(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _view(kernels, images, launches=None, tokens=None):
    """A 10 ms stretch with ``kernels`` window-attention kernels of 100 us
    each and the program's counters for ``images`` images."""
    ev = [_event("user_annotation", "bench/stretch", 0, 10000)]
    for i in range(kernels):
        ev.append(_event("kernel", "void (anonymous namespace)::window_attention_kernel"
                         "<__nv_bfloat16>(...)", 100 + 200 * i, 100, tid=99, corr=i))
    ev.append(_event("kernel", "other", 9000, 500, tid=99))
    cfg = {"detector": {"backbone": "swin_t", "image_size": [640, 960]}}
    per_image = _roofline().launches_per_image((640, 960))
    counters = {"frames_real": images, "frames_pad": 0,
                "window_attn_launches": kernels if launches is None else launches,
                "window_attn_tokens": (images * sum(t for t, _, _ in per_image)
                                       if tokens is None else tokens)}
    return types.SimpleNamespace(trace=Trace(ev), cfg=cfg, info={"cam_frames": images},
                                 peaks=peaks), counters


def test_window_readers_on_a_synthetic_trace(monkeypatch):
    ms = _reader("window_attn_ms_per_frame.segments")
    roof = _roofline()
    view, counters = _view(kernels=24, images=80)       # two 40-image forwards
    monkeypatch.setattr(roof, "_counters", lambda: counters)
    assert ms.read(view) == pytest.approx(24 * 0.1 / 80)
    per_image = roof.launches_per_image((640, 960))
    want = sum(max((8 * c * t * 80 + 169 * h * 4 * 2) / peaks.HBM_BYTES_PER_S,
                   196 * c * t * 80 / peaks.BF16_FLOPS_PER_S) for t, c, h in per_image)
    assert roof.read(view) == pytest.approx(100 * want / (24 * 100e-6))
    assert want == pytest.approx(80 * 150.9e6 / peaks.HBM_BYTES_PER_S, rel=1e-3)


@pytest.mark.parametrize("case", ["no kernel", "no counters", "launches", "tokens", "resnet"])
def test_window_readers_read_nothing_without_their_sources(monkeypatch, case):
    roof = _roofline()
    view, counters = _view(kernels=0 if case in ("no kernel", "resnet") else 12, images=40,
                           launches=11 if case == "launches" else None,
                           tokens=1 if case == "tokens" else None)
    if case == "resnet":        # a ResNet cell: no kernel, and no window counters either
        view.cfg["detector"]["backbone"] = "resnet50"
        counters = {"frames_real": 40, "frames_pad": 0}
    monkeypatch.setattr(roof, "_counters", lambda: {} if case == "no counters" else counters)
    assert roof.read(view) is None
    if case in ("no kernel", "resnet"):
        assert _reader("window_attn_ms_per_frame.segments").read(view) is None


@pytest.mark.card
def test_traced_swin_cell_reports_the_window_metrics(card):
    cell = spec.resolve(CELL)
    res = core.run(cell, SEED, 0.0, True, "cuda")
    out = core.result_line(cell, res)
    assert out["correct"], out["checks"]
    for m in cell["per_layer"]:
        assert m["name"] in out["metrics"], m["name"]
    assert 0 < out["metrics"]["window_attn_roofline.segments"]["value"] <= 100
