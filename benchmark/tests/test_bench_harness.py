"""The harness's parts on their own: files found by name, the window's
rate, due-time percentiles, the trace's union of intervals, the work
counts, the FLOP counter, the frame generator and the stored class-bias
shifts."""
import json
import os
import shutil
import time
import types
from collections import defaultdict

import numpy as np
import pytest
import torch

from benchmark.conftest import DATA
from benchmark.harness import frames, peaks, spec
from benchmark.harness.trace import Trace, union_length

torch.set_num_threads(1)


def test_cell_and_metric_found_by_name_from_files(tiny_cell):
    cell = tiny_cell("tiny.segments")
    assert cell["config"]["config"]["detector"]["backbone"] == "resnet18slim"
    assert cell["traffic"]["kind"] == "segments"
    assert spec.runner(cell).__name__.endswith("segments")
    names = [m["name"] for m in cell["per_layer"]]
    assert "tracker_ms_per_frame.segments" in names and "tick_idle_share.live" not in names
    assert callable(spec.reader(cell, "mfu.segments").read)


def test_adding_a_cell_is_adding_files(tmp_path, tiny_bench):
    shutil.copytree(DATA, tmp_path / "data")
    with open(tmp_path / "data" / "traffic" / "tiny_burst.json", "w") as f:
        json.dump({"kind": "live", "rate_hz": 20, "frames": 4, "objects": [1, 2],
                   "source_hw": [64, 96], "timestamp_step_us": 50000}, f)
    with open(tmp_path / "data" / "workloads" / "tiny.burst.json", "w") as f:
        json.dump({"bank_groups": 1, "check_chunks": 1, "trace_units": 2, "limits": {}}, f)
    bench = dict(tiny_bench, workloads=tiny_bench["workloads"] + [
        {"name": "tiny.burst", "config": "tiny", "traffic": "tiny_burst", "chips": 1}])
    cell = spec.resolve("tiny.burst", bench, str(tmp_path / "data"))
    assert cell["traffic"]["rate_hz"] == 20 and spec.runner(cell).__name__.endswith("live")
    with pytest.raises(KeyError):
        spec.resolve("tiny.absent", bench, str(tmp_path / "data"))


def _segments_ctx(seconds):
    return types.SimpleNamespace(seconds=seconds, cams=2, traffic={"frames": 10},
                                 probe=types.SimpleNamespace(begin=lambda k: None,
                                                             host_s=defaultdict(float)),
                                 out_dir="/nonexistent", _made=[])


def test_whole_window_rate(monkeypatch):
    from benchmark.traffic import segments
    ctx = _segments_ctx(0.05)
    monkeypatch.setattr(segments, "_segments", lambda ctx, k: [k, k])

    def drive(ctx, units, out_dir):
        for _ in units:
            time.sleep(0.02)
    monkeypatch.setattr(segments, "_drive", drive)
    out = segments.window(ctx)
    # whole units: the window runs past 0.05 s to the end of the unit that crosses it
    assert ctx.units_done == 3 and out["attempted"] == 3
    assert out["seconds"] >= 0.06
    assert out["metrics"]["cam_frames_per_s"] == pytest.approx(3 * 2 * 10 / out["seconds"])


def test_due_time_percentiles_count_a_stall_on_later_ticks():
    from benchmark.traffic import live
    stall = {3: 0.25}

    class Sess:
        def reset(self):
            pass

        def step(self, frames, ts):
            time.sleep(stall.get(ts // 100000, 0.001))
            return []
    ctx = types.SimpleNamespace(traffic={"rate_hz": 20, "frames": 100, "timestamp_step_us": 100000},
                                cams=2, bank_np=np.zeros((1, 2, 100, 1, 1, 3), np.uint8),
                                sess=Sess(), probe=types.SimpleNamespace(begin=lambda k: None))
    due, start, done, _ = live._ticks(ctx, 10, False)
    lat = (done - due) * 1e3
    assert lat[3] >= 250
    # ticks 4 and 5 were due during the stall: their latency counts the wait
    assert lat[4] >= 190 and lat[5] >= 140
    assert start[4] - due[4] >= 0.19
    assert lat[9] < 40


def _event(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_union_of_intervals_and_layers():
    assert union_length([(0, 10), (5, 15), (20, 30), (25, 26)]) == 25
    events = [
        _event("user_annotation", "bench/stretch", 0, 100),
        _event("user_annotation", "bench/tracker", 10, 30),
        _event("cuda_runtime", "cudaGraphLaunch", 12, 1, corr=7),
        _event("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=8),
        _event("kernel", "auction_kernel", 20, 10, tid=99, corr=7),
        _event("kernel", "other", 25, 10, tid=99, corr=8),
        _event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 70, 10, tid=98, corr=1),
        _event("cpu_op", "aten::copy_", 82, 10),
    ]
    tr = Trace(events)
    assert tr.window_s() == pytest.approx(100e-6)
    assert tr.busy_s() == pytest.approx(25e-6)        # [20, 35] and [70, 80]
    assert tr.layer_s("tracker") == pytest.approx(10e-6)
    assert tr.layer_s("staging") == pytest.approx(10e-6)
    assert tr.layer_s("other") == pytest.approx(10e-6)
    assert tr.busy_s(0, 30) == pytest.approx(10e-6)
    gaps = [(n, round(s * 1e6)) for n, s in tr.idle_gaps(3)]
    assert gaps[0] == ("bench/stretch", 35)        # [35, 70]: the host between ops
    assert ("aten::copy_", 20) in gaps             # [80, 100]: the host in a copy


def test_work_counts_from_shapes():
    b, ops = peaks.auction_work(5, 128)
    assert b == 5 * (4 * 128 * 128 + 4 * 128) and ops == 5 * 128 * 128
    assert peaks.least_seconds(b, ops) == pytest.approx(b / peaks.HBM_BYTES_PER_S)
    b, ops = peaks.nms_work(1024, 3000)
    assert (b, ops) == (18 * 1024, 14 * 3000)
    assert peaks.least_seconds(1.0, 67e12) == pytest.approx(1.0)


def test_flop_counter_counts_a_conv():
    from torch.utils.flop_counter import FlopCounterMode
    k, cin, cout, h, w = 3, 16, 32, 20, 24
    with torch.device("meta"):
        conv = torch.nn.Conv2d(cin, cout, k, padding=1, bias=False)
        x = torch.empty(1, cin, h, w)
    with FlopCounterMode(display=False) as c:
        conv(x)
    assert c.get_total_flops() == 2 * k * k * cin * cout * h * w


def test_frame_generator_is_seeded():
    a, na = frames.draw_bank(2 ** 33 + 5, 1, 2, 3, (2, 6), (32, 48), "cpu")
    b, nb = frames.draw_bank(2 ** 33 + 5, 1, 2, 3, (2, 6), (32, 48), "cpu")
    c, nc = frames.draw_bank(2 ** 33 + 6, 1, 2, 3, (2, 6), (32, 48), "cpu")
    assert torch.equal(a, b) and na == nb
    assert not torch.equal(a, c)
    assert sorted(na) == sorted(nc) == [2, 6]           # the same scene sizes, dealt anew
    assert a.dtype == torch.uint8 and a.shape == (1, 2, 3, 32, 48, 3)


def _weights_case(bench: dict, base: str, config: str):
    """A configuration's file and the traffic mix of its first cell."""
    entry = next(c for c in bench["configs"] if c["name"] == config)
    traffic = next(w["traffic"] for w in bench["workloads"] if w["config"] == config)
    with open(os.path.join(spec.ROOT, entry["file"])) as f:
        conf = json.load(f)
    with open(os.path.join(base, "traffic", f"{traffic}.json")) as f:
        return conf, json.load(f)


def _check_stored_shift(conf: dict, traffic: dict, device):
    from benchmark.harness import weights
    got = weights.calibrate(conf["config"], conf["weights"], traffic, device)
    assert got == conf["weights"]["class_bias_shift"]
    model = weights.make(conf["config"], conf["weights"], device)
    fresh = weights.make(conf["config"], conf["weights"], device, shift=0.0)
    assert torch.equal(model.heads.cls_logits.bias, fresh.heads.cls_logits.bias + got)


@pytest.mark.parametrize("config", ["tiny", "tiny_rig"])
def test_stored_class_bias_shift_is_rederived(tiny_bench, config):
    _check_stored_shift(*_weights_case(tiny_bench, DATA, config), "cpu")


with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as _f:
    _CONFIGS = [c["name"] for c in json.load(_f)["configs"]]


@pytest.mark.card
@pytest.mark.parametrize("config", _CONFIGS)
def test_stored_class_bias_shift_of_each_configuration(card, config):
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    _check_stored_shift(*_weights_case(bench, spec.HERE, config), card)
