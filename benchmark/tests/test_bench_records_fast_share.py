"""The reader of ``records_fast_share.segments``: on hand-made counter
dicts, ``None`` where the program has no such counters (a program whose
records layer does not count its lines) or wrote none; on traced tiny runs
on the CPU of a single camera and of a rig, whose every line takes the
template."""
import json
import os
import types

import pytest
import torch

from benchmark.conftest import DATA
from benchmark.harness import core, spec
from benchmark.harness.trace import Trace

torch.set_num_threads(1)
SEED = 2 ** 31 + 2011
NAME = "records_fast_share.segments"


def _read():
    return spec.reader({}, NAME).read(types.SimpleNamespace(trace=Trace([]), info={}))


@pytest.mark.parametrize("counts, want", [
    ({"records_lines": 7438, "records_lines_slow": 0, "frames_real": 990}, 100.0),
    ({"records_lines": 8, "records_lines_slow": 2}, 75.0),
    ({"records_lines": 4, "records_lines_slow": 4}, 0.0),
    ({"frames_real": 40, "prefetch_chunks": 4}, None),      # no such counters
    ({"records_lines": 0, "records_lines_slow": 0}, None),  # no line written
])
def test_reader_on_hand_made_counters(monkeypatch, counts, want):
    from waymo_2d_tracking_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    got = _read()
    assert got == (None if want is None else pytest.approx(want))


def test_reader_without_a_counter_registry(monkeypatch):
    from waymo_2d_tracking_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "counters")
    assert _read() is None


@pytest.mark.parametrize("cell_name", ["tiny.segments", "tiny_rig.segments"])
def test_reader_on_a_traced_tiny_run(cell_name):
    """One track file a camera of each unit of the stretch, every line
    from the template."""
    from waymo_2d_tracking_tpu_torch.utils import profiling
    with open(os.path.join(DATA, "bench.json")) as f:
        cell = spec.resolve(cell_name, json.load(f), DATA)
    profiling.reset_counters()
    core.run(cell, SEED, 0.0, True, "cpu")
    c = profiling.counters()
    assert c["records_lines"] > 0 and c["records_lines_slow"] == 0
    assert _read() == 100.0
