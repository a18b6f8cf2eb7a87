"""The reader of ``prefetch_ready_share.segments``: on hand-made counter
dicts, ``None`` where the program has no such counters (a program whose
prefetcher does not count them); on traced tiny runs on the CPU of a single
camera and of a rig, both fed by the prefetcher a chunk at a time."""
import json
import os
import types

import pytest
import torch

from benchmark.conftest import DATA
from benchmark.harness import core, spec
from benchmark.harness.trace import Trace

torch.set_num_threads(1)
SEED = 2 ** 31 + 1703
NAME = "prefetch_ready_share.segments"


def _reader():
    return spec.reader({}, NAME)


@pytest.mark.parametrize("counts, want", [
    ({"prefetch_chunks": 8, "prefetch_ready": 6, "frames_real": 40}, 75.0),
    ({"prefetch_chunks": 4, "prefetch_ready": 0}, 0.0),
    ({"prefetch_chunks": 4, "prefetch_ready": 4}, 100.0),
    ({"frames_real": 40, "prefetch_fill_s": 0.5}, None),     # no such counters
    ({"prefetch_chunks": 0, "prefetch_ready": 0}, None),     # nothing taken
])
def test_reader_on_hand_made_counters(monkeypatch, counts, want):
    from waymo_2d_tracking_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    got = _reader().read(types.SimpleNamespace(trace=Trace([]), info={}))
    assert got == (None if want is None else pytest.approx(want))


def test_reader_without_a_counter_registry(monkeypatch):
    from waymo_2d_tracking_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "counters")
    assert _reader().read(types.SimpleNamespace(trace=Trace([]), info={})) is None


@pytest.mark.parametrize("cell_name", ["tiny.segments", "tiny_rig.segments"])
def test_reader_on_a_traced_tiny_run(cell_name):
    """Both drivers take every chunk of the stretch from the prefetcher:
    10 frames in chunks of 4 a unit."""
    from waymo_2d_tracking_tpu_torch.utils import profiling
    with open(os.path.join(DATA, "bench.json")) as f:
        cell = spec.resolve(cell_name, json.load(f), DATA)
    profiling.reset_counters()
    res = core.run(cell, SEED, 0.0, True, "cpu")
    units, frames = res["trace"]["attempted"], cell["traffic"]["frames"]
    chunk = cell["config"]["config"]["pipeline"]["chunk_frames"]
    c = profiling.counters()
    assert c["prefetch_chunks"] == units * -(-frames // chunk)
    got = _reader().read(types.SimpleNamespace(trace=Trace([]), info={}))
    assert got == pytest.approx(100.0 * c["prefetch_ready"] / c["prefetch_chunks"])
    assert 0.0 <= got <= 100.0
