"""The reader of ``track_overlap_share.segments``: on hand-made counter
dicts, ``None`` where the program has no such counters (a program whose
tracker runs on the driver's stream) or tracked no chunk on the tracker
stream, the share otherwise; on traced tiny runs on the CPU of a single
camera and of a rig, where the tracker runs its eager loop on no stream and
counts nothing, ``None`` too. On the card the counters are exercised by
``tests/test_torch_track_stream.py``."""
import json
import os
import types

import pytest
import torch

from benchmark.conftest import DATA
from benchmark.harness import core, spec
from benchmark.harness.trace import Trace

torch.set_num_threads(1)
SEED = 2 ** 31 + 2309
NAME = "track_overlap_share.segments"


def _read():
    return spec.reader({}, NAME).read(types.SimpleNamespace(trace=Trace([]), info={}))


@pytest.mark.parametrize("counts, want", [
    ({"track_chunks": 25, "track_overlapped": 24, "frames_real": 990}, 96.0),
    ({"track_chunks": 2, "track_overlapped": 1}, 50.0),
    ({"track_chunks": 4, "track_overlapped": 0}, 0.0),
    ({"track_chunks": 4, "track_overlapped": 4}, 100.0),
    ({"frames_real": 40, "prefetch_chunks": 5}, None),      # no such counters
    ({"track_chunks": 3}, None),                             # one of the two missing
    ({"track_chunks": 0, "track_overlapped": 0}, None),     # no chunk on the stream
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
    """The CPU path tracks each chunk eagerly: no ``track_*`` counter, and
    the reader gives ``None`` without raising."""
    from waymo_2d_tracking_tpu_torch.utils import profiling
    with open(os.path.join(DATA, "bench.json")) as f:
        cell = spec.resolve(cell_name, json.load(f), DATA)
    profiling.reset_counters()
    core.run(cell, SEED, 0.0, True, "cpu")
    c = profiling.counters()
    assert c["frames_real"] > 0
    assert not [k for k in c if k.startswith("track_") and k != "track_live"]
    assert _read() is None
