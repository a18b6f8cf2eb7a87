"""The port's gap interpolation (``io_out/postprocess.py``) against the JAX
package's: the cases of ``tests/unit/test_postprocess.py``, each fed to both
packages, outputs equal record for record; and the golden clip's tracker
records with ``interp_max_gap`` through both record writers."""
import dataclasses

import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.io_out import postprocess as jpost
from waymo_2d_tracking_tpu.io_out import submission as jsubm

from waymo_2d_tracking_tpu_torch.io_out import postprocess, submission

torch.set_num_threads(1)

GRID = [1000 * i for i in range(10)]
JITTER = [0, 100_003, 199_998, 300_001, 400_000]


def _rec(ts, oid="a", cx=10.0, cy=20.0, ln=8.0, w=6.0, score=0.9, ctx="c", cam=1, otype=1):
    return dict(context_name=ctx, timestamp_micros=ts, camera_name=cam, object_id=oid,
                object_type=otype, center_x=cx, center_y=cy, length=ln, width=w, score=score)


# (name, on a known grid (True) or grid inferred (False), records, max_gap)
CASES = [
    ("single frame gap", True, [_rec(0, cx=10.0, score=1.0), _rec(2000, cx=30.0, score=0.5)], 1),
    ("gap over max_gap", True, [_rec(0), _rec(4000)], 2),
    ("gap at max_gap", True, [_rec(0), _rec(4000)], 3),
    ("max_gap 0", True, [_rec(0), _rec(3000)], 0),
    ("max_gap 0 offline", False, [_rec(0), _rec(3000)], 0),
    ("no cross-track or cross-camera bleed", True,
     [_rec(0, oid="a"), _rec(2000, oid="a"), _rec(0, oid="b", cx=100.0),
      _rec(2000, oid="b", cx=200.0), _rec(0, oid="a", cam=2, cx=50.0),
      _rec(4000, oid="a", cam=2)], 1),
    ("consecutive frames", True, [_rec(0), _rec(1000), _rec(2000)], 5),
    ("off-grid timestamp", True, [_rec(0), _rec(2500), _rec(4000)], 5),
    ("grid inference with jitter", False,
     [_rec(t, oid="b", cx=5.0) for t in JITTER]
     + [_rec(JITTER[0], oid="a", cx=10.0), _rec(JITTER[2], oid="a", cx=30.0)], 1),
    ("hole in every track", False,
     [_rec(0, oid="a"), _rec(200_000, oid="a"), _rec(0, oid="b", cx=50.0),
      _rec(200_000, oid="b", cx=70.0), _rec(300_000, oid="b", cx=80.0)], 1),
    ("order", True, [_rec(2000, oid="b"), _rec(0, oid="b"), _rec(0, oid="a"),
                     _rec(2000, oid="a")], 1),
    ("order reversed", True, [_rec(2000, oid="a"), _rec(0, oid="a"), _rec(0, oid="b"),
                              _rec(2000, oid="b")], 1),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_interpolation_matches_jax(case):
    name, on_grid, rows, max_gap = case
    got_in = [submission.TrackRecord(**r) for r in rows]
    want_in = [jsubm.TrackRecord(**r) for r in rows]
    if on_grid:
        got = postprocess.interpolate_gaps(got_in, GRID, max_gap)
        want = jpost.interpolate_gaps(want_in, GRID, max_gap)
    else:
        got = postprocess.interpolate_gaps_offline(got_in, max_gap)
        want = jpost.interpolate_gaps_offline(want_in, max_gap)
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    if max_gap and name not in ("consecutive frames", "gap over max_gap"):
        assert len(got) > len(rows), name          # the case fills something


def test_infer_frame_grid_matches_jax():
    for stamps in (JITTER, [0, 200_000, 300_000], [5], [], [0, 1000, 5000, 5999, 9000]):
        assert postprocess.infer_frame_grid(stamps) == jpost.infer_frame_grid(stamps)


def test_golden_clip_records_with_interpolation_match_jax():
    """Tracker outputs of the golden clip through both record writers with
    ``interp_max_gap=5``: the same records, and the pass adds some."""
    from waymo_2d_tracking_tpu.data.synthetic import SyntheticClipConfig, generate_clip
    from waymo_2d_tracking_tpu.tracker import Tracker as JaxTracker
    from waymo_2d_tracking_tpu.config import TrackerConfig as JaxTrackerConfig

    clip = SyntheticClipConfig(num_frames=80, num_objects=8, seed=0)
    dets, _ = generate_clip(clip)
    _, outputs = JaxTracker(JaxTrackerConfig(max_tracks=32, max_detections=64,
                                             embed_dim=0, n_init=3, max_age=6)).run(dets)
    outputs = jax_to_numpy(outputs)
    stamps = list(range(0, clip.num_frames * 1000, 1000))
    want = jsubm.records_from_track_outputs(outputs, "ctx", stamps, 1, interp_max_gap=5)
    got = submission.records_from_track_outputs(outputs, "ctx", stamps, 1, interp_max_gap=5)
    plain = submission.records_from_track_outputs(outputs, "ctx", stamps, 1)
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    assert len(got) > len(plain)


def jax_to_numpy(record):
    return type(record)(**{f.name: np.asarray(getattr(record, f.name))
                           for f in dataclasses.fields(record)})
