"""The port's tracker search (``pipeline/tune.py``, ``tune``) against the JAX
package's: the same report for the same seed and data, serial and over a
spawned process pool."""
import dataclasses

import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.config import load_config as jax_load_config
from waymo_2d_tracking_tpu.data.synthetic import SyntheticClipConfig, generate_clip
from waymo_2d_tracking_tpu.io_out import submission as jsubm
from waymo_2d_tracking_tpu.pipeline import tune as jtune

from waymo_2d_tracking_tpu_torch.config import load_config
from waymo_2d_tracking_tpu_torch.io_out import submission
from waymo_2d_tracking_tpu_torch.pipeline import tune

torch.set_num_threads(1)

OVERRIDES = {"tracker": {"max_tracks": 16, "max_detections": 16, "embed_dim": 0,
                         "appearance_weight": 0.0, "reid_recovery": False,
                         "birth_score_threshold": 0.3, "n_init": 1}}


def _scene(num_frames=40):
    """A synthetic clip's detections (noise, misses, clutter) and its ground
    truth as JAX records."""
    dets, gt = generate_clip(SyntheticClipConfig(num_frames=num_frames, num_objects=6,
                                                 max_detections=16, embed_dim=1, seed=7))
    dets = type(dets)(**{f.name: np.asarray(getattr(dets, f.name))
                         for f in dataclasses.fields(dets)})
    stamps = [1_000_000 + 100_000 * t for t in range(num_frames)]
    det_rows = jsubm.records_from_detections(dets, "ctx", stamps, 1)
    gt_rows = [jsubm.TrackRecord.from_xyxy("ctx", stamps[t], 1, f"gt{k}", 1, gt["boxes"][t, k], 1.0)
               for t in range(num_frames) for k in np.flatnonzero(gt["present"][t])]
    return det_rows, gt_rows


def _port(rows):
    return [submission.TrackRecord(**dataclasses.asdict(r)) for r in rows]


def _same_report(got, want):
    assert {k: got[k] for k in ("objective", "trials", "seed", "best_overrides")} == \
        {k: want[k] for k in ("objective", "trials", "seed", "best_overrides")}
    assert [r["trial"] for r in got["results"]] == [r["trial"] for r in want["results"]]
    for g, w in zip(got["results"], want["results"]):
        assert g["knobs"] == w["knobs"]
        for k in ("records", "mota", "idf1", "num_idsw", "num_fp", "num_fn"):
            assert g[k] == w[k], (g["trial"], k)
        assert abs(g["motp"] - w["motp"]) <= 1e-6
    assert got["best"]["trial"] == want["best"]["trial"]


@pytest.fixture(scope="module")
def scene():
    det_rows, gt_rows = _scene()
    want = jtune.tune_tracker(det_rows, gt_rows, jax_load_config(None, OVERRIDES), trials=5,
                              seed=3, objective="mota")
    return det_rows, gt_rows, want


def test_knob_helpers_are_the_jax_ones():
    assert sorted(tune.DEFAULT_SPACE) == sorted(jtune.DEFAULT_SPACE)
    assert tune.OBJECTIVES == jtune.OBJECTIVES
    for seed in range(20):
        assert tune.sample_knobs(np.random.default_rng(seed), tune.DEFAULT_SPACE) == \
            jtune.sample_knobs(np.random.default_rng(seed), jtune.DEFAULT_SPACE)
    cfg = tune.apply_knobs(load_config(None, OVERRIDES), {"tracker.max_age": 7,
                                                         "pipeline.interp_max_gap": 3})
    assert (cfg.tracker.max_age, cfg.pipeline.interp_max_gap) == (7, 3)
    with pytest.raises(ValueError, match="unknown knob"):
        tune.apply_knobs(cfg, {"tracker.nope": 1})
    with pytest.raises(ValueError, match="objective"):
        tune.tune_tracker([], [], cfg, objective="hota", device="cpu")


def test_evaluate_records_matches_jax(scene):
    det_rows, gt_rows, _ = scene
    assert tune.evaluate_records(_port(det_rows), _port(gt_rows)) == \
        jtune.evaluate_records(det_rows, gt_rows)


def test_report_matches_jax(scene):
    det_rows, gt_rows, want = scene
    got = tune.tune_tracker(_port(det_rows), _port(gt_rows), load_config(None, OVERRIDES),
                            trials=5, seed=3, objective="mota", device="cpu")
    _same_report(got, want)
    assert len({r["mota"] for r in got["results"]}) > 1


def test_workers_equal_serial(scene):
    det_rows, gt_rows, want = scene
    got = tune.tune_tracker(_port(det_rows), _port(gt_rows), load_config(None, OVERRIDES),
                            trials=5, seed=3, objective="mota", workers=2, device="cpu")
    _same_report(got, want)
