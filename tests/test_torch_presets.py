"""The shipped presets in the port: every ``configs/*.yaml`` that no other
port test pins loads into the port's ``Config`` equal to the JAX package's
``load_config``, and the tracker half of ``configs/robust.yaml`` holds the
JAX package's own contract (``tests/golden/test_preset_quality.py``
``test_robust_preset_quality``).

``Tracker.run`` on the golden synthetic clip (200 frames, 12 objects, seed
0) and on the hostile ``occl_dips`` clip, under robust's tracker section and
under the headline's, against JAX's ``Tracker.run`` on the same detections:
exact ``valid`` and ids, boxes within 0.2 px, MOT metrics equal (MOTP within
1e-6). Then JAX's floors in the port: MOTA >= 0.92, IDF1 >= 0.95, IDSW <= 3
on the golden clip, and robust ahead of the headline on ``occl_dips`` by
0.05 MOTA and 0.04 IDF1.
"""
import concurrent.futures
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.config import load_config as jax_load_config
from waymo_2d_tracking_tpu.data import synthetic as jsynthetic
from waymo_2d_tracking_tpu.eval import mot as jmot
from waymo_2d_tracking_tpu.tracker import Tracker as JaxTracker

from waymo_2d_tracking_tpu_torch.config import load_config
from waymo_2d_tracking_tpu_torch.data import synthetic
from waymo_2d_tracking_tpu_torch.eval import mot
from waymo_2d_tracking_tpu_torch.tracker import Tracker

torch.set_num_threads(1)

CONFIGS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs")
# the golden clip of tests/golden/test_preset_quality.py
GOLDEN = dict(num_frames=200, num_objects=12, seed=0)


def _preset(name):
    return os.path.join(CONFIGS_DIR, name)


# every preset but those test_torch_isolation.py pins to chip_smoke.py's
# dicts (headline, headline_int8, headline_centernet, config4_multicam)
@pytest.mark.parametrize("name", ["config1_tracker_cpu", "config2_detector_iou",
                                  "config3_reid_fused", "config5_full_sweep", "fast",
                                  "production", "robust", "train_detector"])
def test_preset_loads_as_in_jax(name):
    path = _preset(f"{name}.yaml")
    got, want = load_config(path), jax_load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _clips():
    return {"golden": (synthetic.SyntheticClipConfig(**GOLDEN),
                       jsynthetic.SyntheticClipConfig(**GOLDEN)),
            "occl_dips": (synthetic.HOSTILE_CLIPS["occl_dips"],
                          jsynthetic.HOSTILE_CLIPS["occl_dips"])}


def _jax_run(preset, clip):
    jdets, jgt = jsynthetic.generate_clip(_clips()[clip][1])
    _, jout = JaxTracker(jax_load_config(_preset(preset)).tracker).run(jdets)
    return jdets, jgt, jax.device_get(jout)


def run_presets(presets, clips):
    """{(preset, clip): port MotMetrics} for each preset's tracker section on
    each clip, the port's ids and boxes held to JAX's on the same
    detections. The JAX runs go on a second thread while the port runs
    (XLA leaves the interpreter lock while it computes): each side's
    auctions take seconds on these clips."""
    cases = [(p, c) for p in presets for c in clips]
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        futures = {case: pool.submit(_jax_run, *case) for case in cases}
        return {(p, c): _compare(p, c, *futures[(p, c)].result(timeout=600))
                for p, c in cases}


def _compare(preset, clip, jdets, jgt, jout):
    pclip = _clips()[clip][0]
    dets, gt = synthetic.generate_clip(pclip)
    np.testing.assert_array_equal(dets.boxes.numpy(), np.asarray(jdets.boxes))
    _, out = Tracker(load_config(_preset(preset)).tracker, device="cpu").run(dets)
    out = out.to_numpy()
    jvalid = np.asarray(jout.valid)
    ids = np.where(out.valid, out.track_id, -1)
    jids = np.where(jvalid, np.asarray(jout.track_id), -1)
    differ = np.nonzero((ids != jids).any(1) | (out.valid != jvalid).any(1))[0]
    assert differ.size == 0, f"{preset} on {clip}: ids differ from frame {differ[:1]}"
    np.testing.assert_allclose(np.where(out.valid[..., None], out.boxes, 0.0),
                               np.where(jvalid[..., None], np.asarray(jout.boxes), 0.0),
                               atol=0.2)
    n = pclip.num_frames
    got = mot.evaluate_mot(mot.gt_to_frames(gt), mot.track_outputs_to_frames(out, n))
    want = jmot.evaluate_mot(jmot.gt_to_frames(jgt), jmot.track_outputs_to_frames(jout, n))
    got_d, want_d = got.as_dict(), want.as_dict()
    assert got_d.pop("motp") == pytest.approx(want_d.pop("motp"), abs=1e-6)
    assert got_d == want_d
    return got


@pytest.fixture(scope="module")
def golden():
    return run_presets(("robust.yaml", "headline.yaml"), ("golden",))


@pytest.mark.parametrize("preset", ["robust.yaml", "headline.yaml"])
def test_golden_clip_floor_and_ids_equal_jax(golden, preset):
    m = golden[(preset, "golden")]
    assert m.mota >= 0.92, m.as_dict()
    assert m.idf1 >= 0.95, m.as_dict()
    assert m.num_idsw <= 3, m.as_dict()


def test_robust_is_the_headline_plus_two_knobs():
    r, h = load_config(_preset("robust.yaml")), load_config(_preset("headline.yaml"))
    assert r.detector == h.detector
    assert dataclasses.replace(r.tracker, byte_low_threshold=0.0, iou_buffer=0.0) == h.tracker
    assert (r.tracker.byte_low_threshold, r.tracker.iou_buffer) == (0.1, 0.3)
