"""The port's tracker against the JAX package's on the hostile-regime clips
(``HOSTILE_CLIPS``), under ``tests/golden/test_hostile_quality.py``'s tracker
configs: exact ``valid`` and ids, boxes within 0.2 px, and equal MOT metrics
(MOTP within 1e-6).

The clips run a whole tracker with embed 128 through the opt-in knobs, where
the auction meets near-ties: the ReID recovery on ``curved_pan`` picks
between two LOST slots whose appearance costs differ by 4e-5 at frame 45, so
the appearance update must carry XLA's bits (``lifecycle.ema_normalize``).
This file holds the three settings that repair held (BASE, NSA and
``motion_gate``); ``test_torch_hostile_knobs.py`` holds BYTE and buffered IoU.
The port's clip table and clips are the JAX package's, field for field and
bit for bit.
"""
import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.config import KalmanConfig as JaxKalmanConfig
from waymo_2d_tracking_tpu.data import synthetic as jsynthetic
from waymo_2d_tracking_tpu.eval import mot as jmot
from waymo_2d_tracking_tpu.tracker import Tracker as JaxTracker

from waymo_2d_tracking_tpu_torch.config import KalmanConfig, TrackerConfig
from waymo_2d_tracking_tpu_torch.data import synthetic
from waymo_2d_tracking_tpu_torch.eval import mot
from waymo_2d_tracking_tpu_torch.tracker import Tracker

torch.set_num_threads(1)


def _golden_configs():
    path = os.path.join(os.path.dirname(__file__), "golden", "test_hostile_quality.py")
    spec = importlib.util.spec_from_file_location("_hostile_quality_configs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {"base": mod.BASE, "byte": mod.BYTE, "byte_biou": mod.BYTE_BIOU,
            "mgate": mod.MGATE,
            "nsa": dataclasses.replace(mod.BASE, kalman=JaxKalmanConfig(nsa=True))}


CONFIGS = _golden_configs()


def port_config(jax_cfg):
    d = dataclasses.asdict(jax_cfg)
    return TrackerConfig(**{**d, "kalman": KalmanConfig(**d["kalman"])})


def compare_on_clip(clip_name, cfg_name):
    jcfg = CONFIGS[cfg_name]
    jdets, gt = jsynthetic.generate_clip(jsynthetic.HOSTILE_CLIPS[clip_name])
    dets, pgt = synthetic.generate_clip(synthetic.HOSTILE_CLIPS[clip_name])
    for f in dataclasses.fields(dets):
        np.testing.assert_array_equal(getattr(dets, f.name).numpy(),
                                      np.asarray(getattr(jdets, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(pgt["boxes"], gt["boxes"])

    _, jout = JaxTracker(jcfg).run(jdets)
    jout = jax.device_get(jout)
    _, out = Tracker(port_config(jcfg), device="cpu").run(dets)
    out = out.to_numpy()
    valid, jvalid = out.valid, np.asarray(jout.valid)
    ids = np.where(valid, out.track_id, -1)
    jids = np.where(jvalid, jout.track_id, -1)
    differ = np.nonzero((ids != jids).any(1) | (valid != jvalid).any(1))[0]
    assert differ.size == 0, f"{clip_name} {cfg_name}: ids differ from frame {differ[:1]}"
    np.testing.assert_allclose(np.where(valid[..., None], out.boxes, 0.0),
                               np.where(jvalid[..., None], jout.boxes, 0.0), atol=0.2)
    n = jsynthetic.HOSTILE_CLIPS[clip_name].num_frames
    want = jmot.evaluate_mot(jmot.gt_to_frames(gt), jmot.track_outputs_to_frames(jout, n))
    got = mot.evaluate_mot(mot.gt_to_frames(pgt), mot.track_outputs_to_frames(out, n))
    got_d, want_d = got.as_dict(), want.as_dict()
    # MOTP averages the boxes' IoU, and the boxes agree to ~1e-4 px, not bit
    # for bit
    assert got_d.pop("motp") == pytest.approx(want_d.pop("motp"), abs=1e-6)
    assert got_d == want_d
    return got


def test_hostile_clip_table_equals_jax():
    assert list(synthetic.HOSTILE_CLIPS) == list(jsynthetic.HOSTILE_CLIPS)
    for name, cfg in synthetic.HOSTILE_CLIPS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jsynthetic.HOSTILE_CLIPS[name]), name


@pytest.mark.parametrize("cfg_name", ["base", "nsa", "mgate"])
def test_curved_pan_ids_equal_jax(cfg_name):
    """Fault E's three settings: before the appearance update carried XLA's
    arithmetic they first differed at frames 45, 45 and 65."""
    m = compare_on_clip("curved_pan", cfg_name)
    if cfg_name == "base":
        assert m.mota >= 0.73, m.as_dict()      # test_hostile_quality.py's floor
