"""Config 5 end to end: ``configs/config5_full_sweep.yaml`` through the
port's ``MultiCamPipeline.run_segments_group`` against the JAX package's,
on the CPU. Five cameras, chunk 4, six TTA views (flip x scales 0.75 / 1.0 /
1.25: the 1.25 view of the 64x96 letterbox is 80x120, which the coarsest
stride, 32, does not divide), ReID recovery (max_lost_age 30) and gap fill
(``interp_max_gap`` 5) as shipped; the detector narrowed to the slim size
of ``test_torch_presets_e2e.py``, whose docstring states the reduction, the
weights and the tolerances.

One chunk of 4 frames a camera: JAX's camera-vmapped auction takes about
2.5 s a frame on the CPU once tracks are born, so the JAX side runs on a
second thread while the port runs."""
import concurrent.futures
import os

import numpy as np

from waymo_2d_tracking_tpu.io_out import submission as jsubm
from waymo_2d_tracking_tpu.pipeline.multicam import MultiCamPipeline as JaxMultiCam
from waymo_2d_tracking_tpu.pipeline.run import SegmentFrames as JaxFrames

from waymo_2d_tracking_tpu_torch.pipeline.multicam import MultiCamPipeline
from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames

from test_torch_presets_e2e import _assert_records_equal, _configs, _frames, _weights


def test_config5_multicam_tta_matches_jax(tmp_path):
    """Five cameras, chunk 4, six views (flip x scales 0.75 / 1.0 / 1.25),
    ReID recovery and gap fill through ``run_segments_group`` in both
    packages: every camera's JSONL equal, the gallery sidecars' ids equal."""
    cfg, jcfg = _configs("config5_full_sweep.yaml")
    assert (len(cfg.pipeline.cameras), cfg.pipeline.chunk_frames,
            tuple(cfg.pipeline.tta_scales), cfg.pipeline.tta_flip,
            cfg.pipeline.interp_max_gap) == (5, 4, (0.75, 1.0, 1.25), True, 5)
    variables, sd = _weights(jcfg)
    cams = len(cfg.pipeline.cameras)
    num_frames = cfg.pipeline.chunk_frames
    ts = [100 * t for t in range(num_frames)]
    frames = [_frames(num_frames, seed=40 + c, hw=(64, 96)) for c in range(cams)]

    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        jstats = pool.submit(
            JaxMultiCam(jcfg, num_cams=cams, params=variables).run_segments_group,
            [JaxFrames(context_name="cfg5", camera_name=c + 1, timestamps=ts, frames=frames[c])
             for c in range(cams)], jout)
        stats = MultiCamPipeline(cfg, num_cams=cams, state_dict=sd,
                                 device="cpu").run_segments_group(
            [SegmentFrames("cfg5", c + 1, ts, frames[c]) for c in range(cams)], out)
        assert stats == jstats.result(timeout=600)
    for c in range(1, cams + 1):
        name = f"cfg5_{c}.jsonl"
        _assert_records_equal(jsubm.read_jsonl(os.path.join(out, name)),
                              jsubm.read_jsonl(os.path.join(jout, name)))
        side = np.load(os.path.join(out, f"cfg5_{c}.gallery.npz"))
        jside = np.load(os.path.join(jout, f"cfg5_{c}.gallery.npz"))
        np.testing.assert_array_equal(side["track_id"], jside["track_id"])
