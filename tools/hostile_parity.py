"""The PyTorch port's tracker against the JAX package's on every hostile clip
and tracker setting, on the CPU.

    JAX_PLATFORMS=cpu python tools/hostile_parity.py [CLIP,...] [SETTING,...]

For each clip of ``data/synthetic.py HOSTILE_CLIPS`` (JAX's clips fed to both
packages) and each setting (``tests/golden/test_hostile_quality.py``'s BASE
and its BYTE 0.1, buffered IoU 0.3, BYTE + buffered IoU, ``motion_gate``
9.4877, NSA Kalman and greedy assignment), runs ``Tracker.run`` in both
packages and prints one JSON line: the first frame whose ids or ``valid``
differ (null when none), the largest box difference over valid slots, and
each package's seconds. ``tests/test_torch_hostile*.py`` hold five of these
runs; this sweeps all of them.
"""
import dataclasses
import json
import os
import sys
import time

import jax
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from waymo_2d_tracking_tpu.config import KalmanConfig as JaxKalmanConfig  # noqa: E402
from waymo_2d_tracking_tpu.config import TrackerConfig as JaxTrackerConfig  # noqa: E402
from waymo_2d_tracking_tpu.data.synthetic import HOSTILE_CLIPS, generate_clip  # noqa: E402
from waymo_2d_tracking_tpu.tracker import Tracker as JaxTracker  # noqa: E402

from waymo_2d_tracking_tpu_torch.config import KalmanConfig, TrackerConfig  # noqa: E402
from waymo_2d_tracking_tpu_torch.tracker import Tracker  # noqa: E402
from waymo_2d_tracking_tpu_torch.types import Detections  # noqa: E402

BASE = JaxTrackerConfig(
    max_tracks=64, max_detections=64, embed_dim=128,
    appearance_weight=0.3, appearance_gate=0.5,
    n_init=3, max_age=3, iou_threshold=0.3,
    reid_recovery=True, max_lost_age=30, gallery_size=4,
)
SETTINGS = {
    "base": BASE,
    "byte": dataclasses.replace(BASE, byte_low_threshold=0.1),
    "biou": dataclasses.replace(BASE, iou_buffer=0.3),
    "byte_biou": dataclasses.replace(BASE, byte_low_threshold=0.1, iou_buffer=0.3),
    "mgate": dataclasses.replace(BASE, motion_gate=9.4877),
    "nsa": dataclasses.replace(BASE, kalman=JaxKalmanConfig(nsa=True)),
    "greedy": dataclasses.replace(BASE, assignment="greedy"),
}


def port_config(jax_cfg) -> TrackerConfig:
    d = dataclasses.asdict(jax_cfg)
    return TrackerConfig(**{**d, "kalman": KalmanConfig(**d["kalman"])})


def main(clips, settings):
    for clip in clips:
        dets, _ = generate_clip(HOSTILE_CLIPS[clip])
        for name in settings:
            cfg = SETTINGS[name]
            t0 = time.perf_counter()
            _, jout = JaxTracker(cfg).run(dets)
            jout = jax.device_get(jout)
            jax_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, out = Tracker(port_config(cfg), device="cpu").run(Detections.from_numpy(dets))
            out = out.to_numpy()
            port_s = time.perf_counter() - t0
            jvalid = np.asarray(jout.valid)
            ids = np.where(out.valid, out.track_id, -1)
            jids = np.where(jvalid, jout.track_id, -1)
            differ = np.nonzero((ids != jids).any(1) | (out.valid != jvalid).any(1))[0]
            both = (out.valid & jvalid)[..., None]
            box = float(np.abs(np.where(both, out.boxes - jout.boxes, 0.0)).max())
            print(json.dumps({"clip": clip, "setting": name,
                              "first_differing_frame": int(differ[0]) if differ.size else None,
                              "max_box_diff": box, "jax_s": round(jax_s, 1),
                              "port_s": round(port_s, 1)}), flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(sys.argv[1].split(",") if len(sys.argv) > 1 else list(HOSTILE_CLIPS),
         sys.argv[2].split(",") if len(sys.argv) > 2 else list(SETTINGS))
