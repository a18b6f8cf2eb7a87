"""Does the detector give an image the same bits whatever batch it is in?

    python -m waymo_2d_tracking_tpu_torch.tools.batch_place_probe

On the card, with ``configs/config5_full_sweep.yaml``'s detector (ResNet-50
/ FPN 256 P3-P7 at 1280x1920, six TTA views) and seeded random weights, on
a seeded 5-camera rendered clip (640x960 upscaled 2x, as ``chip_smoke.py``
phase P renders its rig):

- batch size: camera 1's first 4 frames as one batch against the same
  frames inside the rig's 20-image batch (4 frames x 5 cameras), the
  largest difference of a head output at P3;
- batch place: camera 1's 20 frames as one batch, its last frame (place 19)
  against the same batch rolled by one (place 0), every TTA view's head
  outputs and the final detections.

Once in the preset's bf16, once in bf16 under ``cudnn.deterministic`` and
once in float32 (TF32 off). Prints one line of the largest differences for
each; the multicam invariant (a rig camera equals its single-camera run)
can hold bit for bit only where both are 0. Exits 1 without a card.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rig_frames(np, cams: int, frames: int):
    """(frames, cams, 1280, 1920, 3) uint8: one seeded clip a camera."""
    from waymo_2d_tracking_tpu_torch.data.synthetic import SyntheticClipConfig, render_video_clip

    out = np.empty((frames, cams, 1280, 1920, 3), np.uint8)
    for c in range(cams):
        clip, _ = render_video_clip(SyntheticClipConfig(num_frames=frames, num_objects=12,
                                                        seed=40 + c), render_hw=(640, 960))
        out[:, c] = clip.repeat(2, axis=1).repeat(2, axis=2)
    return out


def probe(np, torch, rig, dtype: str, deterministic: bool) -> dict:
    from waymo_2d_tracking_tpu_torch.config import load_config
    from waymo_2d_tracking_tpu_torch.data.preprocess import letterbox_batch
    from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
    from waymo_2d_tracking_tpu_torch.pipeline.run import dispatch_detect
    from waymo_2d_tracking_tpu_torch.pipeline.tta import flip_image, scale_image

    torch.backends.cudnn.deterministic = deterministic
    cfg = load_config(os.path.join(ROOT, "configs", "config5_full_sweep.yaml"),
                      {"detector": {"dtype": dtype}})
    runner = DetectorRunner(cfg.detector, device="cuda", seed=0)
    hw = tuple(rig.shape[2:4])

    def images(block):
        x = torch.from_numpy(np.ascontiguousarray(block)).to("cuda")
        return letterbox_batch(x, hw, cfg.detector.image_size)[0]

    def diff(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    lvl = min(cfg.detector.fpn_levels)
    out = {"dtype": dtype, "cudnn_deterministic": deterministic}
    rig_batch = images(rig[:4].reshape((-1,) + rig.shape[2:]))
    alone = images(rig[:4, 0])
    in_rig, _ = runner.forward(rig_batch)
    by_self, _ = runner.forward(alone)
    out["size_4_vs_20_P3"] = max(diff(a[::5], b) for a, b in zip(in_rig[lvl], by_self[lvl]))

    last = images(rig[:20, 0])
    first = torch.roll(last, 1, 0).contiguous()
    for s in cfg.pipeline.tta_scales:
        a, b = (scale_image(x, s) if s != 1.0 else x for x in (last, first))
        for flipped in (False, True):
            ha, _ = runner.forward(flip_image(a) if flipped else a)
            hb, _ = runner.forward(flip_image(b) if flipped else b)
            out[f"place_19_vs_0_view_{s}{'_flip' if flipped else ''}"] = max(
                diff(x[19], y[0]) for level in ha for x, y in zip(ha[level], hb[level]))
    da, db = dispatch_detect(runner, cfg, last), dispatch_detect(runner, cfg, first)
    out["place_19_vs_0_detections"] = max(diff(da.boxes[19], db.boxes[0]),
                                          diff(da.scores[19], db.scores[0]))
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("batch_place_probe: needs a CUDA card", file=sys.stderr)
        return 1
    from waymo_2d_tracking_tpu_torch.ops import _cuda

    _cuda.build_all()
    rig = rig_frames(np, 5, 20)
    for dtype, deterministic in (("bfloat16", False), ("bfloat16", True), ("float32", False)):
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          **probe(np, torch, rig, dtype, deterministic)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
