"""Exported detect program (``export``; counterpart of ``io_out/export_tf.py``).

The JAX package exports its jitted detect step (images -> boxes / scores /
classes / embeds / valid, weights baked in) as a TF SavedModel. The port
exports the same step with ``torch.export.export`` at a static batch and
saves it with ``torch.export.save`` (a ``.pt2`` archive), beside a JSON
sidecar that states the input shape and dtype, the platform and the TTA
views. The step goes through ``pipeline/run.py dispatch_detect``, so a TTA
preset exports the TTA union.

The NMS keep-mask is the operator ``w2t::nms_mask`` (``ops/nms.py``), one
node of the exported graph:
- ``platform='cuda'``: the program is traced on the card and runs there, the
  node launching the hand-written NMS kernel;
- ``platform='cpu'``: the program runs on the CPU, the node running the
  plain version (tracing the plain version itself would unroll its N-step
  loop, 1024 steps at the headline).
Either way a process that loads the artifact must first import
``waymo_2d_tracking_tpu_torch.ops.nms``, which registers the operator
(``load_program`` does); the JAX package's ``cpu`` artifact needs nothing of
JAX. No TensorFlow is involved.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch

from waymo_2d_tracking_tpu_torch.config import Config
from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
from waymo_2d_tracking_tpu_torch.pipeline.run import dispatch_detect, tta_active

PLATFORMS = ("cpu", "cuda")
OUTPUTS = ("boxes", "scores", "classes", "embeds", "valid")


class DetectProgram(torch.nn.Module):
    """The detect step as a module: images (B, H, W, 3) float32 -> a dict of
    the detections' fields. ``detector`` holds the weights so that export
    lifts them into the program."""

    def __init__(self, runner: DetectorRunner, cfg: Config):
        super().__init__()
        self.runner = runner
        self.cfg = cfg
        self.detector = runner.module

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        dets = dispatch_detect(self.runner, self.cfg, images)
        return {name: getattr(dets, name) for name in OUTPUTS}


def make_detect_fn(cfg, state_dict: Optional[Dict[str, torch.Tensor]], platform: str,
                   seed: int = 0):
    """(``DetectProgram`` on the platform's device, (h, w)). ``cfg`` is the
    full Config (a bare DetectorConfig is wrapped with the default, TTA-off
    pipeline). An int8 detector must carry calibrated scales: they are baked
    into the artifact, so an uncalibrated one is refused here."""
    if platform not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}, got {platform!r}")
    if not hasattr(cfg, "detector"):
        cfg = Config(detector=cfg)
    runner = DetectorRunner(cfg.detector, state_dict, device=platform, seed=seed)
    runner.check_calibrated()
    return DetectProgram(runner, cfg), tuple(cfg.detector.image_size)


def export_program(cfg, state_dict: Optional[Dict[str, torch.Tensor]], out: str,
                   batch_size: int = 1, platform: str = "cuda", seed: int = 0) -> dict:
    """Export the detect step to ``out`` (``.pt2``) with its sidecar
    ``out + ".json"``; returns the sidecar's content."""
    program, (h, w) = make_detect_fn(cfg, state_dict, platform, seed=seed)
    example = torch.zeros((batch_size, h, w, 3), dtype=torch.float32,
                          device=program.runner.device)
    # the calibration was checked above; the check's host read cannot be
    # traced. Inference IR (run_decompositions): no grad-mode regions left,
    # the operator w2t::nms_mask kept as it is.
    with program.runner.uncalibrated_ok(), torch.no_grad():
        ep = torch.export.export(program, (example,)).run_decompositions({})
    torch.export.save(ep, out)
    full = program.cfg
    tta = ({"scales": list(full.pipeline.tta_scales), "flip": bool(full.pipeline.tta_flip)}
           if tta_active(full.pipeline) else None)
    info = {
        "out": out,
        "platform": platform,
        "batch_size": batch_size,
        "image_size": [h, w],
        "input": {"shape": [batch_size, h, w, 3], "dtype": "float32"},
        "tta": tta,
        "signature": "detect(images: float32[b,h,w,3]) -> "
                     "{boxes, scores, classes, embeds, valid}",
        "needs": "import waymo_2d_tracking_tpu_torch.ops.nms (operator w2t::nms_mask)",
    }
    with open(out + ".json", "w") as f:
        json.dump(info, f, indent=2)
    return info


def load_program(out: str):
    """The exported program as a callable module (the operator is registered
    by ``ops/nms.py``, which this module's imports load)."""
    return torch.export.load(out).module()


def load_and_run(out: str, images: np.ndarray) -> Dict[str, np.ndarray]:
    """Reload an exported program and run it on host images, on the
    platform it was exported for."""
    with open(out + ".json") as f:
        info = json.load(f)
    program = load_program(out)
    outs = program(torch.as_tensor(np.asarray(images, np.float32), device=info["platform"]))
    return {k: v.detach().cpu().numpy() for k, v in outs.items()}
