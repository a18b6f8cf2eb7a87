"""The benchmark's weights: the program's seeded random scheme drawn on the
card (the configuration's reference, ``model.py init_weights``) from its own
weight seed, then the configuration's stored class-logit bias shift added.

The weights are the configuration's, the same in every run, as a deployed
model is the same for every input: random weights drawn anew from each
run's seed changed the work itself (from no track at all to dozens a frame,
and the tracker's and the records' time with it), so runs on different
seeds measured different systems. The run's seed draws the frames.

The shift is a constant of the configuration, worked out once by
``calibrate`` and stored in its file: the shift at which the float32
reference gives, on ``CALIBRATION_FRAMES`` frames drawn from the weight
seed, one detection at or above the birth gate a frame for each object the
traffic draws on average. ``benchmark/tests`` re-derives it."""
from __future__ import annotations

import torch

from benchmark.harness import check, frames as frames_mod

CALIBRATION_FRAMES = 8


def make(ref, cfg: dict, weights: dict, device, shift: float = None):
    """The reference model (``ref``, the configuration's reference) holding
    the configuration's weights, drawn from ``weights["seed"]`` with
    ``shift`` (default: the stored ``weights["class_bias_shift"]``) added to
    the class-logit bias."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(weights["seed"]))
    model = ref.model.Detector(cfg["detector"]).to(device).eval()
    ref.model.init_weights(model, gen)
    with torch.no_grad():
        model.heads.cls_logits.bias.add_(
            float(weights["class_bias_shift"] if shift is None else shift))
    return model


@torch.no_grad()
def calibrate(ref, cfg: dict, weights: dict, traffic: dict, device, steps: int = 14) -> float:
    """The class-bias shift that ``make`` should be given: bisected until
    the float32 reference's detections at or above the birth gate, a frame,
    reach the mean of the traffic's object counts on frames drawn from the
    weight seed."""
    model = make(ref, cfg, weights, device, shift=0.0)
    calib, _ = frames_mod.draw_bank(int(weights["seed"]), 1, CALIBRATION_FRAMES, 1,
                                    traffic["objects"], tuple(traffic["source_hw"]), device)
    target = sum(traffic["objects"]) / len(traffic["objects"])
    det, gate = cfg["detector"], cfg["tracker"]["birth_score_threshold"]
    with check.precision(False):
        head, _ = check.reference_forward(ref, model, cfg,
                                          calib.reshape((-1,) + calib.shape[3:]), device,
                                          cfg["pipeline"]["decode_scale_denom"])

    def births(delta: float) -> float:
        shifted = {lvl: (c + delta, b, t) for lvl, (c, b, t) in head.items()}
        _, scores, _, valid = ref.postprocess.select(
            *ref.postprocess.candidates(shifted, det), det)
        return float((valid & (scores >= gate)).sum()) / CALIBRATION_FRAMES

    lo, hi = -12.0, 12.0
    for _ in range(steps):
        mid = (lo + hi) / 2
        if births(mid) < target:
            lo = mid
        else:
            hi = mid
    return hi
