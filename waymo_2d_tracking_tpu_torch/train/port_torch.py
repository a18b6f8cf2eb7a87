"""torchvision-layout weights into the port's detector (counterpart of
``train/port_torch.py``, ``import-weights``).

The JAX package converts a torch / torchvision state dict into flax
variables; the port's modules already hold torch layouts under the flax
names, so here the conversion is a renaming: keys are matched by name
(optional prefixes stripped) and a value is copied only when its shape
equals the target's; unmatched targets keep their values, and every source
key is reported as imported, skipped for its shape or missing, exactly as
the JAX module reports it.

Supported source layouts:
- plain torchvision ResNet-18/34/50/101 (``conv1/bn1/layer{1-4}...``);
- torchvision detection models (the same keys under ``backbone.body.``);
- torchvision FCOS: FPN (``backbone.fpn.inner_blocks/layer_blocks/
  extra_blocks``) and heads (``head.classification_head/regression_head``).

Conversions: BatchNorm weight / bias / running statistics keep their torch
names; when the target uses the s2d stem, a 7x7 / stride-2 source stem is
re-expressed exactly as the 4x4 / stride-1 kernel over the 2x2
space-to-depth input (``convert_stem_to_s2d``, each 4x4 tap one 7x7 tap).
``import_weights`` writes the port's state dict with ``torch.save``; it
loads into ``DetectorRunner`` and the CLI's ``--params``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from waymo_2d_tracking_tpu_torch.config import DetectorConfig

_STAGE_BLOCKS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
}


def convert_stem_to_s2d(weight7: torch.Tensor) -> torch.Tensor:
    """Exactly re-express a 7x7 stride-2 stem weight (O, C, 7, 7) as the
    4x4 stride-1 weight (O, 4C, 4, 4) over 2x2 space-to-depth input: source
    row dy lands at tap (dy - 3 - a) / 2 + 2 of sub-pixel row a = (dy - 3)
    mod 2, channel block 2a + b (the JAX package's derivation, in OIHW)."""
    o, c = weight7.shape[:2]
    w4 = torch.zeros((o, 4 * c, 4, 4), dtype=weight7.dtype)
    for dy in range(7):
        a = (dy - 3) % 2
        ky = (dy - 3 - a) // 2 + 2
        for dx in range(7):
            b = (dx - 3) % 2
            kx = (dx - 3 - b) // 2 + 2
            ch = (2 * a + b) * c
            w4[:, ch:ch + c, ky, kx] += weight7[:, :, dy, dx]
    return w4


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` checkpoint as {key: float32 CPU tensor}. Accepts a raw
    state dict or the usual wrappers ({'model': ...}, {'state_dict': ...})."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for wrap in ("state_dict", "model"):
        if isinstance(obj, dict) and wrap in obj and isinstance(obj[wrap], dict):
            obj = obj[wrap]
    return {k: v.detach().float() for k, v in obj.items() if isinstance(v, torch.Tensor)}


def _strip_prefixes(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """'module.' (DDP) is dropped; 'backbone.body.' keys are also exposed
    bare, so one pass handles plain-ResNet and detection checkpoints."""
    out = dict(sd)
    for k, v in sd.items():
        if k.startswith("module."):
            out[k[len("module."):]] = v
    for k, v in list(out.items()):
        if k.startswith("backbone.body."):
            out[k[len("backbone.body."):]] = v
    return out


def torch_to_port_state_dict(sd: Dict[str, torch.Tensor], template: Dict[str, torch.Tensor],
                             cfg: DetectorConfig) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Copy shape-matching weights from the torchvision state dict ``sd``
    into a copy of the port's ``template`` state dict. Returns (state dict,
    report) with report = {'imported', 'skipped_shape', 'missing'}."""
    sd = _strip_prefixes(sd)
    out = {k: v.detach().clone() for k, v in template.items()}
    report = {"imported": [], "skipped_shape": [], "missing": []}

    def put(dst: str, value: torch.Tensor, src_key: str) -> None:
        if dst not in out:
            report["missing"].append(src_key)
            return
        if tuple(out[dst].shape) != tuple(value.shape):
            report["skipped_shape"].append(
                f"{src_key}: src{tuple(value.shape)} != dst{tuple(out[dst].shape)}")
            return
        out[dst] = value.to(out[dst].dtype).clone()
        report["imported"].append(src_key)

    def put_conv(dst: str, key: str, transform=None) -> None:
        if key in sd:
            w = sd[key] if transform is None else transform(sd[key])
            put(f"{dst}.weight", w, key)
            bkey = key[: -len("weight")] + "bias"
            if bkey in sd:
                put(f"{dst}.bias", sd[bkey], bkey)

    def put_norm(dst: str, prefix: str, has_stats: bool = True) -> None:
        if prefix + ".weight" in sd:
            put(f"{dst}.weight", sd[prefix + ".weight"], prefix + ".weight")
            put(f"{dst}.bias", sd[prefix + ".bias"], prefix + ".bias")
            if has_stats and prefix + ".running_mean" in sd:
                put(f"{dst}.running_mean", sd[prefix + ".running_mean"], prefix + ".running_mean")
                put(f"{dst}.running_var", sd[prefix + ".running_var"], prefix + ".running_var")

    stem_tf = None
    if cfg.stem == "s2d" and "conv1.weight" in sd and sd["conv1.weight"].shape[-1] == 7:
        stem_tf = convert_stem_to_s2d
    put_conv("backbone.stem_conv", "conv1.weight", transform=stem_tf)
    put_norm("backbone.stem_bn", "bn1")

    blocks = _STAGE_BLOCKS.get(cfg.backbone)
    if blocks:
        for stage, n_blocks in enumerate(blocks):
            for b in range(n_blocks):
                src = f"layer{stage + 1}.{b}"
                dst = f"backbone.stage{stage + 1}_block{b}"
                for ci in (1, 2, 3):
                    put_conv(f"{dst}.conv{ci}", f"{src}.conv{ci}.weight")
                    put_norm(f"{dst}.bn{ci}", f"{src}.bn{ci}")
                put_conv(f"{dst}.downsample_conv", f"{src}.downsample.0.weight")
                put_norm(f"{dst}.downsample_bn", f"{src}.downsample.1")

    for i, lvl in enumerate((3, 4, 5)):
        put_conv(f"fpn.lateral{lvl}", f"backbone.fpn.inner_blocks.{i}.0.weight")
        put_conv(f"fpn.smooth{lvl}", f"backbone.fpn.layer_blocks.{i}.0.weight")
    put_conv("fpn.p6", "backbone.fpn.extra_blocks.p6.weight")
    put_conv("fpn.p7", "backbone.fpn.extra_blocks.p7.weight")

    for i in range(cfg.head_depth):
        put_conv(f"heads.cls_tower.conv{i}", f"head.classification_head.conv.{i}.0.weight")
        put_norm(f"heads.cls_tower.gn{i}", f"head.classification_head.conv.{i}.1",
                 has_stats=False)
        put_conv(f"heads.box_tower.conv{i}", f"head.regression_head.conv.{i}.0.weight")
        put_norm(f"heads.box_tower.gn{i}", f"head.regression_head.conv.{i}.1", has_stats=False)
    put_conv("heads.cls_logits", "head.classification_head.cls_logits.weight")
    put_conv("heads.box_ltrb", "head.regression_head.bbox_reg.weight")
    put_conv("heads.centerness", "head.regression_head.bbox_ctrness.weight")
    return out, report


def import_weights(ckpt_path: str, out_path: str, cfg: Optional[DetectorConfig] = None,
                   seed: int = 0) -> dict:
    """``import-weights``: torchvision ``.pth`` -> the port's state dict at
    ``out_path`` (``torch.save``), over the seeded initial weights of
    ``cfg``'s detector. Returns the report with its counts."""
    from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner

    cfg = cfg or DetectorConfig()
    template = DetectorRunner(cfg, device="cpu", seed=seed).module.state_dict()
    sd, report = torch_to_port_state_dict(load_torch_state_dict(ckpt_path), template, cfg)
    torch.save(sd, out_path)
    report["out"] = out_path
    report["n_imported"] = len(report["imported"])
    report["n_skipped_shape"] = len(report["skipped_shape"])
    report["n_missing"] = len(report["missing"])
    return report
