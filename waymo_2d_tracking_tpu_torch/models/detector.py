"""Full detector (counterpart of ``models/detector.py``): ResNet + FPN + FCOS
or CenterNet heads + ReID, with batched post-processing -- top-k candidates,
class-aware NMS (the CUDA kernel on the card) and RoIAlign + ReID embedding --
emitting tracker-ready ``Detections``.

Precision rule (``precision_ctx``): ``dtype='float32'`` configs run true f32,
with TF32 off for both cuDNN convolutions and CUDA matmuls (cuDNN allows TF32
by default, the same class of error the JAX package fixed on the TPU);
``'bfloat16'`` configs run the trunk in bf16 under autocast, parameters
staying f32 as in flax.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
from torch import nn

from waymo_2d_tracking_tpu_torch import resolve_device
from waymo_2d_tracking_tpu_torch.config import DetectorConfig
from waymo_2d_tracking_tpu_torch.models import resnet as resnet_mod
from waymo_2d_tracking_tpu_torch.models.centernet import (
    PRIOR_BIAS,
    CenterNetHeads,
    gather_centernet_candidates_batched,
)
from waymo_2d_tracking_tpu_torch.models.fpn import FPN
from waymo_2d_tracking_tpu_torch.models.heads import FCOSHeads, decode_level
from waymo_2d_tracking_tpu_torch.models.reid import ReIDHead
from waymo_2d_tracking_tpu_torch.ops.nms import nms_batched, topk_stable
from waymo_2d_tracking_tpu_torch.ops.roi_align import (
    roi_align_batched,
    roi_align_multilevel_batched,
)
from waymo_2d_tracking_tpu_torch.ops.topk import METHODS as TOPK_METHODS
from waymo_2d_tracking_tpu_torch.types import Detections

# class-aware NMS: boxes of different classes are offset far apart so one
# class-agnostic NMS pass never cross-suppresses
_CLASS_NMS_OFFSET = 1e5

_BACKBONES = {
    "resnet18": resnet_mod.ResNet18,
    "resnet34": resnet_mod.ResNet34,
    "resnet50": resnet_mod.ResNet50,
    "resnet101": resnet_mod.ResNet101,
    "resnet18slim": resnet_mod.ResNet18Slim,
}


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def precision_ctx(cfg: DetectorConfig, device: torch.device):
    """f32 configs: TF32 off; bf16 configs: bf16 autocast on ``device``."""
    if cfg.dtype == "float32":
        return _no_tf32()
    return torch.autocast(device_type=device.type, dtype=torch.bfloat16)


def _check_supported(cfg: DetectorConfig) -> None:
    if cfg.quant != "off":
        raise NotImplementedError(
            "detector.quant='int8' (models/quant.py) is not ported yet; it "
            "is a later slice of the port")
    if cfg.backbone not in _BACKBONES:
        raise ValueError(f"unknown backbone {cfg.backbone}")


class Detector(nn.Module):
    """Raw forward: images (N, H, W, 3) -> (per-level head outputs NHWC,
    pyramid features NHWC)."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.backbone = _BACKBONES[cfg.backbone](stem=cfg.stem)
        self.fpn = FPN(self.backbone.out_channels, cfg.fpn_channels, cfg.fpn_levels)
        head_channels = cfg.head_channels or cfg.fpn_channels
        if cfg.head_family == "centernet":
            self.heads = CenterNetHeads(
                cfg.fpn_channels, num_classes=cfg.num_classes, depth=cfg.head_depth,
                channels=head_channels, level=cfg.centernet_level,
            )
        else:
            self.heads = FCOSHeads(
                cfg.fpn_channels, num_classes=cfg.num_classes, depth=cfg.head_depth,
                channels=head_channels, levels=cfg.fpn_levels,
            )
        if cfg.embed_dim > 0:
            self.reid = ReIDHead(cfg.fpn_channels, embed_dim=cfg.embed_dim,
                                 channels=cfg.reid_channels or cfg.fpn_channels)

    def forward(self, images: torch.Tensor):
        c_feats = self.backbone(images)
        p_feats = self.fpn(c_feats)
        head_out = self.heads(p_feats)
        return head_out, {lvl: f.permute(0, 2, 3, 1) for lvl, f in p_feats.items()}

    def embed(self, pooled: torch.Tensor) -> torch.Tensor:
        """ReID embeddings for RoIAligned features (R, P, P, C) -> (R, E)."""
        return self.reid(pooled)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random init in the spirit of the flax defaults: LeCun-normal
        conv / dense kernels, zero biases, unit norms, the focal prior bias
        (-4.595) on the class or heat logits and unit per-level scales."""
        for name, p in self.named_parameters():
            if name.endswith("weight") and p.dim() > 1:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))
            elif name.endswith("weight") or ".scale" in name:
                p.fill_(1.0)
            else:
                p.zero_()
        centernet = isinstance(self.heads, CenterNetHeads)
        logits = self.heads.heat if centernet else self.heads.cls_logits
        logits.bias.fill_(PRIOR_BIAS)


def _level_candidates(cls_logits, ltrb, ctr, stride: int, k: int,
                      method: str = "exact"):
    """Per-level top-k candidates for an image batch:
    (boxes (N,k,4), scores (N,k), classes (N,k) int32).

    ``method='approx'`` is ``lax.approx_max_k`` in the JAX package, which is
    approximate only on the TPU; on the CPU and GPU XLA computes it exactly,
    ties lowest index first. Both methods give that exact result here."""
    if method not in TOPK_METHODS:
        raise ValueError(f"topk method must be one of {TOPK_METHODS}, got {method!r}")
    n, h, w, num_classes = cls_logits.shape
    prob = torch.sigmoid(cls_logits.float())
    ctr_prob = torch.sigmoid(ctr.float())
    score = torch.sqrt(torch.clamp(prob * ctr_prob, min=0.0))       # (N,H,W,K)
    boxes = decode_level(ltrb, stride)                              # (N,H,W,4)

    flat_scores = score.reshape(n, -1)            # NHWC flatten: idx = loc*K + k
    k_eff = min(k, flat_scores.shape[1])
    top_scores, top_idx = topk_stable(flat_scores, k_eff)
    loc_idx = top_idx // num_classes
    cls_idx = (top_idx % num_classes).to(torch.int32)
    top_boxes = torch.gather(boxes.reshape(n, -1, 4), 1,
                             loc_idx[..., None].expand(-1, -1, 4))
    return top_boxes, top_scores, cls_idx


def gather_candidates_batched(head_out, cfg: DetectorConfig):
    """Top-k candidates: (boxes (N,C,4), scores (N,C), classes (N,C)).

    FCOS concatenates per-level candidates over the levels; CenterNet decodes
    the peaks of its one heatmap, with the same contract."""
    if cfg.head_family == "centernet":
        return gather_centernet_candidates_batched(head_out, cfg)
    cand = [
        _level_candidates(*head_out[lvl], stride=2 ** lvl, k=cfg.pre_nms_topk,
                          method=cfg.topk_method)
        for lvl in cfg.fpn_levels
    ]
    return tuple(torch.cat([c[i] for c in cand], dim=1) for i in range(3))


def select_detections_batched(boxes, scores, classes, cfg: DetectorConfig):
    """Class-aware NMS + final top-D selection, whole batch at once."""
    if 0 < cfg.nms_topk < boxes.shape[1]:
        scores, sel = topk_stable(scores, cfg.nms_topk)
        boxes = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4))
        classes = torch.gather(classes, 1, sel)
    shifted = boxes + (classes.to(torch.float32) * _CLASS_NMS_OFFSET)[..., None]
    _, nms_scores, keep_idx, valid = nms_batched(
        shifted, scores,
        iou_threshold=cfg.nms_iou_threshold,
        max_outputs=cfg.max_detections,
        score_threshold=cfg.score_threshold,
    )
    safe_idx = torch.clamp(keep_idx, 0, boxes.shape[1] - 1)
    picked = torch.gather(boxes, 1, safe_idx[..., None].expand(-1, -1, 4))
    out_boxes = torch.where(valid[..., None], picked, torch.zeros_like(picked))
    out_classes = torch.where(valid, torch.gather(classes, 1, safe_idx),
                              torch.zeros_like(safe_idx, dtype=classes.dtype))
    return out_boxes, nms_scores, out_classes, valid


def _pool_reid_features(p_feats, boxes, cfg: DetectorConfig):
    """RoIAlign pyramid features (NHWC) for ReID: P3 only, or the
    scale-matched P3..P5 level with ``reid_multilevel``."""
    if cfg.reid_multilevel:
        lvls = [lvl for lvl in cfg.fpn_levels if lvl <= 5]
        return roi_align_multilevel_batched(
            {lvl: p_feats[lvl] for lvl in lvls}, boxes,
            {lvl: 2 ** lvl for lvl in lvls}, output_size=7,
        )
    lvl0 = min(cfg.fpn_levels)
    return roi_align_batched(p_feats[lvl0], boxes,
                             spatial_scale=1.0 / (2 ** lvl0), output_size=7)


class DetectorRunner:
    """Holds the detector on ``device`` and produces tracker-ready Detections.

    ``state_dict``: the port's weights (``weights.from_flax_numpy`` converts
    the JAX package's variables); without it the weights are random, drawn
    from ``torch.Generator().manual_seed(seed)``.
    """

    def __init__(self, cfg: Optional[DetectorConfig] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device="cuda", seed: int = 0):
        self.cfg = cfg or DetectorConfig()
        self.device = resolve_device(device)
        self.module = Detector(self.cfg)
        if state_dict is None:
            self.module.init_weights(torch.Generator().manual_seed(seed))
        else:
            self.module.load_state_dict(state_dict)
        self.module.to(self.device).eval()

    def precision(self):
        return precision_ctx(self.cfg, self.device)

    @torch.no_grad()
    def forward(self, images: torch.Tensor):
        """Raw head outputs and pyramid features for (N, H, W, 3) images."""
        with self.precision():
            return self.module(images)

    @torch.no_grad()
    def postprocess(self, head_out, p_feats) -> Detections:
        """Candidates -> NMS -> top-D -> RoIAlign + ReID embeddings."""
        return self.select(gather_candidates_batched(head_out, self.cfg), p_feats)

    @torch.no_grad()
    def select(self, candidates, p_feats) -> Detections:
        """(boxes, scores, classes) candidates -> NMS -> top-D -> RoIAlign +
        ReID embeddings pooled from ``p_feats``."""
        with self.precision():
            boxes, scores, classes, valid = select_detections_batched(*candidates, self.cfg)
            n, d = boxes.shape[:2]
            if self.cfg.embed_dim > 0:
                pooled = _pool_reid_features(p_feats, boxes, self.cfg)
                flat = pooled.reshape((n * d,) + pooled.shape[2:])
                embeds = self.module.embed(flat).reshape(n, d, -1) * valid[..., None]
            else:
                embeds = torch.zeros((n, d, 1), dtype=torch.float32, device=boxes.device)
        return Detections(boxes=boxes, scores=scores, classes=classes,
                          embeds=embeds.float(), valid=valid)

    def detect(self, images: torch.Tensor) -> Detections:
        """images (N, H, W, 3) float32 on the runner's device -> batched
        Detections (N, D, ...)."""
        return self.postprocess(*self.forward(images))
