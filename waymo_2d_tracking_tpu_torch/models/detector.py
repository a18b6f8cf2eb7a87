"""Full detector (counterpart of ``models/detector.py``): ResNet (or the Swin
Transformer of ``models/swin.py``, which the JAX package lacks) + FPN + FCOS
or CenterNet heads + ReID, with batched post-processing -- top-k candidates,
class-aware NMS (the CUDA kernel on the card) and RoIAlign + ReID embedding --
emitting tracker-ready ``Detections``. ``quant='int8'`` serves a w8a8 trunk
(``models/quant.py``) after a calibration pass.

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
from waymo_2d_tracking_tpu_torch.models import swin as swin_mod
from waymo_2d_tracking_tpu_torch.models.centernet import (
    PRIOR_BIAS,
    CenterNetHeads,
    gather_centernet_candidates_batched,
)
from waymo_2d_tracking_tpu_torch.models.fpn import FPN
from waymo_2d_tracking_tpu_torch.models.heads import FCOSHeads, decode_level
from waymo_2d_tracking_tpu_torch.models.quant import is_calibrated, quant_convs, quant_mode
from waymo_2d_tracking_tpu_torch.models.reid import ReIDHead
from waymo_2d_tracking_tpu_torch.ops.nms import nms_batched, topk_stable
from waymo_2d_tracking_tpu_torch.ops.roi_align import (
    roi_align_batched,
    roi_align_multilevel_batched,
)
from waymo_2d_tracking_tpu_torch.ops.topk import METHODS as TOPK_METHODS
from waymo_2d_tracking_tpu_torch.types import Detections
from waymo_2d_tracking_tpu_torch.utils.profiling import span

# class-aware NMS: boxes of different classes are offset far apart so one
# class-agnostic NMS pass never cross-suppresses
_CLASS_NMS_OFFSET = 1e5

# standard deviation of a unit normal truncated to [-2, 2] (flax's
# variance_scaling divides by it)
_TRUNC_STD = 0.87962566103423978

_BACKBONES = {
    "resnet18": resnet_mod.ResNet18,
    "resnet34": resnet_mod.ResNet34,
    "resnet50": resnet_mod.ResNet50,
    "resnet101": resnet_mod.ResNet101,
    "resnet18slim": resnet_mod.ResNet18Slim,
    "swin_t": swin_mod.SwinT,
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


class Detector(nn.Module):
    """Raw forward: images (N, H, W, 3) -> (per-level head outputs NHWC,
    pyramid features NHWC).

    ``cfg.quant='int8'`` builds the backbone and FPN convs as ``QuantConv2d``
    (``models/quant.py``), and the head towers and ReID convs too under
    ``quant_scope='all'``; the predictor convs stay float, as in the JAX
    package."""

    def __init__(self, cfg: DetectorConfig, remat: bool = False):
        super().__init__()
        if cfg.backbone not in _BACKBONES:
            raise ValueError(f"unknown backbone {cfg.backbone}")
        self.cfg = cfg
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        head_quant = cfg.quant if cfg.quant_scope == "all" else "off"
        self.backbone = _BACKBONES[cfg.backbone](stem=cfg.stem, quant=cfg.quant, dtype=dtype,
                                                 remat=remat)
        self.fpn = FPN(self.backbone.out_channels, cfg.fpn_channels, cfg.fpn_levels,
                       quant=cfg.quant, dtype=dtype)
        head_channels = cfg.head_channels or cfg.fpn_channels
        if cfg.head_family == "centernet":
            self.heads = CenterNetHeads(
                cfg.fpn_channels, num_classes=cfg.num_classes, depth=cfg.head_depth,
                channels=head_channels, level=cfg.centernet_level, quant=head_quant,
                dtype=dtype,
            )
        else:
            self.heads = FCOSHeads(
                cfg.fpn_channels, num_classes=cfg.num_classes, depth=cfg.head_depth,
                channels=head_channels, levels=cfg.fpn_levels, quant=head_quant, dtype=dtype,
            )
        if cfg.embed_dim > 0:
            self.reid = ReIDHead(cfg.fpn_channels, embed_dim=cfg.embed_dim,
                                 channels=cfg.reid_channels or cfg.fpn_channels,
                                 quant=head_quant, dtype=dtype)

    def forward(self, images: torch.Tensor):
        with span("backbone"):
            c_feats = self.backbone(images)
        p_feats = self.fpn(c_feats)
        head_out = self.heads(p_feats)
        return head_out, {lvl: f.permute(0, 2, 3, 1) for lvl, f in p_feats.items()}

    def embed(self, pooled: torch.Tensor) -> torch.Tensor:
        """ReID embeddings for RoIAligned features (R, P, P, C) -> (R, E)."""
        return self.reid(pooled)

    def forward_train(self, images: torch.Tensor, rois: Optional[torch.Tensor] = None):
        """Training forward (the module in train mode): head outputs, and the
        ReID embeddings (N, G, E) of the padded GT boxes ``rois`` (N, G, 4)
        pooled exactly as at inference (``_pool_reid_features``, the matmul
        form, differentiable), or None."""
        head_out, p_feats = self(images)
        embeds = None
        if rois is not None and self.cfg.embed_dim > 0:
            pooled = _pool_reid_features(p_feats, rois, self.cfg)
            n, g = rois.shape[:2]
            embeds = self.reid(pooled.reshape((n * g,) + pooled.shape[2:])).reshape(n, g, -1)
        return head_out, embeds

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, truncated: bool = False) -> None:
        """Seeded random init with flax's defaults, module by module (the JAX
        package's ``Detector.init_all``): conv and Dense kernels LeCun normal
        (variance 1 / fan_in), zero biases, unit BatchNorm / GroupNorm scales
        and per-level FCOS scales, and the focal prior bias (-4.595) on the
        class or heat logits (BatchNorm statistics keep their constructed 0
        and 1). ``truncated`` (training's ``create_state``) draws the kernels
        as flax's ``lecun_normal`` does, a normal truncated at two standard
        deviations and rescaled; the serving paths' random weights keep their
        plain normal draws, whose outputs earlier measurements rest on. A
        Swin backbone's relative-position bias tables are drawn normal x
        0.02, the release's init, in their place in the parameter order."""
        for name, p in self.named_parameters():
            if name.endswith(swin_mod.BIAS_TABLE):
                p.copy_(torch.randn(p.shape, generator=generator) * swin_mod.BIAS_TABLE_STD)
            elif name.endswith("weight") and p.dim() > 1:
                fan_in = p[0].numel()
                if truncated:
                    nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=generator)
                    p.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)
                else:
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
    the JAX package's variables, with a calibrated checkpoint's activation
    scales); without it the weights are random, drawn from
    ``torch.Generator().manual_seed(seed)``.

    Under ``quant='int8'`` the activation scales come from ``calibrate`` (the
    drivers call it on their first real frames) or from the checkpoint, and
    every forward first passes ``check_calibrated``, which raises on an
    uncalibrated detector.
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
            if self.cfg.quant == "off":   # a calibrated checkpoint serves float too
                state_dict = {k: v for k, v in state_dict.items()
                              if not k.endswith(".act_absmax")}
            self.module.load_state_dict(state_dict)
        self.module.to(self.device).eval()
        self._calib_ok_key = None
        self._allow_uncalibrated = False

    def precision(self):
        return precision_ctx(self.cfg, self.device)

    def _absmax_key(self):
        """Identity and in-place version of every ``act_absmax`` buffer:
        host-side, no device read, and it changes whenever a buffer is
        written (calibration, ``load_state_dict``, ``copy_``)."""
        return tuple((t.data_ptr(), t._version)
                     for t in (m.act_absmax for m in quant_convs(self.module)))

    def check_calibrated(self) -> None:
        """Refuse to serve uncalibrated int8: a zero absmax falls back to a
        scale of 1.0 inside ``QuantConv2d``, finite but wrong outputs. Reads
        the buffers on the host once per calibration state (the JAX package
        memoizes by a weakref to its 'quant' leaf)."""
        if self.cfg.quant == "off" or self._allow_uncalibrated:
            return
        key = self._absmax_key()
        if key == self._calib_ok_key:
            return
        if not is_calibrated(self.module):
            raise RuntimeError(
                "detector.quant='int8' but the detector carries no calibrated "
                "activation scales (act_absmax == 0). Run "
                "DetectorRunner.calibrate(representative_images) first -- the "
                "pipeline drivers do this on their first real frames "
                "(SegmentPipeline, MultiCamPipeline, OnlineTracker, "
                "OnlineMultiCamTracker) -- or load a calibrated checkpoint.")
        self._calib_ok_key = key

    @contextlib.contextmanager
    def uncalibrated_ok(self):
        """Let a warm-up pass, whose outputs are thrown away, run the int8
        forward before calibration (with the 1.0 scale fallback), as the JAX
        package's warm-up does."""
        self._allow_uncalibrated = True
        try:
            yield
        finally:
            self._allow_uncalibrated = False

    @torch.no_grad()
    def calibrate(self, images: torch.Tensor) -> None:
        """One PTQ calibration pass (``quant='int8'``): the float forward on
        representative images, recording each quantized conv's input absmax
        as a running maximum (call again to widen it over more batches).
        Under ``quant_scope='all'`` the ReID tower is calibrated on the pooled
        features of the batch's detections, invalid slots zeroed unless no
        slot of the batch is valid (then an all-zero batch would read as
        uncalibrated)."""
        if self.cfg.quant == "off":
            return
        with quant_mode(self.module, "calib"), self.precision():
            head_out, p_feats = self.module(images)
            if self.cfg.embed_dim > 0 and self.cfg.quant_scope == "all":
                boxes, _, _, valid = select_detections_batched(
                    *gather_candidates_batched(head_out, self.cfg), self.cfg)
                pooled = _pool_reid_features(p_feats, boxes, self.cfg)
                masked = pooled * valid[..., None, None, None].to(pooled.dtype)
                pooled = torch.where(valid.any(), masked, pooled)
                n, d = boxes.shape[:2]
                self.module.embed(pooled.reshape((n * d,) + pooled.shape[2:]))

    @torch.no_grad()
    def forward(self, images: torch.Tensor):
        """Raw head outputs and pyramid features for (N, H, W, 3) images."""
        self.check_calibrated()
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
