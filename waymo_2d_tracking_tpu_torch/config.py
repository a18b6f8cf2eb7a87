"""Typed dataclass configs (SURVEY.md §5 "Config/flag system", component C24).

Every BASELINE.json acceptance config 1-5 is expressible as a preset of these
dataclasses; presets live in ``configs/*.yaml`` at the repo root.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class KalmanConfig:
    """Constant-velocity Kalman filter noise model (SORT-style, scaled by box size)."""

    # std of position/size process noise as a fraction of box height
    std_weight_position: float = 1.0 / 20.0
    # std of velocity process noise as a fraction of box height
    std_weight_velocity: float = 1.0 / 160.0
    # measurement noise std as fraction of box height
    std_weight_measurement: float = 1.0 / 20.0
    # initial velocity uncertainty multiplier
    init_velocity_std: float = 10.0
    # NSA noise-scale-adaptive update (StrongSORT, Du et al. 2023): scale the
    # measurement noise by (1 - det_score), so confident detections correct
    # the state harder and borderline ones barely perturb it. Off by default
    # (SORT parity).
    nsa: bool = False


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """SORT-family tracker (components C12-C17)."""

    max_tracks: int = 128          # S: fixed slot-table capacity
    max_detections: int = 128      # D: padded per-frame detection capacity
    embed_dim: int = 128           # E: ReID embedding dim (0 disables appearance)

    iou_threshold: float = 0.3     # min IoU for a valid match (gating)
    iou_buffer: float = 0.0        # buffered IoU (C-BIoU, Yang et al. 2023):
                                   # expand both boxes' w/h by (1 + 2*b)
                                   # before the stage-1 IoU, keeping fast
                                   # movers matchable when consecutive boxes
                                   # no longer overlap. The iou_threshold
                                   # gate applies to the buffered IoU.
                                   # 0 disables (exact SORT parity).
    appearance_weight: float = 0.0 # lambda: cost = (1-l)*iou_cost + l*cos_cost
    appearance_gate: float = 0.4   # max cosine distance for a valid match
    motion_gate: float = 0.0       # chi-square gate on squared Mahalanobis
                                   # distance to the Kalman prediction
                                   # (DeepSORT-style; 9.4877 = chi2 95% 4-dof;
                                   # 0 disables). The statistic is
                                   # the PROJECTED innovation, S = HPH^T + R
                                   # (DeepSORT project() convention) — for a
                                   # converged track it reads ~half the
                                   # round-3 HPH^T-only form, so a position
                                   # offset must exceed ~25% of box height
                                   # before 9.4877 forbids the match (d^2 is
                                   # scale-free in offset/height; 40% of h
                                   # measures d^2 = 35). Gates tuned against
                                   # the old form should be halved.
                                   # Measured regime (hostile clips):
                                   # cuts FP -71% on ghost_clutter but NEVER
                                   # wins MOTA/IDF1, and is catastrophic
                                   # under unmodeled global motion
                                   # (curved_pan IDSW 7->62) — enable only
                                   # when precision dominates and the CV
                                   # model holds.
    score_threshold: float = 0.5   # min det score to participate at all
    birth_score_threshold: float = 0.6  # min score to birth a new track
    birth_iou_threshold: float = 1.0  # suppress a birth whose IoU with any
                                   # live (tentative/confirmed) track exceeds
                                   # this — a duplicate detection the
                                   # detector's NMS kept (its IoU fell under
                                   # nms_iou_threshold) would otherwise go
                                   # unmatched and spawn a twin track that
                                   # steals the identity (measured: the
                                   # pixels-to-MOTA golden clip drops from 19
                                   # ID switches to 1 at 0.5, 0 at 0.3 —
                                   # BASELINE.md). >= 1.0 disables
                                   # (exact SORT parity).
    byte_low_threshold: float = 0.0  # BYTE-style second association
                                   # (ByteTrack, Zhang et al. 2022): when > 0,
                                   # detections with byte_low <= score <
                                   # score_threshold run an IoU-only second
                                   # pass against CONFIRMED tracks stage-1
                                   # left unmatched. Low-score matches sustain
                                   # a track through partial occlusion but
                                   # never birth tracks or update appearance
                                   # (their embeddings are unreliable).
                                   # 0 disables (default).
    byte_iou_threshold: float = 0.5  # stricter IoU gate for the low-score
                                   # pass — low dets are noisy, demand overlap

    n_init: int = 3                # consecutive hits to confirm a track
    max_age: int = 3               # misses before confirmed -> lost/dead
    max_lost_age: int = 30         # frames a lost track is kept for re-ID recovery
    reid_recovery: bool = False    # stage-2 association vs lost tracks (config 5)
    recovery_momentum: bool = False  # on re-ID recovery, set the track's
                                   # velocity from the observed displacement
                                   # across the occlusion gap (OC-SORT-style
                                   # observation-centric re-init) instead of
                                   # zero. Only meaningful with
                                   # reid_recovery; off = SORT parity.
    embed_ema: float = 0.9         # EMA factor for track embedding updates
    gallery_size: int = 1          # per-track appearance gallery ring buffer
                                   # (K>1 scores stage-2 recovery against the
                                   # K most recent distinct appearances, not
                                   # just the EMA — SURVEY.md §5 long-context)

    kalman: KalmanConfig = dataclasses.field(default_factory=KalmanConfig)

    assignment: str = "auction"  # 'auction': eps-scaled Pallas auction,
                                 # scipy-equal Hungarian semantics (SORT
                                 # parity, the default). 'greedy': lowest-
                                 # cost-first matching — not optimal, but
                                 # several times cheaper per frame; used by
                                 # speed presets where the tracker step is
                                 # the bottleneck (docs/DESIGN.md §5)
    # Auction assignment (component C14); eps starts at the dynamic benefit
    # range and scales down geometrically to eps_min.
    auction_eps_scale: float = 0.2    # eps <- eps * scale per scaling phase
    # 1e-2 is optimality slack ~1px of IoU cost per pair — measured identical
    # MOTA/IDSW to 1e-3 on the golden clip, with fewer eps phases per frame
    auction_eps_min: float = 1e-2
    auction_max_iters: int = 4096     # per-phase bidding iteration cap

    def __post_init__(self):
        # a typo'd yaml value ('greeedy') used to fall through silently to
        # the auction path
        if self.assignment not in ("auction", "greedy"):
            raise ValueError(
                f"tracker.assignment must be 'auction' or 'greedy', "
                f"got {self.assignment!r}"
            )
        if self.byte_low_threshold >= self.score_threshold > 0 or self.byte_low_threshold < 0:
            raise ValueError(
                "tracker.byte_low_threshold must be 0 (off) or in "
                f"[0, score_threshold={self.score_threshold}); "
                f"got {self.byte_low_threshold!r}"
            )
        if self.birth_iou_threshold <= 0:
            raise ValueError(
                "tracker.birth_iou_threshold must be in (0, 1] "
                f"(>= 1.0 disables); got {self.birth_iou_threshold!r}"
            )


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """ResNet-50 + FPN + heads single-stage detector (components C5-C10)."""

    num_classes: int = 3                 # Waymo 2D: vehicle, pedestrian, cyclist
    image_size: Tuple[int, int] = (640, 960)   # (H, W) after letterbox; config 2 uses (1280, 1920)
    backbone: str = "resnet50"
    stem: str = "s2d"         # 's2d' (default: weight-equivalent space-to-
                              # depth 4x4/s1 — the MLPerf-TPU stem: C_in
                              # 3->12 fills MXU lanes) or 'conv7' (the torch
                              # 7x7/s2 form; use for 1:1 layout parity runs —
                              # convert_stem_to_s2d ports conv7 weights
                              # exactly, and train/port_torch.py applies it
                              # automatically on import)
    fpn_channels: int = 256
    fpn_levels: Tuple[int, ...] = (3, 4, 5, 6, 7)   # P3..P7 strides 8..128
    head_family: str = "fcos"  # 'fcos' (per-level anchor-free towers +
                               # NMS, the default) or 'centernet' (single-
                               # level center heatmap + size/offset; peak
                               # extraction via 3x3 max-pool —
                               # models/centernet.py)
    centernet_level: int = 3   # FPN level feeding the centernet head
    head_depth: int = 4
    head_channels: int = 0    # FCOS tower width; 0 = same as fpn_channels.
                              # The head towers are the single largest FLOP
                              # block at 640x960 (see docs/DESIGN.md roofline)
                              # — 128 quarters head cost vs the FCOS-standard
                              # 256 at some accuracy risk on real data
    # anchor-free (FCOS-style) head: one box + per-class score per location
    score_threshold: float = 0.05
    pre_nms_topk: int = 512   # per level; 1000 matches the usual FCOS setting
                              # but 512 halves NMS work with negligible recall
                              # impact at Waymo scene densities
    topk_method: str = "exact"  # per-level candidate top-k: 'exact'
                                # (lax.top_k) or 'approx' (lax.approx_max_k)
    nms_topk: int = 1024      # global cross-level candidate cap fed to NMS
    nms_iou_threshold: float = 0.6
    max_detections: int = 128
    embed_dim: int = 128                 # ReID head output (0 disables)
    reid_channels: int = 0    # ReID tower conv width; 0 = same as
                              # fpn_channels. At 256 the two 7x7 ReID convs
                              # cost ~14 GFLOP/frame for 128 detections
                              # (tools/flops_budget.py) — 128 quarters that
    reid_multilevel: bool = False        # ReID RoIAlign pools from the
                                         # FPN level matched to box scale
                                         # (roi_align_multilevel) instead of
                                         # P3 only
    dtype: str = "bfloat16"              # compute dtype for conv trunk
    quant: str = "off"        # 'int8': w8a8 post-training-quantized conv
                              # trunk for INFERENCE (models/quant.py — the
                              # v5e MXU runs int8 at 2x the bf16 rate).
                              # Requires one calibration pass
                              # (DetectorRunner.calibrate; the pipelines
                              # auto-calibrate on their first chunk).
                              # Training always runs the float path.
    quant_scope: str = "trunk"  # which convs the int8 mode quantizes:
                              # 'trunk' (backbone+FPN; head towers + ReID
                              # stay float) or 'all'. Default 'trunk':
                              # measured on the trained pixels
                              # fixture, 'all' collapses seed-5 MOTA
                              # 0.797 -> 0.634 (tower quant noise lands on
                              # the sigmoid/exp decode, same failure class
                              # the always-float predictor convs guard
                              # against) while 'trunk' holds quality at
                              # ~0.985x the bench win of 'all'
                              # (BASELINE.md int8-quality table).

    def __post_init__(self):
        if self.quant not in ("off", "int8"):
            raise ValueError(
                f"detector.quant must be 'off' or 'int8', got {self.quant!r}"
            )
        if self.quant_scope not in ("all", "trunk"):
            raise ValueError(
                f"detector.quant_scope must be 'all' or 'trunk', "
                f"got {self.quant_scope!r}"
            )
        if self.head_family not in ("fcos", "centernet"):
            raise ValueError(
                f"detector.head_family must be 'fcos' or 'centernet', "
                f"got {self.head_family!r}"
            )
        if self.head_family == "centernet" and (
            self.centernet_level not in self.fpn_levels
        ):
            raise ValueError(
                f"detector.centernet_level={self.centernet_level} not in "
                f"fpn_levels={self.fpn_levels}"
            )


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Per-segment orchestration (components C18-C20)."""

    cameras: Sequence[str] = ("FRONT",)
    chunk_frames: int = 8          # frames per jitted scan chunk
    prefetch_depth: int = 2        # double-buffered host->HBM staging
    decode_scale_denom: int = 1    # 2/4/8: libjpeg DCT-domain scaled decode
                                   # at 1/denom (data/jpeg.py) — ~denom^2
                                   # less host decode work. Track outputs
                                   # stay in ORIGINAL source pixels (the
                                   # letterbox scale is composed with the
                                   # decode scale). Production@512x768 with
                                   # denom=2: 1280x1920 JPEGs decode to
                                   # 640x960, device resizes the rest.
    tta_flip: bool = False
    tta_scales: Sequence[float] = (1.0,)
    interp_max_gap: int = 0        # fill per-track output gaps of up to N
                                   # frames by linear interpolation on the
                                   # host (io_out/postprocess.py); 0 = off.
                                   # Repairs short detector misses without
                                   # touching long occlusion gaps.
    data_axis: str = "data"        # mesh axis name for segment/camera fan-out

    def __post_init__(self):
        if self.interp_max_gap < 0:
            raise ValueError(
                f"pipeline.interp_max_gap must be >= 0, "
                f"got {self.interp_max_gap!r}"
            )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Detector training (component C23)."""

    batch_size: int = 16
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 500
    total_steps: int = 20000
    optimizer: str = "adamw"       # 'adamw' | 'sgd' (momentum + coupled
                                   # L2 wd, torch SGD semantics — the
                                   # classic detector recipe)
    sgd_momentum: float = 0.9
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    ema_decay: float = 0.0    # exponential moving average of params for
                              # eval/export (0 disables; detection standard
                              # is 0.999-0.9999). Eval with
                              # DetectorTrainer.eval_variables(state)
    checkpoint_every: int = 1000
    checkpoint_dir: str = "/tmp/w2t_ckpt"
    # Gradient accumulation: split each batch into N sequential
    # micro-batches inside the jitted step (lax.scan) — one micro-batch of
    # activations live at a time, so effective batch grows ~N-fold at
    # fixed activation memory. Composes with remat; batch_size must be
    # divisible by it. 1 disables.
    grad_accum_steps: int = 1
    # Per-block backbone rematerialization (flax nn.remat): backward
    # recomputes each residual block's activations instead of keeping them
    # in HBM — peak-memory for ~1 extra backbone forward of FLOPs, the
    # standard TPU trade for larger batches / resolutions (measured
    # on-chip in BASELINE.md). Full-forward jax.checkpoint was measured
    # counterproductive (+3% temp HBM) — XLA's schedule already caps the
    # naive backward; per-block is what wins.
    remat: bool = False
    # input augmentation (data/coco.py iterator)
    aug_flip: bool = True
    aug_scale_range: Tuple[float, float] = (0.8, 1.25)  # multi-scale jitter
    aug_color_jitter: float = 0.2   # brightness/contrast/saturation +-20%
    # input pipeline (SURVEY.md §3.3): background decode/augment threads +
    # device prefetch depth so the pjit train step is never host-starved
    input_workers: int = 2
    input_prefetch: int = 2
    # ReID metric learning: batch-hard triplet loss over GT-box
    # embeddings, driven by the track ids the COCO conversion preserves.
    # 0 disables (detector-only training); needs detector.embed_dim > 0 and
    # batches carrying gt_track_ids to have any effect
    reid_loss_weight: float = 0.0
    # metric objective: 'supcon' (supervised contrastive, Khosla et al.
    # 2020 — the default; batch-hard triplet on normalized embeddings has
    # a measured collapse mode, see train/losses.py reid_supcon_loss) or
    # 'triplet' (Hermans et al. 2017 batch-hard, kept for comparison)
    reid_loss: str = "supcon"
    reid_margin: float = 0.3        # triplet hinge margin
    reid_temperature: float = 0.1   # supcon temperature


@dataclasses.dataclass(frozen=True)
class Config:
    detector: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def _update(dc, overrides: dict):
    """Recursively apply a nested dict of overrides to a (frozen) dataclass."""
    kwargs = {}
    for f in dataclasses.fields(dc):
        if f.name in overrides:
            v = overrides[f.name]
            cur = getattr(dc, f.name)
            if dataclasses.is_dataclass(cur) and isinstance(v, dict):
                kwargs[f.name] = _update(cur, v)
            else:
                if isinstance(v, list):
                    v = tuple(v)
                kwargs[f.name] = v
    extra = set(overrides) - {f.name for f in dataclasses.fields(dc)}
    if extra:
        raise KeyError(f"unknown config keys for {type(dc).__name__}: {sorted(extra)}")
    return dataclasses.replace(dc, **kwargs)


def load_config(yaml_path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    """Build a Config from an optional yaml preset plus a nested override dict."""
    cfg = Config()
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        cfg = _update(cfg, data)
    if overrides:
        cfg = _update(cfg, overrides)
    return cfg
