"""Rendered synthetic video clips, numpy only (the part of ``data/synthetic.py``
that the pixel goldens and ``chip_smoke.py`` need).

``render_video_clip`` draws the scripted ground-truth trajectories as
class-coloured rectangles on a noise background. It reproduces the JAX
package's clips pixel for pixel: ``_ground_truth`` draws from the seeded
generator in the same order as ``generate_clip`` up to the ground truth.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticClipConfig:
    """The rendering-relevant fields of the JAX package's clip config, with
    the same names and defaults (the detection-noise fields of the scripted
    detection stream play no part in rendered pixels)."""

    num_frames: int = 200
    num_objects: int = 12
    image_size: Tuple[int, int] = (1280, 1920)  # (H, W): Waymo front cam
    embed_dim: int = 128                         # sizes a draw of the generator
    occlusion_gap: Tuple[int, int] = (60, 90)   # frames [a, b): objects 0,1 hidden
    accel: float = 0.0              # per-object |acceleration| <= accel px/frame^2
    pan_amplitude: float = 0.0      # sinusoidal camera pan, px
    pan_period: float = 60.0
    lifespan_frac: Tuple[float, float] = (1.0, 1.0)  # random object lifespans
    texture_amp: float = 0.0        # identity-bearing grating on each rectangle
    seed: int = 0


def _ground_truth(cfg: SyntheticClipConfig) -> dict:
    """Clean scripted trajectories: boxes (T, K, 4), present (T, K), ids,
    classes. Draws from ``default_rng(seed)`` in the clip generator's order."""
    rng = np.random.default_rng(cfg.seed)
    t_total, k = cfg.num_frames, cfg.num_objects
    h_img, w_img = cfg.image_size

    cx0 = rng.uniform(0.1 * w_img, 0.9 * w_img, k)
    cy0 = rng.uniform(0.1 * h_img, 0.9 * h_img, k)
    vx = rng.uniform(-6, 6, k)
    vy = rng.uniform(-3, 3, k)
    bw = rng.uniform(60, 180, k)
    bh = rng.uniform(60, 180, k)
    rng.normal(0, 1, (k, max(cfg.embed_dim, 1)))  # appearance draws (unused here)

    t_axis = np.arange(t_total)
    ax = rng.uniform(-cfg.accel, cfg.accel, k) if cfg.accel else np.zeros(k)
    ay = rng.uniform(-cfg.accel, cfg.accel, k) if cfg.accel else np.zeros(k)
    tt = t_axis[:, None].astype(np.float64)
    cx = cx0[None, :] + vx[None, :] * tt + 0.5 * ax[None, :] * tt**2
    cy = cy0[None, :] + vy[None, :] * tt + 0.5 * ay[None, :] * tt**2
    if cfg.pan_amplitude:
        pan = cfg.pan_amplitude * np.sin(2.0 * np.pi * t_axis / cfg.pan_period)
        cx = cx + pan[:, None]
        cy = cy + 0.5 * pan[:, None]
    gt_boxes = np.stack(
        [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], axis=-1
    )

    present = (cx > -bw) & (cx < w_img + bw) & (cy > -bh) & (cy < h_img + bh)
    a, b = cfg.occlusion_gap
    if k >= 2 and b > a:
        present[a:b, 0] = False
        present[a:b, 1] = False
    lo, hi = cfg.lifespan_frac
    if hi < 1.0 or lo < 1.0:
        life = rng.uniform(lo, hi, k)
        start = rng.uniform(0, 1.0 - life, k)
        s_f = np.round(start * t_total).astype(int)
        e_f = np.round((start + life) * t_total).astype(int)
        present &= (t_axis[:, None] >= s_f[None, :]) & (t_axis[:, None] < e_f[None, :])
    return {
        "boxes": gt_boxes.astype(np.float32),
        "present": present,
        "ids": np.arange(k, dtype=np.int32),
        "classes": (np.arange(k) % 3).astype(np.int32),
    }


RENDER_COLORS = np.array(
    [[0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.2, 0.9]], np.float32
)


def draw_rect_objects(image, boxes, classes, brightness=None,
                      tex_theta=None, tex_lambda=None, tex_amp=0.0):
    """Draw class-coloured rectangles onto a float (H, W, 3) image IN PLACE.

    boxes (N, 4) xyxy pixels (clipped here); later boxes draw on top. With
    ``tex_amp > 0`` each rectangle carries an object-anchored sinusoidal
    grating of orientation ``tex_theta`` and wavelength ``tex_lambda`` --
    an identity-bearing texture that survives the ReID tower's GroupNorm.
    """
    h, w = image.shape[:2]
    for i in range(len(boxes)):
        x1, y1, x2, y2 = boxes[i]
        fx1, fy1 = float(boxes[i][0]), float(boxes[i][1])
        x1 = int(max(x1, 0)); y1 = int(max(y1, 0))
        x2 = int(min(x2, w)); y2 = int(min(y2, h))
        if x2 <= x1 or y2 <= y1:
            continue
        color = RENDER_COLORS[int(classes[i]) % len(RENDER_COLORS)]
        if brightness is not None:
            color = np.clip(color * float(brightness[i]), 0.0, 1.0)
        if tex_amp > 0.0 and tex_theta is not None:
            yy, xx = np.mgrid[y1:y2, x1:x2].astype(np.float32)
            xx -= fx1
            yy -= fy1
            th = float(tex_theta[i])
            lam = max(float(tex_lambda[i]), 2.0)
            phase = 2.0 * np.pi * (xx * np.cos(th) + yy * np.sin(th)) / lam
            mod = 1.0 + tex_amp * np.sin(phase)
            image[y1:y2, x1:x2] = np.clip(
                color[None, None, :] * mod[:, :, None], 0.0, 1.0
            )
        else:
            image[y1:y2, x1:x2] = color
    return image


def render_video_clip(
    cfg: SyntheticClipConfig,
    render_hw: Tuple[int, int] = (256, 384),
    bg_mean: float = 0.45,
    bg_noise: float = 0.08,
):
    """Render a temporally consistent RGB clip of the scripted trajectories.

    Returns (frames_u8 (T, H, W, 3), gt) with gt boxes in RENDER pixels,
    clipped to the frame; ``present`` also requires >= 40% of the box area
    inside the frame.
    """
    gt = _ground_truth(cfg)
    t_total, k = gt["boxes"].shape[:2]
    hr, wr = render_hw
    hc, wc = cfg.image_size
    sxy = np.array([wr / wc, hr / hc, wr / wc, hr / hc], np.float32)
    boxes = gt["boxes"] * sxy

    rng = np.random.default_rng(cfg.seed + 7777)
    brightness = rng.uniform(0.75, 1.15, k)
    tex_theta = tex_lambda = None
    if cfg.texture_amp > 0.0:
        tex_theta = rng.uniform(0.0, np.pi, k)
        tex_lambda = rng.uniform(4.0, 12.0, k)

    clipped = boxes.copy()
    clipped[..., 0::2] = np.clip(clipped[..., 0::2], 0, wr)
    clipped[..., 1::2] = np.clip(clipped[..., 1::2], 0, hr)
    area = np.maximum(boxes[..., 2] - boxes[..., 0], 0) * np.maximum(
        boxes[..., 3] - boxes[..., 1], 0
    )
    area_in = np.maximum(clipped[..., 2] - clipped[..., 0], 0) * np.maximum(
        clipped[..., 3] - clipped[..., 1], 0
    )
    present = gt["present"] & (area_in >= 0.4 * np.maximum(area, 1e-6))

    frames = np.empty((t_total, hr, wr, 3), np.uint8)
    for t in range(t_total):
        img = rng.normal(bg_mean, bg_noise, (hr, wr, 3)).astype(np.float32)
        live = np.where(present[t])[0]
        draw_rect_objects(
            img, clipped[t, live], gt["classes"][live], brightness[live],
            tex_theta=None if tex_theta is None else tex_theta[live],
            tex_lambda=None if tex_lambda is None else tex_lambda[live],
            tex_amp=cfg.texture_amp,
        )
        frames[t] = (np.clip(img, 0, 1) * 255).astype(np.uint8)

    gt_render = {
        "boxes": clipped.astype(np.float32),
        "present": present,
        "ids": gt["ids"],
        "classes": gt["classes"],
    }
    return frames, gt_render
