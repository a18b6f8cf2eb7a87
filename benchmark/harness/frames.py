"""The benchmark's frames: scripted trajectories (constant-velocity boxes of
three classes, two objects hidden for a stretch, the script of the
program's synthetic clips) drawn as class-coloured rectangles on a noise
background, on the device from the seed, then copied once into pinned host
memory. A bank holds ``groups`` x ``cams`` segments of ``frames`` frames.
Their object counts are spread evenly over ``objects`` (inclusive) and
dealt to the segments in an order drawn from the seed, so every seed draws
the same amount of scene."""
from __future__ import annotations

import numpy as np
import torch

COLORS = ((0.9, 0.2, 0.2), (0.2, 0.9, 0.2), (0.2, 0.2, 0.9))


def trajectories(rng: np.random.Generator, frames: int, k: int, hw, occlusion=(60, 90)):
    """(boxes (T, K, 4) float64 xyxy, present (T, K), classes (K,))."""
    h, w = hw
    cx0, cy0 = rng.uniform(0.1 * w, 0.9 * w, k), rng.uniform(0.1 * h, 0.9 * h, k)
    vx, vy = rng.uniform(-6, 6, k), rng.uniform(-3, 3, k)
    bw, bh = rng.uniform(60, 180, k), rng.uniform(60, 180, k)
    t = np.arange(frames, dtype=np.float64)[:, None]
    cx, cy = cx0[None] + vx[None] * t, cy0[None] + vy[None] * t
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    present = (cx > -bw) & (cx < w + bw) & (cy > -bh) & (cy < h + bh)
    a, b = occlusion
    if k >= 2:
        present[a:b, :2] = False
    return boxes, present, np.arange(k) % 3


def object_counts(seed: int, n: int, objects) -> list:
    counts = np.round(np.linspace(objects[0], objects[1], n)).astype(int)
    return np.random.default_rng([seed, 1]).permutation(counts).tolist()


def segment_plan(seed: int, index: int, frames: int, k: int, hw):
    """The host-side script of one segment: per frame the integer rectangles
    and the object each belongs to, in drawing order, and the objects'
    colours (K, 3)."""
    rng = np.random.default_rng([seed, index])
    boxes, present, classes = trajectories(rng, frames, k, hw)
    bright = rng.uniform(0.75, 1.15, k)
    h, w = hw
    clipped = boxes.copy()
    clipped[..., 0::2] = np.clip(clipped[..., 0::2], 0, w)
    clipped[..., 1::2] = np.clip(clipped[..., 1::2], 0, h)
    area = np.maximum(boxes[..., 2] - boxes[..., 0], 0) * np.maximum(boxes[..., 3] - boxes[..., 1], 0)
    inside = (np.maximum(clipped[..., 2] - clipped[..., 0], 0)
              * np.maximum(clipped[..., 3] - clipped[..., 1], 0))
    present &= inside >= 0.4 * np.maximum(area, 1e-6)
    plan = []
    for f in range(frames):
        rects = []
        for i in np.flatnonzero(present[f]):
            x1, y1, x2, y2 = clipped[f, i]
            x1, y1, x2, y2 = int(max(x1, 0)), int(max(y1, 0)), int(min(x2, w)), int(min(y2, h))
            if x2 > x1 and y2 > y1:
                rects.append((y1, y2, x1, x2, int(i)))
        plan.append(rects)
    colors = np.clip(np.array(COLORS)[classes] * bright[:, None], 0.0, 1.0)
    return plan, colors.astype(np.float32)


def draw_bank(seed: int, groups: int, cams: int, frames: int, objects, hw, device,
              block: int = 16):
    """(groups, cams, frames, H, W, 3) uint8 in host memory (pinned when the
    device is a card), drawn on ``device``; returns (bank, object counts)."""
    h, w = hw
    pin = torch.device(device).type == "cuda"
    bank = torch.empty((groups, cams, frames, h, w, 3), dtype=torch.uint8, pin_memory=pin)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    counts = object_counts(seed, groups * cams, objects)
    for g in range(groups):
        for c in range(cams):
            plan, colors = segment_plan(seed, g * cams + c, frames, counts[g * cams + c], hw)
            colors = torch.from_numpy(colors).to(device)
            for f0 in range(0, frames, block):
                n = min(block, frames - f0)
                img = torch.randn((n, h, w, 3), generator=gen, device=device) * 0.08 + 0.45
                for j in range(n):
                    for y1, y2, x1, x2, i in plan[f0 + j]:
                        img[j, y1:y2, x1:x2] = colors[i]
                bank[g, c, f0:f0 + n].copy_((img.clamp_(0.0, 1.0) * 255.0).to(torch.uint8))
    return bank, counts
