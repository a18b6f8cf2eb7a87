"""COCO-format conversion and the training-batch iterator (counterpart of
``data/coco.py``).

``convert_segments_to_coco`` turns Waymo segments (TFRecord files, or
directory segments with ``meta.json``) into a COCO directory (``images/`` with
the JPEG bytes as they are, ``annotations.json`` with the camera labels and
their track ids). ``CocoTrainDataset.make_batch`` decodes, augments and
letterboxes one batch on the host as the JAX package does, from the same
``default_rng((seed, batch_index))`` draws, with two substitutions for cv2,
which the port does not use: the decode is ``data/jpeg.py`` (libjpeg, as
cv2's), and the resize is ``resize_linear``, cv2's float32 ``INTER_LINEAR``
written out (pixel centres mapped by ``(d + 0.5) * src / dst - 0.5``, two
taps per axis in float32, columns clamped with their weight set to 0 and
rows clamped at the edges).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from waymo_2d_tracking_tpu_torch import resolve_device
from waymo_2d_tracking_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD

# internal class ids: 0 vehicle, 1 pedestrian, 2 cyclist
WAYMO_TYPE_TO_CLASS = {1: 0, 2: 1, 4: 2}
CATEGORIES = [
    {"id": 1, "name": "vehicle"},
    {"id": 2, "name": "pedestrian"},
    {"id": 3, "name": "cyclist"},
]


def _annotation(ann_id, img_id, xyxy, waymo_type, track_id) -> dict:
    x1, y1, x2, y2 = xyxy
    return {"id": ann_id, "image_id": img_id,
            "category_id": WAYMO_TYPE_TO_CLASS.get(waymo_type, 0) + 1,
            "bbox": [x1, y1, x2 - x1, y2 - y1], "area": (x2 - x1) * (y2 - y1),
            "iscrowd": 0, "track_id": track_id}


def convert_segments_to_coco(segments_dir: str, out_dir: str) -> int:
    """Waymo segments -> COCO dataset dir (images/ + annotations.json).
    Returns the number of images."""
    from waymo_2d_tracking_tpu_torch.data import waymo
    from waymo_2d_tracking_tpu_torch.io_out import submission as subm

    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    images, annotations = [], []
    img_id = 0

    def add_image(jpeg: bytes, context: str) -> int:
        nonlocal img_id
        img_id += 1
        fname = f"{img_id:08d}.jpg"
        with open(os.path.join(out_dir, "images", fname), "wb") as f:
            f.write(jpeg)
        images.append({"id": img_id, "file_name": fname, "context": context})
        return img_id

    for entry in sorted(os.listdir(segments_dir)):
        full = os.path.join(segments_dir, entry)
        if entry.endswith(".tfrecord"):
            for rec in waymo.read_tfrecord(full):
                fr = waymo.parse_frame(rec)
                for cam, jpeg in fr["images"].items():
                    if not jpeg:
                        continue
                    iid = add_image(jpeg, fr["context_name"] or entry)
                    for lab in fr["labels"].get(cam, []):
                        annotations.append(_annotation(len(annotations) + 1, iid, lab["xyxy"],
                                                       lab["type"], lab["id"]))
        elif os.path.isdir(full) and os.path.exists(os.path.join(full, "meta.json")):
            with open(os.path.join(full, "meta.json")) as f:
                meta = json.load(f)
            labels_path = os.path.join(full, "labels.jsonl")
            by_frame: Dict[tuple, list] = {}
            if os.path.exists(labels_path):
                for r in subm.read_jsonl(labels_path):
                    by_frame.setdefault((r.timestamp_micros, r.camera_name), []).append(r)
            for t, ts in enumerate(meta["timestamps"]):
                for _cam_name, cam_id in meta["cameras"].items():
                    src = os.path.join(full, "frames", f"{t}_{cam_id}.jpg")
                    if not os.path.exists(src):
                        continue
                    with open(src, "rb") as f:
                        iid = add_image(f.read(), meta["context_name"])
                    for r in by_frame.get((ts, cam_id), []):
                        annotations.append(_annotation(len(annotations) + 1, iid, r.to_xyxy(),
                                                       r.object_type, r.object_id))

    with open(os.path.join(out_dir, "annotations.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": CATEGORIES}, f)
    return img_id


def _linear_taps(src: int, dst: int):
    """cv2 INTER_LINEAR's source index and float32 weight per output index."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(np.float32)).astype(np.float32)


def resize_linear(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` of an
    (H, W, C) float32 image, in float32."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return img.copy()
    sx, fx = _linear_taps(w, ow)
    edge = (sx < 0) | (sx >= w - 1)
    fx = np.where(edge, np.float32(0), fx)
    sx = np.clip(sx, 0, w - 1)
    ax0 = (np.float32(1) - fx)[None, :, None]
    rows = img[:, sx] * ax0 + img[:, np.minimum(sx + 1, w - 1)] * fx[None, :, None]
    sy, fy = _linear_taps(h, oh)
    y0, y1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    out = rows[y0] * (np.float32(1) - fy)[:, None, None] + rows[y1] * fy[:, None, None]
    return out.astype(np.float32)


class CocoTrainDataset:
    """Decoded and augmented training batches from a COCO dataset dir.

    ``make_batch(batch_index)`` is pure in the batch index: a fresh
    ``np.random.default_rng((seed, batch_index))`` drives the sampling and
    every augmentation draw, so batches do not depend on how many workers
    make them or in which order. Augmentation: horizontal flip, scale
    jitter (``scale_range`` times the letterbox scale; an upscaled image is
    randomly cropped to the canvas, a downscaled one randomly placed),
    brightness / contrast / saturation each in 1 +- ``color_jitter``; boxes
    follow the geometry and are dropped below ``min_box_px`` on a side.
    ``sample_by_context`` draws each batch's frames from one segment, so
    identities recur within a batch (the ReID losses need that).
    """

    def __init__(self, coco_dir: str, batch_size: int, image_hw: Tuple[int, int],
                 max_gt: int = 64, seed: int = 0, flip_augment: bool = True,
                 scale_range: Tuple[float, float] = (1.0, 1.0), color_jitter: float = 0.0,
                 min_box_px: float = 2.0, sample_by_context: bool = False):
        with open(os.path.join(coco_dir, "annotations.json")) as f:
            coco = json.load(f)
        self.anns_by_img: dict = {}
        # track ids interned per segment context: the same id string in two
        # segments labels two objects; integer id 0 is a valid track
        ctx_of_img = {im["id"]: im.get("context", "") for im in coco["images"]}
        self.track_id_intern: dict = {}
        for a in coco["annotations"]:
            self.anns_by_img.setdefault(a["image_id"], []).append(a)
            tid = a.get("track_id")
            if tid is not None and tid != "":
                key = (ctx_of_img.get(a["image_id"], ""), tid)
                self.track_id_intern.setdefault(key, len(self.track_id_intern))
        self._ctx_of_img = ctx_of_img
        self.items = [(im["id"], im["file_name"]) for im in coco["images"]]
        self.sample_by_context = sample_by_context
        self._items_by_ctx: dict = {}
        for i, im in enumerate(coco["images"]):
            self._items_by_ctx.setdefault(im.get("context", ""), []).append(i)
        self.coco_dir = coco_dir
        self.batch_size = batch_size
        self.image_hw = image_hw
        self.max_gt = max_gt
        self.seed = seed
        self.flip_augment = flip_augment
        self.scale_range = scale_range
        self.color_jitter = color_jitter
        self.min_box_px = min_box_px
        self._local = threading.local()     # per-thread decoders by size

    def _decode(self, fname: str) -> np.ndarray:
        """RGB float32 in [0, 1] of one image file."""
        from waymo_2d_tracking_tpu_torch.data.jpeg import BatchJpegDecoder, jpeg_dims

        with open(os.path.join(self.coco_dir, "images", fname), "rb") as f:
            blob = f.read()
        hw = jpeg_dims(blob)
        decoders = self._local.__dict__.setdefault("decoders", {})
        if hw not in decoders:
            decoders[hw] = BatchJpegDecoder(*hw, n_threads=1)
        return decoders[hw].decode([blob])[0].astype(np.float32) / 255.0

    def make_batch(self, batch_index: int) -> dict:
        """One host-side batch of numpy arrays: decode, augment, letterbox."""
        rng = np.random.default_rng((self.seed, batch_index))
        batch_size, max_gt = self.batch_size, self.max_gt
        hd, wd = self.image_hw
        items, anns_by_img = self.items, self.anns_by_img
        if self.sample_by_context:
            ctx = sorted(self._items_by_ctx)[int(rng.integers(len(self._items_by_ctx)))]
            pool = self._items_by_ctx[ctx]
            idx = rng.choice(pool, size=batch_size, replace=len(pool) < batch_size)
        else:
            idx = rng.choice(len(items), size=batch_size, replace=len(items) < batch_size)
        images = np.zeros((batch_size, hd, wd, 3), np.float32)
        gt_boxes = np.zeros((batch_size, max_gt, 4), np.float32)
        gt_classes = np.zeros((batch_size, max_gt), np.int32)
        gt_valid = np.zeros((batch_size, max_gt), bool)
        gt_track_ids = np.full((batch_size, max_gt), -1, np.int32)
        for n, i in enumerate(idx):
            img_id, fname = items[i]
            rgb = self._decode(fname)
            hs, ws = rgb.shape[:2]
            scale = min(hd / hs, wd / ws) * float(rng.uniform(*self.scale_range))
            eh, ew = max(int(round(hs * scale)), 1), max(int(round(ws * scale)), 1)
            resized = resize_linear(rgb, (eh, ew))
            if self.color_jitter > 0.0:
                cj = self.color_jitter
                resized = resized * (1.0 + rng.uniform(-cj, cj))      # brightness
                mean = resized.mean()
                resized = (resized - mean) * (1.0 + rng.uniform(-cj, cj)) + mean
                gray = resized.mean(axis=2, keepdims=True)            # saturation
                resized = gray + (resized - gray) * (1.0 + rng.uniform(-cj, cj))
                resized = np.clip(resized, 0.0, 1.0)
            flip = self.flip_augment and rng.uniform() < 0.5
            if flip:
                resized = resized[:, ::-1]
            # random placement (small image) or random crop (large image)
            ox = (int(rng.integers(0, wd - ew + 1)) if ew <= wd
                  else -int(rng.integers(0, ew - wd + 1)))
            oy = (int(rng.integers(0, hd - eh + 1)) if eh <= hd
                  else -int(rng.integers(0, eh - hd + 1)))
            sx, sy = max(-ox, 0), max(-oy, 0)
            dx, dy = max(ox, 0), max(oy, 0)
            cw = min(ew - sx, wd - dx)
            ch = min(eh - sy, hd - dy)
            images[n, dy: dy + ch, dx: dx + cw] = resized[sy: sy + ch, sx: sx + cw]

            g = 0
            for a in anns_by_img.get(img_id, []):
                if g >= max_gt:
                    break
                x, y, w, h = a["bbox"]
                x1, y1, x2, y2 = x * scale, y * scale, (x + w) * scale, (y + h) * scale
                if flip:
                    x1, x2 = ew - x2, ew - x1
                x1, x2 = np.clip([x1 + ox, x2 + ox], 0.0, float(wd))
                y1, y2 = np.clip([y1 + oy, y2 + oy], 0.0, float(hd))
                if x2 - x1 < self.min_box_px or y2 - y1 < self.min_box_px:
                    continue  # cropped away or degenerate
                gt_boxes[n, g] = [x1, y1, x2, y2]
                gt_classes[n, g] = a["category_id"] - 1
                gt_valid[n, g] = True
                gt_track_ids[n, g] = self.track_id_intern.get(
                    (self._ctx_of_img.get(img_id, ""), a.get("track_id")), -1)
                g += 1
        images = (images - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(
            IMAGENET_STD, np.float32)
        return {"images": images, "gt_boxes": gt_boxes, "gt_classes": gt_classes,
                "gt_valid": gt_valid, "gt_track_ids": gt_track_ids}

    def batches(self, num_workers: int = 0) -> Iterator[dict]:
        """Infinite ordered batch stream; ``num_workers`` > 0 makes batches in
        a thread pool with a bounded look-ahead (the decode releases the
        GIL). The same batches in the same order for any worker count."""
        if num_workers <= 0:
            i = 0
            while True:
                yield self.make_batch(i)
                i += 1
        from concurrent.futures import ThreadPoolExecutor

        window = num_workers + 2
        with ThreadPoolExecutor(num_workers) as pool:
            pending = {i: pool.submit(self.make_batch, i) for i in range(window)}
            i = 0
            while True:
                batch = pending.pop(i).result()
                pending[i + window] = pool.submit(self.make_batch, i + window)
                yield batch
                i += 1


def coco_batch_iterator(coco_dir: str, batch_size: int, image_hw: Tuple[int, int],
                        max_gt: int = 64, seed: int = 0, flip_augment: bool = True,
                        scale_range: Tuple[float, float] = (1.0, 1.0),
                        color_jitter: float = 0.0, min_box_px: float = 2.0,
                        num_workers: int = 0, prefetch_depth: int = 0,
                        sample_by_context: bool = False, device="cuda") -> Iterator[dict]:
    """Infinite shuffled training batches as dicts of tensors on ``device``.
    ``num_workers`` > 0: made in background threads (ordered, deterministic);
    ``prefetch_depth`` > 0: copied to the device ahead of the step through
    ``data/prefetch.py DevicePrefetcher`` (pinned buffers, a side stream)."""
    dev = resolve_device(device)
    ds = CocoTrainDataset(coco_dir, batch_size, image_hw, max_gt=max_gt, seed=seed,
                          flip_augment=flip_augment, scale_range=scale_range,
                          color_jitter=color_jitter, min_box_px=min_box_px,
                          sample_by_context=sample_by_context)
    gen = ds.batches(num_workers=num_workers)
    if prefetch_depth > 0:
        from waymo_2d_tracking_tpu_torch.data.prefetch import DevicePrefetcher

        # context-managed: a loop that stops after N steps (or dies) releases
        # the worker and the batch producer
        with DevicePrefetcher(gen, depth=prefetch_depth, device=dev) as pf:
            yield from pf
        return
    try:
        for batch in gen:
            yield {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    finally:
        gen.close()
