"""Core tensor types shared across the port (counterpart of ``types.py``).

Detections are padded to ``max_detections`` with a validity mask and the
tracker state is a fixed-capacity slot table, with the same fields, shapes,
dtypes and ``SLOT_*`` codes as the JAX package. Boxes are ``[x1, y1, x2,
y2]`` pixels throughout.

``from_numpy`` takes any object with the same field names (a JAX pytree
passed through ``np.asarray`` per field works), so tests feed one set of
numpy inputs to both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Track slot states (int8 codes in TrackerState.status).
SLOT_EMPTY = 0      # free slot
SLOT_TENTATIVE = 1  # born, not yet confirmed (hits < n_init)
SLOT_CONFIRMED = 2  # confirmed, actively tracked
SLOT_LOST = 3       # missed > max_age as confirmed; kept for re-ID recovery


class _TensorRecord:
    """Field-wise helpers shared by the tensor dataclasses."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to(self, device):
        return type(self)(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })

    def to_numpy(self):
        """Same record with every field as a numpy array (one host copy)."""
        return type(self)(**{
            f.name: getattr(self, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(self)
        })

    @classmethod
    def from_numpy(cls, obj, device="cpu"):
        """Build from any object carrying the same field names."""
        return cls(**{
            f.name: torch.as_tensor(np.array(getattr(obj, f.name)),
                                    device=device)
            for f in dataclasses.fields(cls)
        })

    def __getitem__(self, idx):
        """Index every field along its leading axis (time / batch)."""
        return type(self)(**{
            f.name: getattr(self, f.name)[idx]
            for f in dataclasses.fields(self)
        })

    @classmethod
    def stack(cls, records, dim: int = 0):
        return cls(**{
            f.name: torch.stack([getattr(r, f.name) for r in records], dim)
            for f in dataclasses.fields(cls)
        })


@dataclasses.dataclass
class Detections(_TensorRecord):
    """Fixed-size per-frame detections (padded; ``valid`` masks real entries).

    boxes (D, 4) f32 xyxy, scores (D,) f32, classes (D,) i32,
    embeds (D, E) f32 L2-normalized (zeros without ReID), valid (D,) bool.
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    embeds: torch.Tensor
    valid: torch.Tensor

    @property
    def max_detections(self) -> int:
        return self.boxes.shape[-2]


@dataclasses.dataclass
class TrackerState(_TensorRecord):
    """Fixed-capacity track table (S slots, E embed dim, K gallery ring).

    mean (S, 8) f32 [cx, cy, w, h, vcx, vcy, vw, vh], cov (S, 8, 8) f32,
    track_id (S,) i32 (-1 empty), status (S,) i8 SLOT_* codes, hits /
    time_since_update / age / classes (S,) i32, score (S,) f32,
    embed (S, E) f32, gallery (S, K, E) f32, gallery_count (S,) i32,
    next_id () i32 and frame_idx () i32 (0-d tensors, kept on the device so
    a step never syncs with the host). A multi-camera state puts a camera
    axis C in front of every field: next_id and frame_idx are then (C,),
    one id counter per camera.
    """

    mean: torch.Tensor
    cov: torch.Tensor
    track_id: torch.Tensor
    status: torch.Tensor
    hits: torch.Tensor
    time_since_update: torch.Tensor
    age: torch.Tensor
    classes: torch.Tensor
    score: torch.Tensor
    embed: torch.Tensor
    gallery: torch.Tensor
    gallery_count: torch.Tensor
    next_id: torch.Tensor
    frame_idx: torch.Tensor

    @property
    def max_tracks(self) -> int:
        return self.mean.shape[-2]


@dataclasses.dataclass
class TrackOutputs(_TensorRecord):
    """Per-frame tracker emissions (S slots); only ``valid`` slots are real
    reported tracks (confirmed and matched this frame)."""

    track_id: torch.Tensor  # (S,)  i32
    boxes: torch.Tensor     # (S,4) f32 xyxy
    scores: torch.Tensor    # (S,)  f32
    classes: torch.Tensor   # (S,)  i32
    valid: torch.Tensor     # (S,)  bool


def boxes_xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """[x1,y1,x2,y2] -> [cx,cy,w,h] (last-dim 4)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack(
        [(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], dim=-1
    )


def boxes_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[cx,cy,w,h] -> [x1,y1,x2,y2] (last-dim 4)."""
    cx, cy, w, h = boxes.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)
