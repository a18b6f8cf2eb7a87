"""PyTorch / CUDA port of the detect-and-track framework, for NVIDIA Hopper.

The module layout mirrors the JAX package, which stays the numerical
reference: ``config``, ``types``, ``ops/{iou,nms,assign,roi_align,topk}``,
``tracker/{kalman,cost,lifecycle,tracker}``, ``data/{preprocess,synthetic}``,
``models/{resnet,fpn,heads,centernet,reid,detector}``, ``pipeline/{run,tta}``,
``io_out/submission``, ``eval/mot`` and ``weights``.

Public functions keep the JAX package's layouts (NHWC images and features,
``(N, D, 4)`` xyxy boxes, the same dtypes). Every Pallas kernel of the JAX
package is a hand-written CUDA kernel for ``sm_90a`` under ``csrc/`` (NMS and
the auction on the main path, the top-k threshold and the gather-form
RoIAlign behind their own entry points), built with ``nvcc`` at first use
(``ops/_cuda.py``).

Entry points take an explicit ``device`` that defaults to ``"cuda"``; without
a card they raise unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is
    no card (there is no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev
