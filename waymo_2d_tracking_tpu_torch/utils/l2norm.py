"""L2 norms with the bits of the JAX package's jitted ``jnp.linalg.norm`` on the
CPU, for the two places the port normalizes embeddings: the ReID head's output
(``models/reid.py``) and the tracker's appearance update
(``tracker/lifecycle.py ema_normalize``).

XLA's CPU code (``XLA_FLAGS=--xla_dump_to=...``) sums the squares in an order
that depends on the width E of the last axis:

- E a multiple of 32 and at least 64: XLA rewrites the reduce into a
  ``reduce-window`` of size 32. Each square is rounded to float32 (its own
  fusion, no fma), each contiguous window of 32 is summed in order, then the
  window sums in order;
- E <= 32: a plain reduce, which LLVM contracts: ``acc = fma(x, x, acc)`` in
  order from 0;
- other widths: not read; ``torch.linalg.vector_norm``.

Then ``sqrt``, ``max(., 1e-8)`` and a true division. An fma here is a float64
add of the exact float64 product, rounded once to float32: it differs from
the fused operation only when that add is inexact and lands exactly on a
float32 midpoint. The square root runs in float64 and rounds to float32,
which is exact (53 >= 2 * 24 + 2) where torch's vectorized CPU ``sqrt`` may
not be. Every step is an elementwise op on the tensor's device, so the card
gives the CPU's bits, and a CUDA graph can capture it.
"""
from __future__ import annotations

import torch

WINDOW = 32


def fma(x: torch.Tensor, y: float, z: torch.Tensor) -> torch.Tensor:
    """float32 ``x * y + z`` rounded once: x, z float32 tensors, y a Python
    float holding a float32 value (so the step can be captured)."""
    return torch.add(z, x.double(), alpha=y).float()


def sum_squares(x: torch.Tensor) -> torch.Tensor | None:
    """XLA's float32 sum of squares over the last axis, or None for a width
    whose order was not read."""
    e = x.shape[-1]
    if e % WINDOW == 0 and e > WINDOW:
        sq = (x * x).unflatten(-1, (e // WINDOW, WINDOW))
        win = sq[..., 0]            # the window sums start at 0: 0 + s = s
        for i in range(1, WINDOW):
            win = win + sq[..., i]
        ss = win[..., 0]
        for j in range(1, e // WINDOW):
            ss = ss + win[..., j]
        return ss
    if e <= WINDOW:
        sq = x.double().square()    # exact: fma(x, x, acc) is sq + acc rounded once
        ss = sq[..., 0].float()
        for i in range(1, e):
            ss = (sq[..., i] + ss).float()
        return ss
    return None


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(x, axis=-1)`` as XLA computes it on the CPU."""
    ss = sum_squares(x)
    if ss is None:
        return torch.linalg.vector_norm(x, dim=-1)
    return torch.sqrt(ss.double()).float()


def divide_by_norm(num: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """``num / max(norm, 1e-8)[..., None]`` in float32: a tensor divisor
    divides correctly rounded on the CPU and the card alike (a Python
    scalar divisor would become a reciprocal multiply on the card)."""
    return num / torch.clamp(norm, min=1e-8)[..., None]


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """``x / max(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-8)``."""
    return divide_by_norm(x, l2_norm(x))
