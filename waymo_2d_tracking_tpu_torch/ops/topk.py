"""Top-k selection (counterpart of ``ops/topk.py``).

``topk_threshold`` is the exact k-th largest value of a score vector plus the
count of scores strictly above it. A CUDA tensor launches the hand-written
kernel ``csrc/topk.cu``, a radix select over order-preserving 32-bit keys (it
replaces the Pallas ``_threshold_kernel``); a CPU tensor runs
``topk_threshold_reference``, the plain PyTorch version of the Pallas
kernel's binary search, step for step and to the bit:

- ``lo = min(s) - 1``, ``hi = max(s)``;
- 40 halvings: ``mid = (lo + hi) * 0.5`` in float32; ``count(s >= mid) >= k``
  sets ``lo = mid``, else ``hi = mid``;
- snap ``kth = min{s : s >= lo}``; the round is verified when
  ``count(s > kth) < k``, else the next round restarts from ``lo = kth``
  with ``hi`` kept, at most 16 rounds;
- the result is ``(kth, count(s > kth))``.

Domain: finite scores, no NaN, ``|s| < 2**127``, ``N < 2**24``. There both
compute the same function, the exact k-th largest score (each round of the
search narrows its interval by 2**40, so it reaches adjacent floats well
inside 16 rounds); -0.0 and +0.0 count as equal, so a k-th value of zero may
come back with either sign. Outside it they differ: near +-FLT_MAX ``lo +
hi`` overflows and the search no longer returns the k-th largest value. The
wrappers do not check the domain (a check would cost a host sync). The
Pallas kernel counts in float32, exact below 2**24 elements; the port counts
in integers and refuses N >= 2**24 rather than differ silently.

``topk_mask`` selects exactly k entries (ties broken by lowest flat index);
``topk`` is the ordered top-k the detector uses.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from waymo_2d_tracking_tpu_torch.ops import _cuda
from waymo_2d_tracking_tpu_torch.ops.nms import topk_stable

ITERS = 40          # halvings per round (the Pallas kernel's ``iters``)
ROUNDS = 16         # snap-and-verify rounds at most
MAX_N = 1 << 24     # float32 counts in the Pallas kernel are exact below this
METHODS = ("exact", "approx")


def _check(n: int, k: int) -> None:
    if n == 0:
        raise ValueError("top-k threshold of an empty score vector")
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    if n >= MAX_N:
        raise ValueError(f"n={n} >= 2**24: the reference kernel's float32 "
                         "counts are not exact there")


def topk_threshold_reference(scores: torch.Tensor, k: int, with_rounds: bool = False):
    """Plain PyTorch threshold search over ``scores`` (any shape, flattened):
    (kth float32 0-dim, n_above int32 0-dim), step for step the Pallas
    kernel's binary search. On finite scores with ``|s| < 2**127`` and
    ``N < 2**24`` this is the exact k-th largest score and the count above
    it, the function ``csrc/topk.cu`` computes by radix select; outside that
    domain the two differ (see the module docstring). ``with_rounds``
    appends the number of snap-and-verify rounds it took."""
    s = scores.reshape(-1).to(torch.float32)
    _check(s.numel(), k)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=s.device)
    lo = s.min() - 1.0
    hi = s.max()
    for rounds in range(1, ROUNDS + 1):
        for _ in range(ITERS):
            mid = (lo + hi) * 0.5
            take = (s >= mid).sum() >= k
            lo = torch.where(take, mid, lo)
            hi = torch.where(take, hi, mid)
        kth = torch.where(s >= lo, s, inf).min()
        above = (s > kth).sum()
        lo = kth
        if bool(above < k):
            break
    if with_rounds:
        return kth, above.to(torch.int32), rounds
    return kth, above.to(torch.int32)


def topk_threshold_cuda(scores: torch.Tensor, k: int):
    """Launch ``csrc/topk.cu`` on B score vectors at once: scores (B, N)
    float32, a contiguous CUDA tensor, 1 <= k <= N. Returns (kth (B,)
    float32, n_above (B,) int32), one CTA per vector: a radix select in three
    digit passes over order-preserving keys. Its domain is that of
    ``topk_threshold_reference``: finite scores, no NaN, ``|s| < 2**127``,
    ``N < 2**24``; a k-th value of zero comes back as +0.0."""
    if scores.device.type != "cuda":
        raise ValueError("topk_threshold_cuda takes a CUDA tensor")
    if scores.dtype != torch.float32:
        raise TypeError("scores must be float32")
    if scores.dim() != 2 or not scores.is_contiguous():
        raise ValueError(f"scores must be a contiguous (B, N) tensor, got {tuple(scores.shape)}")
    b, n = scores.shape
    _check(n, k)
    if k < 1:
        raise ValueError(f"k={k} < 1")
    kth = torch.empty((b,), dtype=torch.float32, device=scores.device)
    cnt = torch.empty((b,), dtype=torch.int32, device=scores.device)
    lib = _cuda.library("topk")
    with torch.cuda.device(scores.device):
        err = lib.w2t_topk_threshold(
            ctypes.c_void_p(scores.data_ptr()), ctypes.c_void_p(kth.data_ptr()),
            ctypes.c_void_p(cnt.data_ptr()), ctypes.c_int(b), ctypes.c_int(n),
            ctypes.c_int(k), ctypes.c_void_p(_cuda.stream_handle(scores.device)),
        )
    _cuda.check(err, "topk")
    topk_threshold_cuda.launches += 1
    return kth, cnt


topk_threshold_cuda.launches = 0


def topk_threshold(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-th largest value of ``scores`` (any shape, flattened) and the
    count of entries strictly above it: (kth (), n_above ()).

    A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
    """
    flat = scores.reshape(1, -1).to(torch.float32).contiguous()
    if flat.device.type == "cuda":
        kth, cnt = topk_threshold_cuda(flat, k)
        return kth[0], cnt[0]
    return topk_threshold_reference(flat, k)


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask selecting exactly the top-k entries of ``scores``, ties
    at the k-th value broken by lowest flat index (a cumsum rank)."""
    kth, n_above = topk_threshold(scores, k)
    flat = scores.reshape(-1).to(torch.float32)
    above = flat > kth
    ties = flat == kth
    tie_rank = torch.cumsum(ties.to(torch.int32), 0) - 1
    sel = above | (ties & (tie_rank < k - n_above))
    return sel.reshape(scores.shape)


def topk(scores: torch.Tensor, k: int, method: str = "exact"):
    """Top-k values and flat indices of ``scores``, descending, ties lowest
    index first (``lax.top_k``'s order).

    ``method='approx'`` is ``lax.approx_max_k`` in the JAX package, which is
    approximate only on the TPU: on the CPU and GPU XLA computes it exactly.
    The port gives the exact result for both methods.
    """
    if method not in METHODS:
        raise ValueError(f"topk method must be one of {METHODS}, got {method!r}")
    return topk_stable(scores.reshape(-1), k)
