"""Non-maximum suppression (counterpart of ``ops/nms.py``).

``nms_mask_batched`` is the greedy keep-mask over score-sorted boxes. A CUDA
tensor launches the hand-written kernel ``csrc/nms.cu`` (it replaces the
Pallas ``_nms_kernel``); a CPU tensor runs ``nms_mask_reference``, the plain
PyTorch version of the same function, as JAX on the CPU runs the Pallas
kernel's semantics in interpret mode. Both are exact greedy NMS, bit for bit
equal to the JAX kernel: the IoU is ``inter / max(union, 1e-7)`` with
``union = area_i + area_j - inter``, every operation rounded on its own.

The kernel runs one CTA per image over blocks of 32 boxes: the block's owner
warp resolves the block's live boxes by a fixpoint of ballots, then every
live box of a later block is tested against the boxes just kept, dividing
only where a multiplication cannot decide. It stores nothing per pair and
takes any N, a multiple of 32 or not, as the JAX package (which pads any N
to a multiple of 128) does: up to ``SHARED_MAX_N`` = 8192 the boxes of one
image stay in shared memory; above it the wrapper hands the kernel a scratch
buffer in device memory (25 bytes a box) and the same schedule keeps its
per-box state there. Boxes must be finite.

``nms_batched`` is the full per-image sort -> suppress -> top-K selection.
``lax.top_k`` returns equal values lowest index first; ``torch.topk`` does
not promise that, so every top-k here is a stable descending sort.
"""
from __future__ import annotations

import ctypes

import torch

from waymo_2d_tracking_tpu_torch.ops import _cuda
from waymo_2d_tracking_tpu_torch.ops.iou import pairwise_iou

SHARED_MAX_N = 8192  # past it the kernel keeps its per-box state in device memory


def topk_stable(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: descending, ties lowest index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_mask_reference(boxes: torch.Tensor, valid: torch.Tensor,
                       iou_threshold: float = 0.6) -> torch.Tensor:
    """Plain PyTorch greedy NMS keep-mask, same contract as the kernel.

    boxes (B, N, 4) f32 sorted by descending score, valid (B, N) bool.
    Returns (B, N) bool. The walk is N sequential steps, vectorised over B;
    the IoU rows are computed a band of rows at a time (about 2^24 entries),
    so a large N needs no N x N matrix.
    """
    b, n = valid.shape
    thr = torch.tensor(iou_threshold, dtype=torch.float32).to(boxes.device)
    boxes = boxes.float()
    keep = torch.zeros((b, n), dtype=torch.bool, device=boxes.device)
    removed = torch.zeros((b, n), dtype=torch.bool, device=boxes.device)
    valid = valid.bool()
    band = max(1, (1 << 24) // max(b * n, 1))
    cols = torch.arange(n, device=boxes.device)
    for i0 in range(0, n, band):
        rows = torch.arange(i0, min(i0 + band, n), device=boxes.device)
        over = pairwise_iou(boxes[:, i0:i0 + band], boxes) > thr
        over &= cols[None, :] > rows[:, None]      # row i suppresses j > i
        for r in range(rows.numel()):
            i = i0 + r
            k = valid[:, i] & ~removed[:, i]
            keep[:, i] = k
            removed |= over[:, r, :] & k[:, None]
    return keep


def nms_mask_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                  iou_threshold: float = 0.6, with_cycles: bool = False):
    """Launch ``csrc/nms.cu``: boxes (B, N, 4) f32, valid (B, N) bool, both
    contiguous CUDA tensors, any N. Returns the (B, N) bool
    keep-mask; ``with_cycles`` launches the kernel's timed build and also
    returns its ``clock64`` readings, (B, 4) int64: cycles of the whole CTA,
    of its prologue (load and in-block words) and of the owners' turns summed
    (a block's test against the boxes kept before it, then its fixpoint), and
    the number of fixpoint rounds."""
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError("nms_mask_cuda takes CUDA tensors on one device")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError("boxes must be float32 and valid bool")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"bad shapes boxes {tuple(boxes.shape)} valid {tuple(valid.shape)}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    b, n = valid.shape
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    lib = _cuda.library("nms")
    args = [ctypes.c_void_p(boxes.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
            ctypes.c_void_p(keep.data_ptr()), ctypes.c_int(b), ctypes.c_int(n),
            ctypes.c_float(iou_threshold)]
    stream = ctypes.c_void_p(_cuda.stream_handle(boxes.device))
    cycles = scratch = None
    if with_cycles:
        cycles = torch.empty((b, 4), dtype=torch.int64, device=boxes.device)
    with torch.cuda.device(boxes.device):
        if n > SHARED_MAX_N:
            lib.w2t_nms_scratch_bytes.restype = ctypes.c_longlong
            per_image = lib.w2t_nms_scratch_bytes(ctypes.c_int(n))
            scratch = torch.empty((b * per_image,), dtype=torch.uint8, device=boxes.device)
        err = lib.w2t_nms_mask_any(
            *args, ctypes.c_void_p(0 if cycles is None else cycles.data_ptr()),
            ctypes.c_void_p(0 if scratch is None else scratch.data_ptr()), stream)
    _cuda.check(err, "nms")
    nms_mask_cuda.launches += 1
    nms_mask_cuda.last_shape = (b, n)
    return (keep, cycles) if with_cycles else keep


nms_mask_cuda.launches = 0
nms_mask_cuda.last_shape = None  # (B, N) of the last launch


def nms_mask_batched(boxes: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float = 0.6) -> torch.Tensor:
    """Greedy NMS keep-mask. boxes (B, N, 4) score-sorted, valid (B, N).

    A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
    """
    boxes = boxes.float().contiguous()
    valid = valid.bool().contiguous()
    if boxes.device.type == "cuda":
        return nms_mask_cuda(boxes, valid, iou_threshold)
    return nms_mask_reference(boxes, valid, iou_threshold)


def nms_batched(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.6,
    max_outputs: int = 128,
    score_threshold: float = 0.0,
):
    """Batched full NMS: per-image sort, suppress, return top ``max_outputs``.

    boxes (B, N, 4), scores (B, N). Returns (boxes (B, K, 4), scores (B, K),
    indices (B, K) into the input, valid (B, K) bool), K = max_outputs,
    padded with zeros / -1.
    """
    n = boxes.shape[-2]
    order_scores, order = topk_stable(scores, n)                    # (B, N)
    sorted_boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid = order_scores > score_threshold
    keep = nms_mask_batched(sorted_boxes, valid, iou_threshold)

    sel_scores = torch.where(keep, order_scores,
                             torch.full_like(order_scores, float("-inf")))
    top_scores, sel = topk_stable(sel_scores, max_outputs)          # (B, K)
    out_valid = torch.isfinite(top_scores)
    picked = torch.gather(sorted_boxes, 1, sel[..., None].expand(-1, -1, 4))
    out_boxes = torch.where(out_valid[..., None], picked, torch.zeros_like(picked))
    out_scores = torch.where(out_valid, top_scores, torch.zeros_like(top_scores))
    out_idx = torch.where(out_valid, torch.gather(order, 1, sel),
                          torch.full_like(sel, -1))
    return out_boxes, out_scores, out_idx, out_valid
