"""Shifted-window multi-head attention (Swin's W-MSA / SW-MSA) from the qkv
projection of a padded map to the attention output, before the output
projection.

The qkv projection is a per-token GEMM, so it commutes with the cyclic shift
and the window partition: the caller runs it on the padded, unshifted map,
``qkv`` (B, Hp, Wp, 3C) with Hp and Wp multiples of the window, channels
ordered (q | k | v, then head, then the head's dims) as the release's
``reshape(B_, N, 3, heads, C // heads)`` reads them. The op returns
(B, Hp, Wp, C) in the same unshifted layout, channels (head, dim), ready
for the output projection. Per window of ``window`` x ``window`` tokens of
the map rolled by (-shift, -shift), and per head:

    scores = (q * head_dim ** -0.5) @ k^T + table[relative_position_index]
             (+ the region mask on shifted maps: -100.0 between tokens of
              different regions of the release's ``img_mask``)
    out    = softmax(scores) @ v

then the windows are put back and the map rolled by (+shift, +shift).

Two forms of the same function:

- ``window_attention_reference``: the plain PyTorch path, the release's
  code order (roll, partition, matmul, bias, mask, softmax, matmul, reverse,
  roll back), in the input's dtype. It runs every CPU tensor;
- ``window_attention_cuda``: the hand-written ``csrc/window_attention.cu``,
  which folds the roll and the partition into its index arithmetic and adds
  the bias and the mask from the table and the window's position without a
  (windows, heads, N, N) tensor; softmax and sums in float32. It runs every
  CUDA tensor, training included: ``window_attention`` wraps it in an
  autograd function whose backward recomputes the plain path on the saved
  inputs and differentiates that (the kernel has no backward of its own).

Counters (``utils/profiling.py``, while a profiler records):
``window_attn_launches`` (calls of the op: on the card each is one kernel
launch) and ``window_attn_tokens`` (the padded tokens B x Hp x Wp a call
covers), both from the shapes, with no device read.
"""
from __future__ import annotations

import ctypes

import torch

from waymo_2d_tracking_tpu_torch.ops import _cuda
from waymo_2d_tracking_tpu_torch.utils.profiling import count

MASK_VALUE = -100.0     # the release's value for pairs the shift brought together
KERNEL_WINDOW = 7       # what csrc/window_attention.cu is built for
KERNEL_HEAD_DIM = 32


def relative_position_index(window: int, device=None) -> torch.Tensor:
    """(N, N) index into the (2w - 1)^2 bias table for tokens i, j of a
    window, N = w^2, as the release builds it: (dy + w - 1) * (2w - 1) +
    (dx + w - 1) with (dy, dx) = position of i minus position of j."""
    ys, xs = torch.meshgrid(torch.arange(window, device=device),
                            torch.arange(window, device=device), indexing="ij")
    coords = torch.stack([ys.flatten(), xs.flatten()])              # (2, N)
    rel = coords[:, :, None] - coords[:, None, :] + (window - 1)   # (2, N, N)
    return rel[0] * (2 * window - 1) + rel[1]


def shift_mask(hp: int, wp: int, window: int, shift: int, device=None) -> torch.Tensor:
    """(windows, N, N) additive mask of a map rolled by (-shift, -shift),
    built as the release's ``img_mask``: the padded map cut into 3 x 3
    regions by the slices (0, -window), (-window, -shift), (-shift, None) of
    each axis, and -100.0 between tokens of a window that lie in different
    regions."""
    img = torch.zeros((1, hp, wp, 1), device=device)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = partition(img, window).reshape(-1, window * window)
    mask = win[:, None, :] - win[:, :, None]
    return mask.masked_fill(mask != 0, MASK_VALUE).masked_fill(mask == 0, 0.0)


def partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, Hp, Wp, C) -> (B * windows, window, window, C), windows row-major."""
    b, hp, wp, c = x.shape
    x = x.view(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)


def reverse(windows: torch.Tensor, window: int, hp: int, wp: int) -> torch.Tensor:
    """(B * windows, window, window, C) -> (B, Hp, Wp, C)."""
    c = windows.shape[-1]
    x = windows.view(-1, hp // window, wp // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, hp, wp, c)


def _check_args(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int, shift: int):
    if qkv.dim() != 4 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv must be (B, Hp, Wp, 3C) with C a multiple of heads={heads}, "
                         f"got {tuple(qkv.shape)}")
    if qkv.shape[1] % window or qkv.shape[2] % window:
        raise ValueError(f"the map {tuple(qkv.shape[1:3])} is not padded to multiples of "
                         f"the window {window}")
    if table.shape != ((2 * window - 1) ** 2, heads):
        raise ValueError(f"the bias table must be ({(2 * window - 1) ** 2}, {heads}), "
                         f"got {tuple(table.shape)}")
    if not 0 <= shift < window:
        raise ValueError(f"shift {shift} outside [0, {window})")


def window_attention_reference(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                               window: int, shift: int) -> torch.Tensor:
    """The plain path, in the release's order and in ``qkv``'s dtype."""
    _check_args(qkv, table, heads, window, shift)
    b, hp, wp, c3 = qkv.shape
    c, n = c3 // 3, window * window
    d = c // heads
    if shift:
        qkv = torch.roll(qkv, shifts=(-shift, -shift), dims=(1, 2))
    win = partition(qkv, window).reshape(-1, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = win[0] * d ** -0.5, win[1], win[2]
    attn = q @ k.transpose(-2, -1)                                  # (B * nW, heads, N, N)
    bias = table.to(qkv.dtype)[relative_position_index(window, qkv.device).view(-1)]
    attn = attn + bias.view(n, n, heads).permute(2, 0, 1)[None]
    if shift:
        mask = shift_mask(hp, wp, window, shift, qkv.device).to(attn.dtype)
        nw = mask.shape[0]
        attn = (attn.view(b, nw, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(-1, window, window, c)
    out = reverse(out, window, hp, wp)
    if shift:
        out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
    return out


def window_attention_cuda(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                          window: int, shift: int) -> torch.Tensor:
    """Launch ``csrc/window_attention.cu``: ``qkv`` (B, Hp, Wp, 3C) bfloat16 or
    float32, contiguous, on the card; ``table`` ((2w - 1)^2, heads) float32.
    The kernel is built for a 7 x 7 window and head dim 32 (every Swin
    size). Returns (B, Hp, Wp, C) in ``qkv``'s dtype."""
    _check_args(qkv, table, heads, window, shift)
    if qkv.device.type != "cuda" or table.device != qkv.device:
        raise ValueError("window_attention_cuda takes CUDA tensors on one device")
    if qkv.dtype not in (torch.bfloat16, torch.float32) or table.dtype != torch.float32:
        raise TypeError(f"qkv must be bfloat16 or float32 and the table float32, got "
                        f"{qkv.dtype} and {table.dtype}")
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    if window != KERNEL_WINDOW or c // heads != KERNEL_HEAD_DIM:
        raise ValueError(f"the kernel takes window {KERNEL_WINDOW} and head dim "
                         f"{KERNEL_HEAD_DIM}, got {window} and {c // heads}")
    if not (qkv.is_contiguous() and table.is_contiguous()):
        raise ValueError("qkv and the table must be contiguous")
    out = torch.empty((b, hp, wp, c), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    lib = _cuda.library("window_attention")
    with torch.cuda.device(qkv.device):
        err = lib.w2t_window_attention(
            ctypes.c_void_p(qkv.data_ptr()), ctypes.c_void_p(table.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_int(b), ctypes.c_int(hp),
            ctypes.c_int(wp), ctypes.c_int(c), ctypes.c_int(heads), ctypes.c_int(shift),
            ctypes.c_int(qkv.dtype == torch.bfloat16),
            ctypes.c_void_p(_cuda.stream_handle(qkv.device)))
    _cuda.check(err, "window_attention")
    window_attention_cuda.launches += 1
    return out


window_attention_cuda.launches = 0


class _KernelWithPlainBackward(torch.autograd.Function):
    """Forward: the kernel. Backward: the plain path recomputed on the saved
    ``qkv`` and table under autograd, and its gradients (the same ones the
    plain path's own forward would have given)."""

    @staticmethod
    def forward(ctx, qkv, table, heads, window, shift):
        ctx.save_for_backward(qkv, table)
        ctx.args = (heads, window, shift)
        return window_attention_cuda(qkv.contiguous(), table.float().contiguous(), heads,
                                     window, shift)

    @staticmethod
    def backward(ctx, grad):
        qkv, table = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip((qkv, table), need)]
            out = window_attention_reference(*inputs, *ctx.args)
            wanted = [t for t, n in zip(inputs, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(grads) if n else None for n in need), None, None, None)


def window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                     shift: int) -> torch.Tensor:
    """The attention output (B, Hp, Wp, C) of ``qkv`` (B, Hp, Wp, 3C): the
    kernel for a CUDA tensor (with the plain path's gradients when one is
    wanted), the plain path for a CPU tensor."""
    b, hp, wp = qkv.shape[:3]
    count("window_attn_launches", 1)
    count("window_attn_tokens", b * hp * wp)
    if qkv.device.type == "cuda":
        return _KernelWithPlainBackward.apply(qkv, table, heads, window, shift)
    return window_attention_reference(qkv, table, heads, window, shift)
