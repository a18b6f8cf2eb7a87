"""Post-training w8a8 int8 quantization of the conv trunk, for inference
(counterpart of ``models/quant.py``).

The scheme is the JAX package's:
- weights: symmetric, per output channel, ``max|W|`` over (kh, kw, cin)
  floored at 1e-8, over 127, quantized from the float weights at every call;
- activations: symmetric, per tensor, from a calibrated ``act_absmax`` (a
  zero absmax becomes 1.0);
- the int8 x int8 product sums in int32, is multiplied by ``wscale *
  ascale`` (that product first), the bias is added in float32 and the result
  is cast to the config's dtype.

``QuantConv2d`` is an ``nn.Conv2d`` (same ``weight`` / ``bias``, so float
state dicts load unchanged) with a float32 buffer ``act_absmax`` and a
``mode``: ``'off'`` the plain conv, ``'calib'`` the plain conv plus a running
``max|x|`` of its input in the config's dtype, ``'int8'`` the quantized conv.
A tower shared across pyramid levels records one absmax over all of them.

The int8 product is the JAX package's ``lax.conv_general_dilated(int8, int8,
preferred_element_type=int32)``, which XLA computes outside any Pallas
kernel. Here it is an im2col of the int8 codes (NHWC, K ordered (kh, kw,
cin) as the flax HWIO kernel) and ``torch._int_mm`` (cuBLASLt's int8 GEMM on
the card, exact int32 on the CPU). The sums are exact: a float conv is not
(127^2 x 4608 exceeds 2^24). ``_int_mm`` on the card takes M > 16 and K, N
multiples of 8, so ``int8_gemm`` pads with zero rows and columns, which
changes no sum.

Rounding follows the JAX module's source order, which is what JAX computes
op by op: ``a / 127`` and ``max / 127`` are true divisions, ``wscale *
ascale`` is rounded before it scales the sums, and the bias is a separate
add. Every division is by a tensor on the input's device: on the card a
division by a Python scalar (or a CPU scalar tensor) is a reciprocal
multiply. ``round`` is half to even in both packages. (Inside ``jit`` XLA
rewrites some of this: it folds ``/ 127.0`` into a multiply by float32(1/127),
reassociates the scalar products, depending on the shapes, and contracts the
multiply and bias add into an FMA; each moves an output by an ulp or two.)
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

MODES = ("off", "calib", "int8")
QMAX = 127.0


def quantize_symmetric(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Float -> int8 codes: round(x / scale) half to even, clipped to
    [-127, 127]. ``scale`` is a tensor on ``x``'s device."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def gemm_pads(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """(M, K, N) padded as ``_int_mm`` on the card takes them: M > 16, K and
    N multiples of 8."""
    return max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8


def int8_gemm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ w (N, K) int8 transposed -> (M, N) int32, exact.
    Zero rows / columns pad the operands to ``gemm_pads``; the product goes
    to ``torch._int_mm`` with B column-major (``w.t()``). Counted in
    ``int8_gemm.launches``."""
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = gemm_pads(m, k, n)
    if kp != k:
        a = F.pad(a, (0, kp - k))
        w = F.pad(w, (0, kp - k))
    if mp != m:
        a = F.pad(a, (0, 0, 0, mp - m))
    if np_ != n:
        w = F.pad(w, (0, 0, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    int8_gemm.launches += 1
    return out[:m, :n]


int8_gemm.launches = 0


def im2col_nhwc(q: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int],
                padding: Tuple[int, int]) -> Tuple[torch.Tensor, int, int]:
    """(N, H, W, C) codes -> ((N * Ho * Wo, kh * kw * C) patches, Ho, Wo):
    symmetric zero padding, then strided windows, K ordered (kh, kw, C). A
    gather of views and one copy, for any dtype."""
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    if ph or pw:
        q = F.pad(q, (0, 0, pw, pw, ph, ph))
    win = q.unfold(1, kh, sh).unfold(2, kw, sw)          # (N, Ho, Wo, C, kh, kw)
    n, ho, wo = win.shape[:3]
    return win.permute(0, 1, 2, 4, 5, 3).reshape(n * ho * wo, -1), ho, wo


class QuantConv2d(nn.Conv2d):
    """``nn.Conv2d`` with the three modes of the JAX ``QuantConv``.

    ``dtype`` is the config's compute dtype: ``calib`` records the absmax of
    the input cast to it (what the flax conv sees), ``int8`` quantizes that
    and casts its result to it."""

    def __init__(self, *args, mode: str = "int8", dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if mode not in MODES:
            raise ValueError(f"quant mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.compute_dtype = dtype
        self.register_buffer("act_absmax", torch.zeros((), dtype=torch.float32))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a float checkpoint has no act_absmax: keep this module's own
        state_dict.setdefault(prefix + "act_absmax", self.act_absmax.detach().clone())
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "int8":
            with torch.autocast(device_type=x.device.type, enabled=False):
                return self._int8_forward(x)
        if self.mode == "calib":
            seen = x.detach().to(self.compute_dtype).float().abs().amax()
            self.act_absmax.copy_(torch.maximum(self.act_absmax, seen))
        return super().forward(x)

    def _int8_forward(self, x: torch.Tensor) -> torch.Tensor:
        qmax = self.act_absmax.new_full((), QMAX)            # a divisor on the device
        a = torch.where(self.act_absmax > 0, self.act_absmax, torch.ones_like(self.act_absmax))
        ascale = a / qmax
        k = self.weight.float()
        wscale = torch.clamp(k.abs().amax(dim=(1, 2, 3)), min=1e-8) / qmax   # (O,)
        xq = quantize_symmetric(x.permute(0, 2, 3, 1).to(self.compute_dtype).float(), ascale)
        wq = quantize_symmetric(k, wscale[:, None, None, None])
        cols, ho, wo = im2col_nhwc(xq, self.kernel_size, self.stride, self.padding)
        acc = int8_gemm(cols, wq.permute(0, 2, 3, 1).reshape(wq.shape[0], -1))
        y = acc.float() * (wscale * ascale)
        if self.bias is not None:
            y = y + self.bias.float()
        y = y.to(self.compute_dtype).reshape(x.shape[0], ho, wo, -1)
        return y.permute(0, 3, 1, 2)


def make_conv(quant: str, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
              padding: int = 0, bias: bool = True,
              dtype: torch.dtype = torch.float32) -> nn.Conv2d:
    """The conv factory of the backbone, FPN, towers and ReID: ``'off'`` is a
    plain ``nn.Conv2d`` (the float path untouched), ``'calib'`` / ``'int8'``
    a ``QuantConv2d`` in that mode."""
    if quant == "off":
        return nn.Conv2d(in_ch, out_ch, kernel_size, stride, padding=padding, bias=bias)
    if quant not in MODES:
        raise ValueError(f"quant mode must be one of {MODES}, got {quant!r}")
    return QuantConv2d(in_ch, out_ch, kernel_size, stride, padding=padding, bias=bias,
                       mode=quant, dtype=dtype)


def named_quant_convs(module: nn.Module) -> Iterator[Tuple[str, QuantConv2d]]:
    return ((n, m) for n, m in module.named_modules() if isinstance(m, QuantConv2d))


def quant_convs(module: nn.Module) -> Iterator[QuantConv2d]:
    return (m for _, m in named_quant_convs(module))


def is_calibrated(module: nn.Module) -> bool:
    """True if ``module`` has quantized convs and every ``act_absmax`` is > 0
    (one host read of the buffers)."""
    absmax = [m.act_absmax for m in quant_convs(module)]
    return bool(absmax) and bool((torch.stack(absmax) > 0).all())


@contextlib.contextmanager
def quant_mode(module: nn.Module, mode: Optional[str]):
    """Every ``QuantConv2d`` of ``module`` in ``mode`` for the block, then back."""
    convs = list(quant_convs(module))
    saved = [m.mode for m in convs]
    if mode is not None:
        for m in convs:
            m.mode = mode
    try:
        yield
    finally:
        for m, s in zip(convs, saved):
            m.mode = s
