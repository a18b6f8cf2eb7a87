"""ResNet backbones (counterpart of ``models/resnet.py``).

Convolutions run NCHW inside (on the card the NHWC input, permuted, is
channels-last in memory, which is what cuDNN wants); the detector converts at
its boundary. Padding is explicit, as in the JAX modules, so weights map one
to one. Submodule names follow the flax names (``stem_conv``, ``stem_bn``,
``stage{s}_block{b}``, ``conv1``, ``bn1``, ``downsample_conv``...), which is
what ``weights.from_flax_numpy`` relies on.

Every conv comes from ``models/quant.py make_conv``: ``quant='off'`` is a
plain ``nn.Conv2d``, ``'calib'`` / ``'int8'`` the w8a8 ``QuantConv2d``
(``dtype``: the config's compute dtype).

Training (``train/train.py``) runs the modules in train mode: ``BatchNorm2d``
is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` there, and
``remat=True`` recomputes each residual block in the backward pass (flax's
per-block ``nn.remat``) with ``torch.utils.checkpoint``.

Returns the C2..C5 features {2: /4, 3: /8, 4: /16, 5: /32}, NCHW.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from waymo_2d_tracking_tpu_torch.models.quant import make_conv

BN_MOMENTUM = 0.9     # flax's decay of the running statistics
BN_EPS = 1e-5

_REMAT = threading.local()   # .recomputing: inside a remat block's recompute


@contextlib.contextmanager
def _recomputing():
    prev = getattr(_REMAT, "recomputing", False)
    _REMAT.recomputing = True
    try:
        yield
    finally:
        _REMAT.recomputing = prev


def _remat_contexts():
    """``checkpoint``'s ``context_fn``: nothing around the forward, the
    recompute flagged (in the thread that runs it) so that BatchNorm does not
    update its running statistics a second time."""
    return contextlib.nullcontext(), _recomputing()


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's train-mode semantics; eval mode is
    ``nn.BatchNorm2d``'s, unchanged.

    In train mode the statistics are computed in float32 whatever the input
    dtype (flax promotes them), the variance is the biased one, as
    E[x^2] - E[x]^2 clipped at 0 (flax's fast variance), the output is
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32 cast back
    to the input dtype, and the running statistics become
    ``0.9 * running + 0.1 * batch`` (flax's momentum is torch's 1 - momentum,
    and torch would fold in the unbiased variance). Under remat the
    recompute leaves them alone."""

    def __init__(self, c: int):
        super().__init__(c, eps=BN_EPS)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        if not getattr(_REMAT, "recomputing", False):
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(mean.detach() * (1.0 - BN_MOMENTUM))
                self.running_var.mul_(BN_MOMENTUM).add_(var.detach() * (1.0 - BN_MOMENTUM))
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype)


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with BN and projection shortcut."""

    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1, quant: str = "off",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = features * 4
        conv = lambda *a, **kw: make_conv(quant, *a, bias=False, dtype=dtype, **kw)  # noqa: E731
        self.conv1 = conv(in_ch, features, 1)
        self.bn1 = _bn(features)
        self.conv2 = conv(features, features, 3, stride, padding=1)
        self.bn2 = _bn(features)
        self.conv3 = conv(features, out, 1)
        self.bn3 = _bn(out)
        if in_ch != out or stride != 1:
            self.downsample_conv = conv(in_ch, out, 1, stride)
            self.downsample_bn = _bn(out)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 basic residual block (ResNet-18/34 family)."""

    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1, quant: str = "off",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = lambda *a, **kw: make_conv(quant, *a, bias=False, dtype=dtype, **kw)  # noqa: E731
        self.conv1 = conv(in_ch, features, 3, stride, padding=1)
        self.bn1 = _bn(features)
        self.conv2 = conv(features, features, 3, 1, padding=1)
        self.bn2 = _bn(features)
        if in_ch != features or stride != 1:
            self.downsample_conv = conv(in_ch, features, 1, stride)
            self.downsample_bn = _bn(features)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


def space_to_depth_2x2(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C), channel order (2a+b)*C + c for
    pixel offsets (a, b) in the 2x2 patch."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


class ResNet(nn.Module):
    """ResNet-v1. block='bottleneck' (50/101) or 'basic' (18/34).

    stem='conv7' is the 7x7/s2 stem; stem='s2d' is the weight-equivalent
    space-to-depth 4x4/s1 form, padded (2, 1) on both axes like the JAX
    module (asymmetric, so the pad is explicit and the conv has none).
    ``remat`` (training only): each residual block is recomputed in the
    backward pass instead of keeping its activations.
    """

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 block: str = "bottleneck", stem: str = "conv7", quant: str = "off",
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.stem = stem
        self.remat = remat
        if stem == "s2d":
            self.stem_conv = make_conv(quant, 12, width, 4, 1, bias=False, dtype=dtype)
        else:
            self.stem_conv = make_conv(quant, 3, width, 7, 2, padding=3, bias=False, dtype=dtype)
        self.stem_bn = _bn(width)
        block_cls = Bottleneck if block == "bottleneck" else BasicBlock
        self.stage_names = []
        self.out_channels: Dict[int, int] = {}
        in_ch = width
        for stage, num_blocks in enumerate(stage_sizes):
            features = width * (2 ** stage)
            names = []
            for b in range(num_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                name = f"stage{stage + 1}_block{b}"
                self.add_module(name, block_cls(in_ch, features, stride, quant, dtype))
                in_ch = features * block_cls.expansion
                names.append(name)
            self.stage_names.append(names)
            self.out_channels[stage + 2] = in_ch

    def forward(self, x_nhwc: torch.Tensor) -> Dict[int, torch.Tensor]:
        if self.stem == "s2d":
            x = space_to_depth_2x2(x_nhwc).permute(0, 3, 1, 2)
            x = self.stem_conv(F.pad(x, (2, 1, 2, 1)))
        else:
            x = self.stem_conv(x_nhwc.permute(0, 3, 1, 2))
        x = F.relu(self.stem_bn(x))
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats: Dict[int, torch.Tensor] = {}
        for stage, names in enumerate(self.stage_names):
            for name in names:
                block = getattr(self, name)
                if self.remat and self.training and torch.is_grad_enabled():
                    x = checkpoint(block, x, use_reentrant=False, context_fn=_remat_contexts)
                else:
                    x = block(x)
            feats[stage + 2] = x
        return feats


def ResNet18(stem: str = "conv7", **kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), width=64, block="basic", stem=stem, **kw)


def ResNet34(stem: str = "conv7", **kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), width=64, block="basic", stem=stem, **kw)


def ResNet50(stem: str = "conv7", **kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), width=64, stem=stem, **kw)


def ResNet101(stem: str = "conv7", **kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), width=64, stem=stem, **kw)


def ResNet18Slim(stem: str = "conv7", **kw) -> ResNet:
    """Small twin for tests (1-block bottleneck stages, width 16)."""
    return ResNet(stage_sizes=(1, 1, 1, 1), width=16, stem=stem, **kw)
