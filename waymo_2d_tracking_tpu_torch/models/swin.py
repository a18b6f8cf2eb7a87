"""Swin Transformer backbone (Liu et al., "Swin Transformer: Hierarchical
Vision Transformer using Shifted Windows", ICCV 2021, arXiv:2103.14030), in
the form of its released detection backbone
(github.com/SwinTransformer/Swin-Transformer-Object-Detection,
``mmdet/models/backbones/swin_transformer.py``), for inference: drop path
is the identity, no absolute position embedding, patch norm on.

Op for op as the release: ``PatchEmbed`` pads the image right and bottom to
a multiple of the patch, a patch x patch stride-patch conv, then LayerNorm.
Each block is pre-norm: ``norm1``, zero padding right and bottom to
multiples of the window, on odd blocks a cyclic shift by -window // 2 with
the release's region mask (-100.0 between tokens that the shift brought
together), windowed multi-head attention with the learned relative-position
bias, the reverse shift, the crop and the residual; then ``norm2``, an MLP
(Linear 4C, exact-erf GELU, Linear C) and the residual. ``PatchMerging``
pads to even, concatenates the 2x2 neighbours in the release's order
(x0, x1, x2, x3), LayerNorm(4C) and a Linear 4C -> 2C with no bias. Each
output stage has its own LayerNorm. Parameter names are the release's.

The attention runs through ``ops/window_attention.py``: the qkv projection
is a per-token GEMM on the padded, unshifted map, and the shift, the window
partition, the bias, the mask, the softmax and the reverse are the op's
(on the card the kernel ``csrc/window_attention.cu``).

Tokens are kept NHWC, (B, H, W, C); the outputs are the stage features
{2: /4, 3: /8, 4: /16, 5: /32} NCHW, as ``models/resnet.py`` returns them.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from waymo_2d_tracking_tpu_torch.ops.window_attention import window_attention

LN_EPS = 1e-5
BIAS_TABLE = "relative_position_bias_table"   # the parameter Detector.init_weights draws
BIAS_TABLE_STD = 0.02                          # the release's trunc_normal_(std=.02)


def _pad_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """(B, H, W, C) zero-padded right and bottom to multiples of ``multiple``."""
    h, w = x.shape[1:3]
    ph, pw = (-h) % multiple, (-w) % multiple
    return F.pad(x, (0, 0, 0, pw, 0, ph)) if ph or pw else x


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, dim, patch, patch)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = _pad_to(x_nhwc, self.patch).permute(0, 3, 1, 2)
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class WindowAttention(nn.Module):
    """W-MSA / SW-MSA on a padded (B, Hp, Wp, C) map."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        y = window_attention(self.qkv(x), self.relative_position_bias_table, self.heads,
                             self.window, shift)
        return self.proj(y)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        y = self.attn(_pad_to(self.norm1(x), self.window), self.shift)
        x = x + y[:, :h, :w]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pad_to(x, 2)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    """The release's ``BasicLayer``: its blocks, shift 0 then window // 2 in
    turn, and the patch merging that follows all but the last stage."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float,
                 merge: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, 0 if i % 2 == 0 else window // 2, mlp_ratio)
            for i in range(depth))
        self.downsample = PatchMerging(dim) if merge else None


class SwinTransformer(nn.Module):
    """Stage outputs {2: /4, 3: /8, 4: /16, 5: /32} NCHW, each through its own
    LayerNorm (``norm0`` .. ``norm3``).

    The constructor takes the ResNet constructors' keyword arguments: ``stem``
    is not used (the stem is the patch embedding); ``quant`` other than
    ``"off"`` raises, since there is no int8 Swin; ``dtype`` is not used
    (it types the int8 convs of a ResNet); ``remat`` (training only)
    recomputes each block in the backward pass, as ResNet's residual
    blocks are."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 heads: Sequence[int] = (3, 6, 12, 24), window: int = 7, patch: int = 4,
                 mlp_ratio: float = 4.0, stem: str = "s2d", quant: str = "off",
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        if quant != "off":
            raise ValueError(f"the Swin backbone has no int8 form (quant={quant!r})")
        self.remat = remat
        self.patch_embed = PatchEmbed(patch, embed_dim)
        self.layers = nn.ModuleList()
        self.out_channels: Dict[int, int] = {}
        for i, (depth, h) in enumerate(zip(depths, heads)):
            dim = embed_dim * 2 ** i
            self.layers.append(SwinStage(dim, depth, h, window, mlp_ratio,
                                         merge=i < len(depths) - 1))
            self.add_module(f"norm{i}", nn.LayerNorm(dim, eps=LN_EPS))
            self.out_channels[i + 2] = dim

    def forward(self, x_nhwc: torch.Tensor) -> Dict[int, torch.Tensor]:
        x = self.patch_embed(x_nhwc)
        feats: Dict[int, torch.Tensor] = {}
        for i, stage in enumerate(self.layers):
            for block in stage.blocks:
                if self.remat and self.training and torch.is_grad_enabled():
                    x = checkpoint(block, x, use_reentrant=False)
                else:
                    x = block(x)
            feats[i + 2] = getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return feats


def SwinT(**kw) -> SwinTransformer:
    """Swin-T: patch 4, embed 96, depths 2/2/6/2, heads 3/6/12/24 (head dim
    32), window 7, MLP ratio 4."""
    return SwinTransformer(embed_dim=96, depths=(2, 2, 6, 2), heads=(3, 6, 12, 24), **kw)
