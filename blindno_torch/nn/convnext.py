"""ConvNeXt and plain conv blocks in 1-D or 2-D, channel-first (counterpart of
``blindno/nn/convnext.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from blindno_torch.nn.torch_layers import (BatchNorm1d, BatchNorm2d, LayerNorm, conv1d, conv2d,
                                           gelu, linear)


class ConvNeXtBlock(nn.Module):
    """Depthwise conv (k=7, p=3, groups=dim) -> LayerNorm over the channels (eps 1e-6)
    -> Linear(4·dim) -> exact gelu -> Linear(dim) -> residual; input (B, dim, *spatial).

    At ``dim = 1`` the LayerNorm of a single channel returns its bias exactly, so the
    depthwise conv and the LayerNorm's scale get exactly zero gradients there, as in JAX
    (:class:`~blindno_torch.nn.torch_layers.LayerNorm`).
    """

    def __init__(self, dim: int, ndim: int, generator: torch.Generator):
        super().__init__()
        conv = conv1d if ndim == 1 else conv2d
        self.dwconv = conv(dim, dim, 7, 1, 3, generator, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = linear(dim, 4 * dim, generator)
        self.pwconv2 = linear(4 * dim, dim, generator)

    def forward(self, x):
        h = self.norm(self.dwconv(x).movedim(1, -1))
        h = self.pwconv2(gelu(self.pwconv1(h)))
        return h.movedim(-1, 1) + x


class PlainConvBlock(nn.Module):
    """Conv3 (p=1) -> BatchNorm (flax's running variance in train mode) -> ReLU; input
    (B, dim, *spatial)."""

    def __init__(self, dim: int, ndim: int, generator: torch.Generator):
        super().__init__()
        conv, bn = (conv1d, BatchNorm1d) if ndim == 1 else (conv2d, BatchNorm2d)
        self.conv = conv(dim, dim, 3, 1, 1, generator)
        self.bn = bn(dim)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))
