"""The per-snapshot CNN branch encoders (counterpart of ``blindno/nn/cnn.py``).

PyTorch's native channel-first layout; the kernel, stride and padding schedules are the
JAX package's (``1d_FPE/Baselines.py:254-287`` and ``2d_FPE/Baselines.py:186-249`` in
the reference).
"""
from __future__ import annotations

import torch
from torch import nn

from blindno_torch.nn.torch_layers import (BatchNorm1d, BatchNorm2d, conv1d, conv2d,
                                           leaky_relu, linear)

ENC_FPE80 = ((5, 1), (5, 0), (4, 0))           # 1-D FPE, N=80
ENC_GPE128 = ((5, 1), (5, 0), (7, 0), (4, 0))  # 1-D GPE, N=128


class ConvBlock(nn.Module):
    """Conv + BatchNorm + LeakyReLU(0.2), in 1-D (``ndim=1``) or 2-D."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride, padding,
                 generator: torch.Generator, ndim: int = 2):
        super().__init__()
        conv, bn = (conv1d, BatchNorm1d) if ndim == 1 else (conv2d, BatchNorm2d)
        self.conv = conv(in_channels, out_channels, kernel_size, stride, padding, generator)
        self.bn = bn(out_channels)

    def forward(self, x):
        return leaky_relu(self.bn(self.conv(x)), 0.2)


class Encoder1D(nn.Module):
    """(B, L, N) -> (B, L, output_dim). Three stride-2 blocks (64, 128, 256 channels),
    then ``final_convs`` = ((kernel, padding), ...) at 256 channels, chosen so the grid
    collapses to one point: :data:`ENC_FPE80` for N=80, :data:`ENC_GPE128` for N=128."""

    def __init__(self, output_dim: int, final_convs=ENC_FPE80,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        d1, d2, d3 = 64, 128, 256
        # (in, out, kernel, stride, padding) of the blocks
        schedule = [(1, d1, 3, 2, 1), (d1, d2, 3, 2, 1), (d2, d3, 3, 2, 1)]
        schedule += [(d3, d3, k, 1, p) for k, p in final_convs]
        self.blocks = nn.Sequential(*(ConvBlock(*spec, generator=g, ndim=1) for spec in schedule))
        self.out_features = d3
        self.fc = linear(d3, output_dim, g)

    def forward(self, x):
        b, l, n = x.shape
        h = self.blocks(x.reshape(b * l, 1, n)).reshape(b, l, -1)
        if h.shape[-1] != self.out_features:
            raise ValueError(f"Encoder1D did not collapse the grid: got {h.shape[-1]} features")
        return self.fc(h)


class Encoder2D(nn.Module):
    """(B, L, H, W) -> (B, L, n_out). ``final_kernel`` collapses the last map to 1x1:
    (2, 1) for 61x61 grids, (3, 2) for 80x80.

    It computes in the snapshots' dtype. bfloat16 snapshots (the training step's
    ``encoder_bn32`` mode) run the convs and ``fc`` in bfloat16 under ``torch.autocast``
    scoped to this module, with the weights kept in float32; BatchNorm computes in
    float32 and hands bfloat16 on. The output is then bfloat16.
    """

    def __init__(self, n_out: int, final_kernel=(2, 1), generator: torch.Generator | None = None):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        d1, d2, d3, d4, d5 = 64, 128, 256, 512, 512
        # (in, out, kernel, stride, padding) of the ten blocks
        schedule = [
            (1, d1, (1, 7), (1, 2), (0, 3)),
            (d1, d2, (3, 3), (2, 2), (1, 1)), (d2, d2, (3, 3), (1, 1), (1, 1)),
            (d2, d3, (3, 3), (2, 2), (1, 1)), (d3, d3, (3, 3), (1, 1), (1, 1)),
            (d3, d4, (3, 3), (2, 2), (1, 1)), (d4, d4, (3, 3), (1, 1), (1, 1)),
            (d4, d5, (3, 3), (2, 2), (1, 1)), (d5, d5, (3, 3), (2, 2), (1, 1)),
            (d5, d5, tuple(final_kernel), (1, 1), (0, 0)),
        ]
        self.blocks = nn.Sequential(*(ConvBlock(*spec, generator=g) for spec in schedule))
        self.out_features = d5
        self.fc = linear(d5, n_out, g)

    def forward(self, x):
        b, l, hh, ww = x.shape
        with torch.autocast(x.device.type, torch.bfloat16, enabled=x.dtype == torch.bfloat16):
            h = self.blocks(x.reshape(b * l, 1, hh, ww)).reshape(b, l, -1)
            if h.shape[-1] != self.out_features:
                raise ValueError(f"Encoder2D did not collapse the grid: got {h.shape[-1]} features")
            return self.fc(h)
