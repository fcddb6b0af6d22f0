"""The per-snapshot CNN branch encoders and their blocks (counterpart of
``blindno/nn/cnn.py``).

PyTorch's native channel-first layout; the kernel, stride and padding schedules are the
JAX package's (``1d_FPE/Baselines.py:254-287`` and ``2d_FPE/Baselines.py:186-249`` in
the reference). An encoder's ``fc`` takes the last map flattened in the JAX package's
channel-last order (spatial, then channel), so a flax ``TorchDense`` kernel carries over
as it stands where the map does not collapse to one point (``Encoder3DDown``,
``EncoderHelm2``); its in-features come from the ``input_size`` the encoder is built for,
worked out from the conv schedule, where flax infers them at its first call.

Every encoder computes in the dtype its snapshots and weights share: the training step's
low-precision modes cast both (:mod:`blindno_torch.train.step`), BatchNorm computes in
float32 and hands that dtype on, and the output has it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from blindno_torch.nn.torch_layers import (BatchNorm1d, BatchNorm2d, BatchNorm3d, ConvTranspose,
                                           conv1d, conv2d, conv3d, leaky_relu, linear,
                                           promoted)

ENC_FPE80 = ((5, 1), (5, 0), (4, 0))           # 1-D FPE, N=80
ENC_GPE128 = ((5, 1), (5, 0), (7, 0), (4, 0))  # 1-D GPE, N=128

_CONV = {1: conv1d, 2: conv2d, 3: conv3d}
_BATCH_NORM = {1: BatchNorm1d, 2: BatchNorm2d, 3: BatchNorm3d}


class ChannelLayerNorm(nn.Module):
    """flax's ``nn.LayerNorm()`` on channel-last data (eps 1e-6, a scale and a bias per
    channel) applied to channel-first data: it normalizes over dim 1."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x, weight, bias = promoted(x, self.weight, self.bias)
        y = F.layer_norm(x.movedim(1, -1), (x.shape[1],), weight, bias, self.eps)
        return y.movedim(-1, 1)


class ConvBlock(nn.Module):
    """Conv + norm + LeakyReLU(``relu_slope``), in 1-D, 2-D (the default) or 3-D
    (``ndim``). ``norm`` is ``"bn"`` (BatchNorm, the module ``bn``), ``"ln"`` (flax's
    LayerNorm over the channels, the module ``ln``) or ``"in"`` (each sample's channel
    normalized over its spatial axes, eps 1e-5, no affine); any other value applies
    none, as in JAX."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride, padding,
                 generator: torch.Generator, ndim: int = 2, norm: str = "bn",
                 relu_slope: float = 0.2):
        super().__init__()
        self.norm, self.relu_slope = norm, relu_slope
        self.conv = _CONV[ndim](in_channels, out_channels, kernel_size, stride, padding, generator)
        if norm == "bn":
            self.bn = _BATCH_NORM[ndim](out_channels)
        elif norm == "ln":
            self.ln = ChannelLayerNorm(out_channels)

    def forward(self, x):
        x = self.conv(x)
        if self.norm == "bn":
            x = self.bn(x)
        elif self.norm == "ln":
            x = self.ln(x)
        elif self.norm == "in":
            x = F.instance_norm(x, eps=1e-5)
        return leaky_relu(x, self.relu_slope)


class ConvBlockTanh(nn.Module):
    """Conv + BatchNorm + tanh (``blindno/nn/cnn.py:50-62``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride, padding,
                 generator: torch.Generator, ndim: int = 2):
        super().__init__()
        self.conv = _CONV[ndim](in_channels, out_channels, kernel_size, stride, padding, generator)
        self.bn = _BATCH_NORM[ndim](out_channels)

    def forward(self, x):
        return torch.tanh(self.bn(self.conv(x)))


class DeconvBlock(nn.Module):
    """ConvTranspose + BatchNorm + LeakyReLU(0.2) (``blindno/nn/cnn.py:65-78``); the
    transposed convolution is :class:`~blindno_torch.nn.torch_layers.ConvTranspose`, with
    its ``output_padding`` zeros."""

    def __init__(self, in_channels: int, out_channels: int, generator: torch.Generator,
                 kernel_size=(2, 2), stride=(2, 2), output_padding=0):
        super().__init__()
        ndim = len(kernel_size)
        if isinstance(output_padding, int):
            output_padding = (output_padding,) * ndim
        self.deconv = ConvTranspose(in_channels, out_channels, kernel_size, stride,
                                    output_padding, generator)
        self.bn = _BATCH_NORM[ndim](out_channels)

    def forward(self, x):
        return leaky_relu(self.bn(self.deconv(x)), 0.2)


class ResizeBlock(nn.Module):
    """Nearest-neighbour upsampling by ``scale_factor`` on every spatial axis, then a
    3-wide conv with padding 1, BatchNorm and LeakyReLU(0.2) (``blindno/nn/cnn.py:81-93``)."""

    def __init__(self, in_channels: int, out_channels: int, generator: torch.Generator,
                 scale_factor: int = 2, ndim: int = 2):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv = _CONV[ndim](in_channels, out_channels, 3, 1, 1, generator)
        self.bn = _BATCH_NORM[ndim](out_channels)

    def forward(self, x):
        for ax in range(2, x.dim()):
            x = x.repeat_interleave(self.scale_factor, dim=ax)
        return leaky_relu(self.bn(self.conv(x)), 0.2)


def _pad_of(p, ndim):
    return (p,) * ndim if isinstance(p, int) else tuple(p)


def schedule_output_size(input_size, schedule):
    """The spatial size a conv schedule leaves: ``(n + 2p - k) // s + 1`` per axis and
    block, ``schedule`` as (in, out, kernel, stride, padding) entries. Raises
    ``ValueError`` where a block's window does not fit its input."""
    size = tuple(input_size)
    for i, (_, _, k, s, p) in enumerate(schedule):
        k, s, p = (_pad_of(a, len(size)) for a in (k, s, p))
        size = tuple((n + 2 * pp - kk) // ss + 1 for n, kk, ss, pp in zip(size, k, s, p))
        if min(size) < 1:
            raise ValueError(f"input size {tuple(input_size)}: conv block {i} (kernel {k}, "
                             f"stride {s}, padding {p}) leaves no point")
    return size


class SnapshotEncoder(nn.Module):
    """A stack of :class:`ConvBlock` s applied to every snapshot of the set, then ``fc``
    on the flattened last map: (B, L, *spatial) -> (B, L, n_out). ``input_size`` is the
    grid the encoder is built for; None where the schedule must collapse any grid it is
    given to one point (``Encoder1D`` and ``Encoder2D`` serve several)."""

    def __init__(self, schedule, input_size, n_out: int, g: torch.Generator, name: str,
                 ndim: int | None = None):
        super().__init__()
        ndim = len(input_size) if input_size is not None else ndim
        self.name, self.input_size = name, input_size
        self.blocks = nn.Sequential(*(ConvBlock(*spec, generator=g, ndim=ndim) for spec in schedule))
        points = 1 if input_size is None else math.prod(schedule_output_size(input_size, schedule))
        self.out_features = schedule[-1][1] * points
        self.fc = linear(self.out_features, n_out, g)

    def forward(self, x):
        b, l = x.shape[:2]
        h = self.blocks(x.reshape(b * l, 1, *x.shape[2:]))
        features = h.shape[1] * math.prod(h.shape[2:])
        if features != self.out_features:
            raise ValueError(
                f"{self.name} did not collapse the grid: got {features} features"
                if self.input_size is None else
                f"{self.name} built for {self.input_size} leaves {self.out_features} "
                f"features; input {tuple(x.shape[2:])} leaves {tuple(h.shape[1:])}")
        return self.fc(h.movedim(1, -1).reshape(b, l, -1))


class Encoder1D(SnapshotEncoder):
    """(B, L, N) -> (B, L, output_dim). Three stride-2 blocks of ``dims`` channels
    (JAX's ``dim1``-``dim3``: 64, 128, 256), then ``final_convs`` = ((kernel, padding),
    ...) at ``dims[2]`` channels, chosen so the grid collapses to one point:
    :data:`ENC_FPE80` for N=80, :data:`ENC_GPE128` for N=128."""

    def __init__(self, output_dim: int, final_convs=ENC_FPE80, dims=(64, 128, 256),
                 generator: torch.Generator | None = None):
        g = torch.Generator().manual_seed(0) if generator is None else generator
        d1, d2, d3 = dims
        # (in, out, kernel, stride, padding) of the blocks
        schedule = [(1, d1, 3, 2, 1), (d1, d2, 3, 2, 1), (d2, d3, 3, 2, 1)]
        schedule += [(d3, d3, k, 1, p) for k, p in final_convs]
        super().__init__(schedule, None, output_dim, g, "Encoder1D", ndim=1)


class Encoder2D(SnapshotEncoder):
    """(B, L, H, W) -> (B, L, n_out). ``final_kernel`` collapses the last map to 1x1:
    (2, 1) for 61x61 grids, (3, 2) for 80x80. ``dims`` are the blocks' five channel
    widths (JAX's ``dim1``-``dim5``)."""

    def __init__(self, n_out: int, final_kernel=(2, 1), dims=(64, 128, 256, 512, 512),
                 generator: torch.Generator | None = None):
        g = torch.Generator().manual_seed(0) if generator is None else generator
        d1, d2, d3, d4, d5 = dims
        # (in, out, kernel, stride, padding) of the ten blocks
        schedule = [
            (1, d1, (1, 7), (1, 2), (0, 3)),
            (d1, d2, (3, 3), (2, 2), (1, 1)), (d2, d2, (3, 3), (1, 1), (1, 1)),
            (d2, d3, (3, 3), (2, 2), (1, 1)), (d3, d3, (3, 3), (1, 1), (1, 1)),
            (d3, d4, (3, 3), (2, 2), (1, 1)), (d4, d4, (3, 3), (1, 1), (1, 1)),
            (d4, d5, (3, 3), (2, 2), (1, 1)), (d5, d5, (3, 3), (2, 2), (1, 1)),
            (d5, d5, tuple(final_kernel), (1, 1), (0, 0)),
        ]
        super().__init__(schedule, None, n_out, g, "Encoder2D", ndim=2)


def _schedule_3d(dims, final_kernel):
    """The ten blocks of ``Encoder3D`` and ``Encoder3DDown`` (``blindno/nn/cnn.py:170-181``)."""
    d1, d2, d3, d4, d5 = dims
    return [
        (1, d1, (1, 7, 7), (1, 2, 2), (0, 3, 3)),
        (d1, d2, 3, 2, 1), (d2, d2, 3, 1, 1), (d2, d3, 3, 2, 1), (d3, d3, 3, 1, 1),
        (d3, d4, 3, 2, 1), (d4, d4, 3, 1, 1), (d4, d5, 3, 2, 1), (d5, d5, 3, 2, 1),
        (d5, d5, final_kernel, 1, 0),
    ]


class Encoder3D(SnapshotEncoder):
    """Per-snapshot 3-D encoder (``blindno/nn/cnn.py:160-189``): (B, L, D, H, W) ->
    (B, L, n_out). Its schedule collapses 40^3 to one point; its last kernel (2, 1, 1)
    needs the depth to come down to 2 there, so D lies in 33-64."""

    def __init__(self, n_out: int, input_size=(40, 40, 40), dims=(64, 128, 256, 512, 512),
                 generator: torch.Generator | None = None):
        g = torch.Generator().manual_seed(0) if generator is None else generator
        super().__init__(_schedule_3d(dims, (2, 1, 1)), input_size, n_out, g, "Encoder3D")


class Encoder3DDown(SnapshotEncoder):
    """:class:`Encoder3D` with a (1, 1, 1) last kernel (``blindno/nn/cnn.py:234-259``):
    at 40^3 it leaves a (2, 1, 1) map, 2 x 512 features."""

    def __init__(self, n_out: int, input_size=(40, 40, 40), dims=(64, 128, 256, 512, 512),
                 generator: torch.Generator | None = None):
        g = torch.Generator().manual_seed(0) if generator is None else generator
        super().__init__(_schedule_3d(dims, (1, 1, 1)), input_size, n_out, g, "Encoder3DDown")


class EncoderHelm2(SnapshotEncoder):
    """The Helmholtz-era 2-D encoder (``blindno/nn/cnn.py:192-211``) for snapshots with
    few rows (H = 2 collapses to one row): (B, L, H, W) -> (B, L, n_out); the features
    left depend on H and W."""

    def __init__(self, n_out: int, input_size, dims=(64, 128, 512),
                 generator: torch.Generator | None = None):
        g = torch.Generator().manual_seed(0) if generator is None else generator
        d1, d2, d5 = dims
        schedule = [(1, d1, (1, 7), (1, 2), (0, 3)), (d1, d2, (1, 3), (1, 2), (0, 1)),
                    (d2, d5, (1, 3), (1, 2), (0, 1)), (d5, d5, (1, 3), (1, 2), (0, 1)),
                    (d5, d5, (2, 4), (1, 1), 0)]
        super().__init__(schedule, input_size, n_out, g, "EncoderHelm2")


class EncoderODE(SnapshotEncoder):
    """The ODE-observation encoder (``blindno/nn/cnn.py:214-231``): three stride-2 1-D
    blocks, a 3-wide and a 2-wide one; (B, L, n) -> (B, L, output_dim). Its 11
    observations collapse to one point."""

    def __init__(self, output_dim: int, input_size: int = 11, dims=(64, 128, 256),
                 generator: torch.Generator | None = None):
        g = torch.Generator().manual_seed(0) if generator is None else generator
        d1, d2, d3 = dims
        schedule = [(1, d1, 3, 2, 1), (d1, d2, 3, 2, 1), (d2, d3, 3, 2, 1),
                    (d3, d3, 3, 1, 1), (d3, d3, 2, 1, 0)]
        super().__init__(schedule, (input_size,), output_dim, g, "EncoderODE")
