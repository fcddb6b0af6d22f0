"""The 1-D, 2-D and 3-D Fourier Neural Operators (counterpart of ``blindno/nn/fno.py``).

lift -> n x (spectral conv + 1x1 conv, gelu between layers) -> project, with the domain
padded by ``padding_frac`` (1/4, JAX's default) at the far end of each axis. Each layer runs through the CUDA kernel ``fno1d_layer_cuda`` or
``fno2d_layer_cuda``; ``SpectralConv1d`` and ``SpectralConv2d`` called on their own run
``spectral_conv1d_cuda`` and ``spectral_conv2d_cuda``. On a CPU tensor all take the
kernels' plain versions. Both train: where autograd needs a gradient, each layer runs
the kernel without its gelu epilogue inside ``FNO1dLinear`` or ``FNO2dLinear`` and gelu
after it; under ``no_grad`` or ``inference_mode`` the kernel applies gelu itself.

``tp_group`` is None but in tensor-parallel training, where
:func:`blindno_torch.parallel.tp.shard_fno_layers` has cut every layer to this rank's
out-channel slice: each layer then runs its kernel on the slice, ``(Cin, Cout/tp)``, and
the slices are gathered (:func:`~blindno_torch.parallel.tp.column_parallel`).

:class:`FNO3d` has no layer kernel: the JAX package computes its layers with the einsum
chain outside any Pallas kernel (``blindno/nn/fno.py:84``), and the port with
:func:`~blindno_torch.ops.spectral.spectral_conv3d`, on every device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from blindno_torch.nn.torch_layers import gelu, linear, promoted
from blindno_torch.parallel.tp import column_parallel
from blindno_torch.ops.spectral import spectral_conv3d
from blindno_torch.ops.spectral_cuda import (fno1d_layer_cuda, fno2d_layer_cuda,
                                             spectral_conv1d_cuda, spectral_conv2d_cuda)
from blindno_torch.utils import torch_init as tinit


class SpectralConv1d(nn.Module):
    """Mode-truncated 1-D Fourier layer; weights (Cin, Cout, modes) as real and imaginary
    planes, initialised ``U[0, 1) / (Cin * Cout)``. ``dc_half`` halves the DC
    coefficient before the mix, the reference's 1-D quirk (on by default, as in JAX)."""

    def __init__(self, in_channels: int, out_channels: int, modes: int,
                 generator: torch.Generator, dc_half: bool = True):
        super().__init__()
        shape = (in_channels, out_channels, modes)
        scale = 1.0 / (in_channels * out_channels)
        self.dc_half = dc_half
        self.weights_re = nn.Parameter(tinit.spectral_uniform_(torch.empty(shape), scale, generator))
        self.weights_im = nn.Parameter(tinit.spectral_uniform_(torch.empty(shape), scale, generator))

    def forward(self, x):
        return spectral_conv1d_cuda(x, self.weights_re, self.weights_im, self.dc_half)


class SpectralConv2d(nn.Module):
    """2-D Fourier layer with +/- row blocks; weights (Cin, Cout, 2*m1, m2) as real and
    imaginary planes, initialised ``U[0, 1) / (Cin * Cout)``."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int, modes2: int,
                 generator: torch.Generator):
        super().__init__()
        shape = (in_channels, out_channels, 2 * modes1, modes2)
        scale = 1.0 / (in_channels * out_channels)
        self.weights_re = nn.Parameter(tinit.spectral_uniform_(torch.empty(shape), scale, generator))
        self.weights_im = nn.Parameter(tinit.spectral_uniform_(torch.empty(shape), scale, generator))

    def forward(self, x):
        return spectral_conv2d_cuda(x, self.weights_re, self.weights_im)


class SpectralConv3d(nn.Module):
    """3-D Fourier layer with four +/- corner blocks; weights (Cin, Cout, 2*m1, 2*m2, m3)
    as real and imaginary planes, initialised ``U[0, 1) / (Cin * Cout)``."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int, modes2: int,
                 modes3: int, generator: torch.Generator):
        super().__init__()
        shape = (in_channels, out_channels, 2 * modes1, 2 * modes2, modes3)
        scale = 1.0 / (in_channels * out_channels)
        self.weights_re = nn.Parameter(tinit.spectral_uniform_(torch.empty(shape), scale, generator))
        self.weights_im = nn.Parameter(tinit.spectral_uniform_(torch.empty(shape), scale, generator))

    def forward(self, x):
        return spectral_conv3d(*promoted(x, self.weights_re, self.weights_im))


class PointwiseConv(nn.Module):
    """The parameters of a layer's 1x1 convolution: ``weight`` (Cout, Cin) and ``bias``,
    torch Conv init. The layer kernels apply them inside the layer; :class:`FNO3d` calls
    the module."""

    def __init__(self, in_channels: int, out_channels: int, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels))
        self.bias = nn.Parameter(torch.empty(out_channels))
        tinit.torch_default_(self, in_channels, generator)

    def forward(self, x):
        """The 1x1 convolution on channel-first x (B, Cin, *spatial)."""
        x, weight = promoted(x, self.weight)
        y = torch.einsum("bc...,oc->bo...", x, weight)
        return y + self.bias.reshape((1, -1) + (1,) * (x.dim() - 2))


class FNO1d(nn.Module):
    """(B, N, input_dim) -> (B, N, output_dim)."""

    tp_group = None  # the ``model`` process group once its layers are sharded

    def __init__(self, modes: int, width: int, n_layers: int, input_dim: int,
                 output_dim: int = 1, generator: torch.Generator | None = None,
                 padding_frac: float = 0.25):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.padding_frac = padding_frac
        self.fc0 = linear(input_dim, width, g)
        self.spectral = nn.ModuleList(
            SpectralConv1d(width, width, modes, g) for _ in range(n_layers))
        self.pointwise = nn.ModuleList(PointwiseConv(width, width, g) for _ in range(n_layers))
        self.fc1 = linear(width, 128, g)
        self.fc2 = linear(128, output_dim, g)

    def lift(self, x):
        """(B, N, input_dim) -> the first layer's input (B, width, N + pad), pad =
        round(N · padding_frac)."""
        x = self.fc0(x).permute(0, 2, 1)
        return F.pad(x, (0, int(round(x.shape[-1] * self.padding_frac)))).contiguous()

    def forward(self, x):
        n = x.shape[1]
        x = self.lift(x)
        last = len(self.spectral) - 1
        for k, (sc, pc) in enumerate(zip(self.spectral, self.pointwise)):
            if self.tp_group is not None:
                x = column_parallel(fno1d_layer_cuda, x, self.tp_group, sc.weights_re,
                                    sc.weights_im, pc.weight.t(), pc.bias, dc_half=sc.dc_half,
                                    apply_act=k != last)
                continue
            x = fno1d_layer_cuda(x, sc.weights_re, sc.weights_im, pc.weight.t(), pc.bias,
                                 dc_half=sc.dc_half, apply_act=k != last)
        x = x[..., :n].permute(0, 2, 1)
        return self.fc2(gelu(self.fc1(x)))


class FNO2d(nn.Module):
    """(B, H, W, input_dim) -> (B, H, W, output_dim)."""

    tp_group = None  # the ``model`` process group once its layers are sharded

    def __init__(self, modes: int, width: int, n_layers: int, input_dim: int,
                 output_dim: int = 1, generator: torch.Generator | None = None,
                 padding_frac: float = 0.25):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.padding_frac = padding_frac
        self.fc0 = linear(input_dim, width, g)
        self.spectral = nn.ModuleList(
            SpectralConv2d(width, width, modes, modes, g) for _ in range(n_layers))
        self.pointwise = nn.ModuleList(PointwiseConv(width, width, g) for _ in range(n_layers))
        self.fc1 = linear(width, 128, g)
        self.fc2 = linear(128, output_dim, g)

    def lift(self, x):
        """(B, H, W, input_dim) -> the first layer's input (B, width, H + pad_h, W +
        pad_w), each pad round(size · padding_frac)."""
        x = self.fc0(x).permute(0, 3, 1, 2)
        h, w = x.shape[-2:]
        f = self.padding_frac
        return F.pad(x, (0, int(round(w * f)), 0, int(round(h * f)))).contiguous()

    def forward(self, x):
        h, w = x.shape[1:3]
        x = self.lift(x)
        last = len(self.spectral) - 1
        for k, (sc, pc) in enumerate(zip(self.spectral, self.pointwise)):
            if self.tp_group is not None:
                x = column_parallel(fno2d_layer_cuda, x, self.tp_group, sc.weights_re,
                                    sc.weights_im, pc.weight.t(), pc.bias, apply_act=k != last)
                continue
            x = fno2d_layer_cuda(x, sc.weights_re, sc.weights_im, pc.weight.t(), pc.bias,
                                 apply_act=k != last)
        x = x[..., :h, :w].permute(0, 2, 3, 1)
        return self.fc2(gelu(self.fc1(x)))


class FNO3d(nn.Module):
    """(B, D1, D2, D3, input_dim) -> (B, D1, D2, D3, output_dim): exactly 4 layers, the
    grid padded by ``padding`` points at the far end of each axis, no gelu after the last
    layer, and a projection through 128 features (``blindno/nn/fno.py:184-211``)."""

    def __init__(self, modes: int, width: int, input_dim: int, output_dim: int,
                 padding: int = 2, generator: torch.Generator | None = None):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.padding = padding
        self.fc0 = linear(input_dim, width, g)
        self.spectral = nn.ModuleList(
            SpectralConv3d(width, width, modes, modes, modes, g) for _ in range(4))
        self.pointwise = nn.ModuleList(PointwiseConv(width, width, g) for _ in range(4))
        self.fc1 = linear(width, 128, g)
        self.fc2 = linear(128, output_dim, g)

    def forward(self, x):
        d1, d2, d3 = x.shape[1:4]
        p = self.padding
        x = F.pad(self.fc0(x).permute(0, 4, 1, 2, 3), (0, p, 0, p, 0, p))
        for k, (sc, pc) in enumerate(zip(self.spectral, self.pointwise)):
            x = sc(x) + pc(x)
            if k != 3:
                x = gelu(x)
        x = x[..., :d1, :d2, :d3].permute(0, 2, 3, 4, 1)
        return self.fc2(gelu(self.fc1(x)))
