"""Activations and layer builders with the JAX package's torch semantics
(counterpart of ``blindno/nn/torch_layers.py``).

Builders draw their initial weights from an explicit generator; ``skip_init`` keeps
the module constructors from touching the global RNG. :class:`BatchNorm1d` and
:class:`BatchNorm2d` are the counterparts of ``TorchBatchNorm``: torch's eps 1e-5 and
momentum 0.1, which are the JAX package's (flax's momentum 0.9 is the same running
average), with flax's running-variance update in train mode. :class:`ConvTranspose` is
``TorchConvTranspose``'s counterpart, :func:`max_pool` ``max_pool``'s, and
:class:`LayerNorm` flax's two-pass LayerNorm where it differs from torch's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from blindno_torch.utils import torch_init as tinit


class _FlaxRunningVar:
    """Train-mode BatchNorm as flax computes it (``blindno/nn/torch_layers.py:88-107``).

    Both normalize with the biased batch variance, but torch updates ``running_var``
    with the unbiased one, n/(n-1) times larger, where flax takes the biased one. Train
    mode therefore runs torch's own batch norm on copies of the running statistics (its
    backward keeps them, so they must not change after it) and then takes the factor out
    of the update: torch added ``m * n/(n-1) * var`` to ``(1-m) * running_var``, and that
    term is scaled by (n-1)/n. This costs a few operations on C-sized vectors and no pass
    over the input. The normalization runs in float32 whatever the input's dtype (torch's
    batch norm takes a bfloat16 input with float32 parameters and statistics), and the
    result has the input's dtype, as flax's ``dtype=float32`` plus the cast back gives.
    Eval mode is torch's, unchanged.
    """

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        # torch's factor: the momentum, or a cumulative average without one
        m = (self.momentum if self.momentum is not None
             else 1.0 / float(self.num_batches_tracked))
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, m, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            kept = self.running_var * (1.0 - m)
            self.running_var.copy_(kept + (var - kept) * ((n - 1) / n))
            self.running_mean.copy_(mean)
        return y.to(x.dtype)


class BatchNorm1d(_FlaxRunningVar, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's train-mode running variance (see
    :class:`_FlaxRunningVar`); the state-dict keys are torch's."""


class BatchNorm2d(_FlaxRunningVar, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode running variance (see
    :class:`_FlaxRunningVar`); the state-dict keys are torch's."""


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm over the last axis, exact where it normalizes a single element, as
    flax's two-pass LayerNorm is there: x - mean(x) is 0, the output is the bias, and
    the gradients of the input and the scale are exactly 0. torch's fused kernel gives
    the bias too, but its backward leaves rounding in those gradients (up to 7e-5 at a
    one-channel ConvNeXt block on the CPU), so over one element this computes flax's
    formula, mean((x - mean)^2) for the variance, in plain operations."""

    def forward(self, x):
        if self.normalized_shape != (1,):
            return super().forward(x)
        xc = x - x.mean(-1, keepdim=True)
        var = (xc * xc).mean(-1, keepdim=True)
        return xc * torch.rsqrt(var + self.eps) * self.weight + self.bias


def gelu(x):
    """Exact (erf) gelu, torch's default and the JAX package's choice."""
    return F.gelu(x)


def leaky_relu(x, slope: float = 0.01):
    """``x`` where ``x >= 0``, else ``slope * x``, with the JAX package's gradient: 1 at
    0, where ``F.leaky_relu``'s is ``slope``. The two differ only at exact zeros, as the
    trunk's first layers have at grid point (0, 0) while their biases are zero. Without
    a gradient to take, ``F.leaky_relu``'s one kernel computes the same values."""
    if torch.is_grad_enabled() and x.requires_grad:
        return torch.where(x >= 0, x, slope * x)
    return F.leaky_relu(x, slope)


def linear(in_features: int, out_features: int, generator, bias: bool = True) -> nn.Linear:
    """nn.Linear with torch's default init drawn from ``generator``."""
    m = skip_init(nn.Linear, in_features, out_features, bias=bias)
    return tinit.torch_default_(m, in_features, generator)


def conv1d(in_channels: int, out_channels: int, kernel_size: int, stride: int, padding: int,
           generator, groups: int = 1) -> nn.Conv1d:
    """nn.Conv1d (symmetric integer padding) with torch's default init; fan_in is
    ``kernel * in_channels / groups``."""
    m = skip_init(nn.Conv1d, in_channels, out_channels, kernel_size, stride=stride,
                  padding=padding, groups=groups)
    return tinit.torch_default_(m, in_channels // groups * m.kernel_size[0], generator)


def conv2d(in_channels: int, out_channels: int, kernel_size, stride, padding,
           generator, groups: int = 1) -> nn.Conv2d:
    """nn.Conv2d (symmetric integer padding) with torch's default init; fan_in is
    ``kh * kw * in_channels / groups``."""
    m = skip_init(nn.Conv2d, in_channels, out_channels, kernel_size, stride=stride,
                  padding=padding, groups=groups)
    kh, kw = m.kernel_size
    return tinit.torch_default_(m, in_channels // groups * kh * kw, generator)


def max_pool(x, window: int):
    """torch MaxPoolNd(window): stride = window, floor mode. Channel-first, 1-D or 2-D."""
    return (F.max_pool1d if x.dim() == 3 else F.max_pool2d)(x, window)


class ConvTranspose(nn.Module):
    """The JAX package's ``TorchConvTranspose`` (``blindno/nn/torch_layers.py:50-85``) in
    1-D or 2-D, channel-first: a VALID transposed convolution with its bias, output
    ``(in - 1) * stride + kernel``, then ``output_padding`` rows (and columns) of zeros
    at the end. torch's own ``output_padding`` would fill them with the bias instead, so
    the convolution runs without it and :func:`F.pad` adds the zeros.

    ``weight`` is torch's (cin, cout, *kernel) and ``bias`` (cout,), with torch's
    ConvTranspose init (:func:`~blindno_torch.utils.torch_init.torch_conv_transpose_`).
    A flax kernel (*kernel, cin, cout) becomes this weight only flipped in space
    (``blindno_torch.convert``): flax's transposed convolution does not flip the kernel,
    torch's does.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride,
                 output_padding, generator: torch.Generator):
        super().__init__()
        self.kernel_size, self.stride = tuple(kernel_size), tuple(stride)
        self.output_padding = tuple(output_padding)
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, *self.kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        tinit.torch_conv_transpose_(self, generator)

    def forward(self, x):
        fn = F.conv_transpose1d if len(self.kernel_size) == 1 else F.conv_transpose2d
        y = fn(x, self.weight, self.bias, self.stride)
        if not any(self.output_padding):
            return y
        pads = [p for op in reversed(self.output_padding) for p in (0, op)]
        return F.pad(y, pads)
