"""Activations and layer builders with the JAX package's torch semantics
(counterpart of ``blindno/nn/torch_layers.py``).

Builders draw their initial weights from an explicit generator; ``skip_init`` keeps
the module constructors from touching the global RNG. BatchNorm is ``nn.BatchNorm1d``
/ ``nn.BatchNorm2d`` with torch's defaults, eps 1e-5 and momentum 0.1, which are the JAX
package's (flax's momentum 0.9 is the same running average).
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from blindno_torch.utils import torch_init as tinit


def gelu(x):
    """Exact (erf) gelu, torch's default and the JAX package's choice."""
    return F.gelu(x)


def leaky_relu(x, slope: float = 0.01):
    return F.leaky_relu(x, slope)


def linear(in_features: int, out_features: int, generator, bias: bool = True) -> nn.Linear:
    """nn.Linear with torch's default init drawn from ``generator``."""
    m = skip_init(nn.Linear, in_features, out_features, bias=bias)
    return tinit.torch_default_(m, in_features, generator)


def conv1d(in_channels: int, out_channels: int, kernel_size: int, stride: int, padding: int,
           generator) -> nn.Conv1d:
    """nn.Conv1d (symmetric integer padding) with torch's default init."""
    m = skip_init(nn.Conv1d, in_channels, out_channels, kernel_size, stride=stride,
                  padding=padding)
    return tinit.torch_default_(m, in_channels * m.kernel_size[0], generator)


def conv2d(in_channels: int, out_channels: int, kernel_size, stride, padding,
           generator) -> nn.Conv2d:
    """nn.Conv2d (symmetric integer padding) with torch's default init."""
    m = skip_init(nn.Conv2d, in_channels, out_channels, kernel_size, stride=stride,
                  padding=padding)
    kh, kw = m.kernel_size
    return tinit.torch_default_(m, in_channels * kh * kw, generator)
