"""Initializers with PyTorch-default semantics (counterpart of
``blindno/utils/torch_init.py``), each drawing from an explicit ``torch.Generator``.

They fill existing tensors in place under ``no_grad``; the tensors live on the
generator's device (the CPU, where the modules are built before they move).
"""
from __future__ import annotations

import math

import torch


@torch.no_grad()
def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> torch.Tensor:
    return t.uniform_(-bound, bound, generator=generator)


def torch_default_(module, fan_in: int, generator: torch.Generator):
    """nn.Linear / nn.Conv default: kaiming_uniform(a=sqrt(5)) on the weight, which is
    U(+-1/sqrt(fan_in)), and U(+-1/sqrt(fan_in)) on the bias."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    uniform_(module.weight, bound, generator)
    if module.bias is not None:
        uniform_(module.bias, bound, generator)
    return module


def torch_conv_transpose_(module, generator: torch.Generator):
    """nn.ConvTranspose default on a (cin, cout, *kernel) weight: torch takes fan_in as
    ``cout * prod(kernel)`` (the JAX package's ``torch_conv_transpose_kernel``), for the
    weight and the bias alike."""
    w = module.weight
    return torch_default_(module, w.shape[1] * math.prod(w.shape[2:]), generator)


@torch.no_grad()
def kaiming_uniform_leaky_(weight, a: float, generator: torch.Generator):
    """kaiming_uniform_(a, nonlinearity='leaky_relu') on an (out, in) weight:
    bound = sqrt(2 / (1 + a^2)) * sqrt(3 / fan_in)."""
    gain = math.sqrt(2.0 / (1.0 + a * a))
    return uniform_(weight, gain * math.sqrt(3.0 / weight.shape[1]), generator)


@torch.no_grad()
def spectral_uniform_(t, scale: float, generator: torch.Generator):
    """The reference's spectral weights: ``scale * U[0, 1)`` per real/imaginary plane."""
    return t.uniform_(0.0, 1.0, generator=generator).mul_(scale)


@torch.no_grad()
def trunc_normal_(t, std: float, generator: torch.Generator):
    """timm's ``trunc_normal_`` as the JAX package draws it (``trunc_normal``): N(0, std)
    cut at +-2 std. The Transolver's linear weights."""
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def orthogonal_(weight, generator: torch.Generator):
    """torch's ``orthogonal_`` on an (out, in) weight, the JAX package's
    ``orthogonal_init`` (the Transolver's slice projection)."""
    return torch.nn.init.orthogonal_(weight, generator=generator)
