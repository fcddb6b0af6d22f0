"""DeepONet blocks: the activation table, random Fourier features, the FFN trunk and
the branch-trunk contraction (counterpart of ``blindno/nn/deeponet.py``)."""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from blindno_torch.nn.torch_layers import BatchNorm1d, Linear, leaky_relu, promoted
from blindno_torch.utils import torch_init as tinit


_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "leaky_relu": lambda x: leaky_relu(x, 0.01),
    "sigmoid": torch.sigmoid,
    "softplus": lambda x: F.softplus(4.0 * x) / 4.0,  # torch Softplus(beta=4)
    "celu": F.celu,
    "elu": F.elu,
    "swish": F.silu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "sin": torch.sin,
}


def activation(name: str) -> Callable:
    """The activation named ``name`` (any case), from the JAX package's table
    (``blindno/nn/deeponet.py:16-33``); ``ValueError`` for another name."""
    key = name.lower()
    if key not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation function: {name}")
    return _ACTIVATIONS[key]


class FourierFeatures(nn.Module):
    """Random Fourier features ``[sin(2 pi x B^T), cos(2 pi x B^T)]``: x (..., 2) ->
    (..., 2 * mapping_size). ``B`` (mapping_size, 2) is a parameter, ``scale * N(0, 1)``
    drawn from ``generator``."""

    def __init__(self, scale: float, mapping_size: int, generator: torch.Generator | None = None):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.B = nn.Parameter(scale * torch.randn(mapping_size, 2, generator=g))

    def forward(self, x):
        x, b = promoted(x, self.B)
        proj = (2.0 * math.pi * x) @ b.T
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class FFN(nn.Module):
    """MLP with the activation ``act_string`` (leaky_relu(0.01) by default) and BatchNorm
    between hidden layers; kaiming-leaky(0.01) weights and zero biases. With
    ``dropout_rate`` > 0, each hidden layer after the first drops its pre-activations in
    train mode (kept ones scaled by 1 / (1 - rate), as flax's ``nn.Dropout``), drawing from
    the ``generator`` the forward is given."""

    def __init__(self, input_dimension: int, output_dimension: int, n_hidden_layers: int,
                 neurons: int, generator: torch.Generator | None = None,
                 act_string: str = "leaky_relu", dropout_rate: float = 0.0):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.act, self.dropout_rate = activation(act_string), dropout_rate
        dims = [input_dimension] + [neurons] * n_hidden_layers + [output_dimension]
        self.layers = nn.ModuleList(skip_init(Linear, i, o) for i, o in zip(dims, dims[1:]))
        for layer in self.layers:
            tinit.kaiming_uniform_leaky_(layer.weight, 0.01, g)
            nn.init.zeros_(layer.bias)
        self.norms = nn.ModuleList(BatchNorm1d(neurons) for _ in range(n_hidden_layers - 1))

    def _dropout(self, h, generator):
        if not (self.training and self.dropout_rate > 0):
            return h
        if generator is None:
            raise ValueError("FFN: dropout in train mode draws from a torch.Generator; pass one")
        keep_prob = 1.0 - self.dropout_rate
        keep = torch.rand(h.shape, generator=generator, device=generator.device) < keep_prob
        return torch.where(keep.to(h.device), h / keep_prob, torch.zeros_like(h))

    def forward(self, x, generator: torch.Generator | None = None):
        x = self.act(self.layers[0](x))
        for layer, norm in zip(self.layers[1:-1], self.norms):
            x = norm(self.act(self._dropout(layer(x), generator)))
        return self.layers[-1](x)


class FeedForwardNN(FFN):
    """The config-dict flavoured MLP (``blindno/nn/deeponet.py:79-98``): an :class:`FFN`
    with the same arguments."""


class DeepOnetNoBias(nn.Module):
    """``(branch(u) . trunk(x)^T + b0) / sqrt(p)``: branch (B, L, p), trunk (N, p),
    result (B, L, N) in the dtype the two promote to, as in JAX
    (``blindno/nn/deeponet.py:111-116``): a bfloat16 branch output meets a float32 trunk in
    float32."""

    def __init__(self, branch: nn.Module, trunk: nn.Module):
        super().__init__()
        self.branch = branch
        self.trunk = trunk
        self.b0 = nn.Parameter(torch.zeros(()))

    def forward(self, u, x):
        weights = self.branch(u)
        basis = self.trunk(x)
        return ((torch.einsum("blp,np->bln", *promoted(weights, basis)) + self.b0)
                / math.sqrt(basis.shape[-1]))
