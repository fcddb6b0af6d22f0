"""DeepONet blocks: the FFN trunk and the branch-trunk contraction (counterpart of
``blindno/nn/deeponet.py``)."""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn.utils import skip_init

from blindno_torch.nn.torch_layers import BatchNorm1d, leaky_relu
from blindno_torch.utils import torch_init as tinit


class FFN(nn.Module):
    """MLP with leaky_relu(0.01) and BatchNorm between hidden layers; kaiming-leaky(0.01)
    weights and zero biases."""

    def __init__(self, input_dimension: int, output_dimension: int, n_hidden_layers: int,
                 neurons: int, generator: torch.Generator | None = None):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        dims = [input_dimension] + [neurons] * n_hidden_layers + [output_dimension]
        self.layers = nn.ModuleList(skip_init(nn.Linear, i, o) for i, o in zip(dims, dims[1:]))
        for layer in self.layers:
            tinit.kaiming_uniform_leaky_(layer.weight, 0.01, g)
            nn.init.zeros_(layer.bias)
        self.norms = nn.ModuleList(BatchNorm1d(neurons) for _ in range(n_hidden_layers - 1))

    def forward(self, x):
        x = leaky_relu(self.layers[0](x))
        for layer, norm in zip(self.layers[1:-1], self.norms):
            x = norm(leaky_relu(layer(x)))
        return self.layers[-1](x)


class DeepOnetNoBias(nn.Module):
    """``(branch(u) . trunk(x)^T + b0) / sqrt(p)``: branch (B, L, p), trunk (N, p),
    result (B, L, N) in the trunk's dtype. A bfloat16 branch output goes to the trunk's
    float32 before the contraction, where JAX promotes it
    (``blindno/nn/deeponet.py:111-116``)."""

    def __init__(self, branch: nn.Module, trunk: nn.Module):
        super().__init__()
        self.branch = branch
        self.trunk = trunk
        self.b0 = nn.Parameter(torch.zeros(()))

    def forward(self, u, x):
        weights = self.branch(u)
        basis = self.trunk(x)
        return ((torch.einsum("blp,np->bln", weights.to(basis.dtype), basis) + self.b0)
                / math.sqrt(basis.shape[-1]))
