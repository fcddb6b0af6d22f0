"""The 1-D NIO models (counterpart of ``blindno/models/nio1d.py``).

Input x (B, L, N) and grid (N, 1); output (B, N, sum(head_dims)); ``padding_frac`` is the
FNO1d stacks' domain padding (JAX's ``FNO1d`` field, 1/4 by default); :class:`NIOFPOde`
takes (B, L, n_obs) observations instead, with the same grid and output. Weights are drawn
from ``generator`` on the CPU and the model moves to ``device`` (CUDA unless the caller
passes another); it is built in eval mode.

In train mode (``model.train()``) the forward first subsamples the set
(:func:`~blindno_torch.nn.setops.subsample_set` with ``l_min``) from the ``generator``
it is given, or from the ``subsample=(indices, mask)`` it is handed; BatchNorm then uses
batch statistics, and the fusion's mean is masked.
"""
from __future__ import annotations

import torch
from torch import nn

from blindno_torch import default_device
from blindno_torch.nn.cnn import ENC_FPE80, Encoder1D, EncoderODE
from blindno_torch.nn.deeponet import FFN, DeepOnetNoBias
from blindno_torch.nn.fno import FNO1d
from blindno_torch.nn.setops import MeanFieldFusion, train_subsample


def _heads(modes, width, layers, head_dims, padding_frac, g):
    """One FNO1d head per entry of ``head_dims`` (its output channels)."""
    return nn.ModuleList(FNO1d(modes, width, layers, width, d, generator=g,
                               padding_frac=padding_frac) for d in head_dims)


class NIOFP1D(nn.Module):
    """Encoder1D branch + FFN trunk DeepONet, mean-field fusion, and one FNO1d head per
    entry of ``head_dims`` (output channels per head, concatenated on the last axis;
    (1, 1) is drift and diffusion for fpe1d)."""

    def __init__(self, input_dimensions_trunk: int = 1, n_hidden_layers: int = 3,
                 neurons: int = 100, n_basis: int = 25, fno_layers: int = 3, width: int = 30,
                 modes: int = 15, head_dims=(1, 1), encoder_final_convs=ENC_FPE80,
                 l_min: int = 50, padding_frac: float = 0.25,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.l_min = l_min
        branch = Encoder1D(n_basis, encoder_final_convs, generator=g)
        trunk = FFN(input_dimensions_trunk, n_basis, n_hidden_layers, neurons, generator=g)
        self.deeponet = DeepOnetNoBias(branch, trunk)
        self.fusion = MeanFieldFusion(width, grid_channels=1, generator=g)
        self.heads = _heads(modes, width, fno_layers, head_dims, padding_frac, g)
        self.eval()
        self.to(default_device(device))

    def forward(self, x, grid, *, generator: torch.Generator | None = None, subsample=None):
        x, mask = train_subsample(self, x, generator, subsample)
        fields = self.deeponet(x, grid)                      # (B, L, N)
        feats = self.fusion(grid.expand(x.shape[0], *grid.shape), fields, mask)
        return torch.cat([head(feats) for head in self.heads], dim=-1)


class NIOFPOde(nn.Module):
    """The ODE-observation NIO (``blindno/models/nio1d.py:61-87``): an EncoderODE branch
    over ``n_obs`` observations per snapshot (B, L, n_obs) and an FFN trunk over the grid
    (N, 1), the mean-field fusion, and one FNO1d head; output (B, N, output_dim). No suite
    trains it (``blindno_torch.suites.registry.VESTIGIAL_MODELS``)."""

    def __init__(self, input_dimensions_trunk: int = 1, n_hidden_layers: int = 3,
                 neurons: int = 100, n_basis: int = 25, fno_layers: int = 3, width: int = 30,
                 modes: int = 15, output_dim: int = 1, l_min: int = 50, n_obs: int = 11,
                 padding_frac: float = 0.25, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.l_min = l_min
        branch = EncoderODE(n_basis, n_obs, generator=g)
        trunk = FFN(input_dimensions_trunk, n_basis, n_hidden_layers, neurons, generator=g)
        self.deeponet = DeepOnetNoBias(branch, trunk)
        self.fusion = MeanFieldFusion(width, grid_channels=1, generator=g)
        self.heads = _heads(modes, width, fno_layers, (output_dim,), padding_frac, g)
        self.eval()
        self.to(default_device(device))

    def forward(self, x, grid, *, generator: torch.Generator | None = None, subsample=None):
        x, mask = train_subsample(self, x, generator, subsample)
        fields = self.deeponet(x, grid)                      # (B, L, N)
        feats = self.fusion(grid.expand(x.shape[0], *grid.shape), fields, mask)
        return self.heads[0](feats)


class NIOFNO1D(nn.Module):
    """FNO-branch NIO: a small FNO1d shared by all snapshots lifts each (value, grid)
    pair to a field, then mean-field fusion and the FNO1d heads as in :class:`NIOFP1D`."""

    def __init__(self, fno_layers: int = 3, width: int = 30, modes: int = 15,
                 head_dims=(1, 1), inner_modes: int = 12, inner_width: int = 4,
                 inner_layers: int = 2, l_min: int = 50, padding_frac: float = 0.25,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.l_min = l_min
        self.branch = FNO1d(inner_modes, inner_width, inner_layers, 2, 1, generator=g,
                            padding_frac=padding_frac)
        self.fusion = MeanFieldFusion(width, grid_channels=1, generator=g)
        self.heads = _heads(modes, width, fno_layers, head_dims, padding_frac, g)
        self.eval()
        self.to(default_device(device))

    def forward(self, x, grid, *, generator: torch.Generator | None = None, subsample=None):
        x, mask = train_subsample(self, x, generator, subsample)
        b, l, n = x.shape
        snaps = x.reshape(b * l, n, 1)
        fields = self.branch(torch.cat([snaps, grid.expand(b * l, *grid.shape)], dim=-1))
        feats = self.fusion(grid.expand(b, *grid.shape), fields.reshape(b, l, n), mask)
        return torch.cat([head(feats) for head in self.heads], dim=-1)
