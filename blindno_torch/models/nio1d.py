"""The 1-D NIO models (counterpart of ``blindno/models/nio1d.py``), eval mode only.

Input x (B, L, N) and grid (N, 1); output (B, N, sum(head_dims)). Weights are drawn
from ``generator`` on the CPU and the model moves to ``device`` (CUDA unless the caller
passes another).
"""
from __future__ import annotations

import torch
from torch import nn

from blindno_torch import default_device
from blindno_torch.models import check_eval_only
from blindno_torch.nn.cnn import ENC_FPE80, Encoder1D
from blindno_torch.nn.deeponet import FFN, DeepOnetNoBias
from blindno_torch.nn.fno import FNO1d
from blindno_torch.nn.setops import MeanFieldFusion


class NIOFP1D(nn.Module):
    """Encoder1D branch + FFN trunk DeepONet, mean-field fusion, and one FNO1d head per
    entry of ``head_dims`` (output channels per head, concatenated on the last axis;
    (1, 1) is drift and diffusion for fpe1d)."""

    def __init__(self, input_dimensions_trunk: int = 1, n_hidden_layers: int = 3,
                 neurons: int = 100, n_basis: int = 25, fno_layers: int = 3, width: int = 30,
                 modes: int = 15, head_dims=(1, 1), encoder_final_convs=ENC_FPE80,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        branch = Encoder1D(n_basis, encoder_final_convs, generator=g)
        trunk = FFN(input_dimensions_trunk, n_basis, n_hidden_layers, neurons, generator=g)
        self.deeponet = DeepOnetNoBias(branch, trunk)
        self.fusion = MeanFieldFusion(width, grid_channels=1, generator=g)
        self.heads = nn.ModuleList(FNO1d(modes, width, fno_layers, width, d, generator=g)
                                   for d in head_dims)
        self.eval()
        self.to(default_device(device))

    def forward(self, x, grid, *, training: bool = False):
        check_eval_only("NIOFP1D", training, self)
        fields = self.deeponet(x, grid)                      # (B, L, N)
        feats = self.fusion(grid.expand(x.shape[0], *grid.shape), fields)
        return torch.cat([head(feats) for head in self.heads], dim=-1)


class NIOFNO1D(nn.Module):
    """FNO-branch NIO: a small FNO1d shared by all snapshots lifts each (value, grid)
    pair to a field, then mean-field fusion and the FNO1d heads as in :class:`NIOFP1D`."""

    def __init__(self, fno_layers: int = 3, width: int = 30, modes: int = 15,
                 head_dims=(1, 1), inner_modes: int = 12, inner_width: int = 4,
                 inner_layers: int = 2, generator: torch.Generator | None = None, device=None):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.branch = FNO1d(inner_modes, inner_width, inner_layers, 2, 1, generator=g)
        self.fusion = MeanFieldFusion(width, grid_channels=1, generator=g)
        self.heads = nn.ModuleList(FNO1d(modes, width, fno_layers, width, d, generator=g)
                                   for d in head_dims)
        self.eval()
        self.to(default_device(device))

    def forward(self, x, grid, *, training: bool = False):
        check_eval_only("NIOFNO1D", training, self)
        b, l, n = x.shape
        snaps = x.reshape(b * l, n, 1)
        fields = self.branch(torch.cat([snaps, grid.expand(b * l, *grid.shape)], dim=-1))
        feats = self.fusion(grid.expand(b, *grid.shape), fields.reshape(b, l, n))
        return torch.cat([head(feats) for head in self.heads], dim=-1)
