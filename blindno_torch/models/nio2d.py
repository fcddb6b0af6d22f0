"""The 2-D NIO model (counterpart of ``blindno/models/nio2d.py``).

Input x (B, L, Nx, Ny) and grid (Nx, Ny, 2); output (B, Nx, Ny, 2).
"""
from __future__ import annotations

import torch
from torch import nn

from blindno_torch import default_device
from blindno_torch.nn.cnn import Encoder2D
from blindno_torch.nn.deeponet import FFN, DeepOnetNoBias
from blindno_torch.nn.fno import FNO2d
from blindno_torch.nn.setops import MeanFieldFusion, subsample_set


class NIOFP2D(nn.Module):
    """Encoder2D branch + FFN trunk (3 hidden layers) DeepONet + mean-field fusion +
    two single-channel FNO2d heads (drift, diffusion). Weights are drawn from
    ``generator`` on the CPU and the model moves to ``device`` (CUDA unless the caller
    passes another). It is built in eval mode.

    In train mode (``model.train()``) the forward first subsamples the set
    (:func:`~blindno_torch.nn.setops.subsample_set` with ``l_min``) from the
    ``generator`` it is given, or from the ``subsample=(indices, mask)`` it is handed;
    BatchNorm then uses batch statistics, and the fusion masks its mean.
    """

    def __init__(self, neurons: int = 100, n_basis: int = 25, fno_layers: int = 3,
                 width: int = 12, modes: int = 32, encoder_final_kernel=(2, 1),
                 l_min: int = 50, generator: torch.Generator | None = None, device=None):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.l_min = l_min
        branch = Encoder2D(n_basis, encoder_final_kernel, generator=g)
        trunk = FFN(2, n_basis, 3, neurons, generator=g)
        self.deeponet = DeepOnetNoBias(branch, trunk)
        self.fusion = MeanFieldFusion(width, grid_channels=2, generator=g)
        self.heads = nn.ModuleList(
            FNO2d(modes, width, fno_layers, width, 1, generator=g)
            for _ in range(2))
        self.eval()
        self.to(default_device(device))

    def forward(self, x, grid, *, generator: torch.Generator | None = None, subsample=None):
        mask = None
        if self.training:
            x, mask = subsample_set(x, self.l_min, generator, *(subsample or ()))
        b, l, nx, ny = x.shape
        fields = self.deeponet(x, grid.reshape(-1, 2)).reshape(b, l, nx, ny)
        grid_feats = grid.unsqueeze(0).expand(b, *grid.shape)
        feats = self.fusion(grid_feats, fields, mask)
        return torch.cat([head(feats) for head in self.heads], dim=-1)
