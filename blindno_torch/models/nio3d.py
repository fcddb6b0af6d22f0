"""The 3-D NIO (counterpart of ``blindno/models/nio3d.py``): volumetric snapshot sets to
a 3-D coefficient field.

Input x (B, L, D, H, W) and grid (D, H, W, 3); output (B, D, H, W, out_dim). The model
draws its weights from ``generator`` on the CPU, moves to ``device`` (CUDA unless the
caller passes another) and is built in eval mode. In train mode (``model.train()``) the
forward first subsamples the set (:func:`~blindno_torch.nn.setops.train_subsample`), as
every NIO does.
"""
from __future__ import annotations

import torch
from torch import nn

from blindno_torch import default_device
from blindno_torch.nn.cnn import Encoder3D
from blindno_torch.nn.deeponet import FFN, DeepOnetNoBias
from blindno_torch.nn.fno import FNO3d
from blindno_torch.nn.setops import MeanFieldFusion, train_subsample


class NIOFP3D(nn.Module):
    """Encoder3D branch + FFN trunk DeepONet over the flattened volume, mean-field fusion
    with the grid's 3 channels, and an FNO3d head. ``input_size`` (D, H, W) is the grid
    the encoder is built for (40^3 collapses to one point); ``encoder_dims`` its five
    channel widths."""

    def __init__(self, input_dimensions_trunk: int = 3, n_hidden_layers: int = 3,
                 neurons: int = 100, n_basis: int = 25, width: int = 12, modes: int = 8,
                 out_dim: int = 1, l_min: int = 50, input_size=(40, 40, 40),
                 encoder_dims=(64, 128, 256, 512, 512),
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.l_min = l_min
        branch = Encoder3D(n_basis, input_size, encoder_dims, generator=g)
        trunk = FFN(input_dimensions_trunk, n_basis, n_hidden_layers, neurons, generator=g)
        self.deeponet = DeepOnetNoBias(branch, trunk)
        self.fusion = MeanFieldFusion(width, grid_channels=3, generator=g)
        self.head = FNO3d(modes, width, width, out_dim, generator=g)
        self.eval()
        self.to(default_device(device))

    def fields(self, x, grid):
        """The DeepONet's field per snapshot, (B, L, D, H, W)."""
        return self.deeponet(x, grid.reshape(-1, 3)).reshape(x.shape)

    def forward(self, x, grid, *, generator: torch.Generator | None = None, subsample=None):
        x, mask = train_subsample(self, x, generator, subsample)
        fields = self.fields(x, grid)
        feats = self.fusion(grid.expand(x.shape[0], *grid.shape), fields, mask)
        return self.head(feats)
