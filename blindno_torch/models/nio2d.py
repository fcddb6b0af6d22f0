"""The 2-D NIO models (counterpart of ``blindno/models/nio2d.py``): the DeepONet NIO
``NIOFP2D``, the FNO-branch ``NIOFNO2D``, the Transolver NIO ``NIOTrans2D``, and their
token-attention variants ``NIOAttn2D``, ``NIOFNOAttn2D`` and ``NIOTransAttn2D``.

Input x (B, L, Nx, Ny) and grid (Nx, Ny, 2); output (B, Nx, Ny, sum(head_dims)): one
FNO2d head per entry of ``head_dims`` (its output channels, concatenated on the last
axis as JAX's ``_heads`` does; (1, 1), drift and diffusion or Fx and Fy, by default).
``padding_frac`` is the FNO2d stacks' domain padding (JAX's ``FNO2d`` field, 1/4 by
default; the FNO-branch models' inner FNO2d takes it too). Every model draws
its weights from ``generator`` on the CPU, moves to ``device`` (CUDA unless the caller
passes another) and is built in eval mode.

In train mode (``model.train()``) the forward first subsamples the set
(:func:`~blindno_torch.nn.setops.subsample_set` with ``l_min``) from the ``generator``
it is given, or from the ``subsample=(indices, mask)`` it is handed; BatchNorm then
uses batch statistics, and the attention's keys, the fusion's mean or both are masked.
"""
from __future__ import annotations

import torch
from torch import nn

from blindno_torch import default_device
from blindno_torch.nn.cnn import Encoder2D
from blindno_torch.nn.deeponet import FFN, DeepOnetNoBias
from blindno_torch.nn.fno import FNO2d
from blindno_torch.nn.setops import (MeanFieldFusion, TokenMeanFusion, set_self_attention,
                                     train_subsample)
from blindno_torch.nn.transolver import Transolver


def _fno_heads(modes, width, layers, head_dims, padding_frac, g):
    """One FNO2d head per entry of ``head_dims``, its output channels."""
    return nn.ModuleList(FNO2d(modes, width, layers, width, d, generator=g,
                               padding_frac=padding_frac) for d in head_dims)


def _heads(heads, feats):
    return torch.cat([head(feats) for head in heads], dim=-1)


def _grid_feats(grid, b):
    return grid.unsqueeze(0).expand(b, *grid.shape)


def _token_attention_tokens(fields, grid, mask):
    """The grid's two channels and the L per-snapshot fields as T = L + 2 tokens of
    dimension Nx·Ny, through the unparameterized set self-attention
    (``blindno/models/nio2d.py:124-136``). fields (B, L, Nx, Ny); mask (L,) or None, whose
    keys the grid tokens join as always valid. Returns the attended tokens (B, T, Nx, Ny)
    and the full (T,) mask."""
    b, l, nx, ny = fields.shape
    grid_tokens = grid.permute(2, 0, 1).unsqueeze(0).expand(b, 2, nx, ny)
    tokens = torch.cat([grid_tokens, fields], dim=1)
    full_mask = None if mask is None else torch.cat([mask.new_ones(2), mask])
    z = set_self_attention(tokens.reshape(b, l + 2, nx * ny), full_mask)
    return z.reshape(b, l + 2, nx, ny), full_mask


class NIOFP2D(nn.Module):
    """Encoder2D branch + FFN trunk DeepONet (``n_hidden_layers`` hidden layers of
    ``neurons``) + mean-field fusion + the FNO2d heads; the "NIO" baseline. The trunk
    takes the grid's two coordinates whatever ``input_dimensions_trunk`` says: JAX's
    ``FFN`` is given the field and does not use it; its ``Dense`` layers take their in-features
    from the flattened grid (``blindno/models/nio2d.py:57-59``), and the port builds the
    trunk that flax builds, so that such a tree carries over."""

    def __init__(self, input_dimensions_trunk: int = 2, n_hidden_layers: int = 3,
                 neurons: int = 100, n_basis: int = 25, fno_layers: int = 3, width: int = 12,
                 modes: int = 32, head_dims=(1, 1), encoder_final_kernel=(2, 1),
                 l_min: int = 50, padding_frac: float = 0.25,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.l_min = l_min
        branch = Encoder2D(n_basis, encoder_final_kernel, generator=g)
        trunk = FFN(2, n_basis, n_hidden_layers, neurons, generator=g)
        self.deeponet = DeepOnetNoBias(branch, trunk)
        self.fusion = MeanFieldFusion(width, grid_channels=2, generator=g)
        self.heads = _fno_heads(modes, width, fno_layers, head_dims, padding_frac, g)
        self.eval()
        self.to(default_device(device))

    def fields(self, x, grid):
        """The DeepONet's field per snapshot, (B, L, Nx, Ny)."""
        b, l, nx, ny = x.shape
        return self.deeponet(x, grid.reshape(-1, 2)).reshape(b, l, nx, ny)

    def forward(self, x, grid, *, generator: torch.Generator | None = None, subsample=None):
        x, mask = train_subsample(self, x, generator, subsample)
        feats = self.fusion(_grid_feats(grid, x.shape[0]), self.fields(x, grid), mask)
        return _heads(self.heads, feats)


class NIOAttn2D(NIOFP2D):
    """:class:`NIOFP2D` with the token self-attention between the DeepONet and the
    fusion (``blindno/models/nio2d.py:201-226``): the attended grid tokens become the
    fusion's grid features and the attended snapshot tokens its fields. Its parameters
    and their names are :class:`NIOFP2D`'s (the attention has none)."""

    def forward(self, x, grid, *, generator: torch.Generator | None = None, subsample=None):
        x, mask = train_subsample(self, x, generator, subsample)
        z, _ = _token_attention_tokens(self.fields(x, grid), grid, mask)
        return _heads(self.heads, self.fusion(z[:, :2].movedim(1, -1), z[:, 2:], mask))


class NIOFNO2D(nn.Module):
    """FNO-branch NIO, the "NIO-FNO" baseline (``blindno/models/nio2d.py:66-90``): a small
    FNO2d (``branch``: 12 modes, width 4, 2 layers) shared by all snapshots lifts each
    (value, grid x, grid y) point to a field, then the mean-field fusion and the FNO2d
    heads as in :class:`NIOFP2D`."""

    def __init__(self, fno_layers: int = 3, width: int = 12, modes: int = 32,
                 head_dims=(1, 1), inner_modes: int = 12, inner_width: int = 4,
                 inner_layers: int = 2, l_min: int = 50, padding_frac: float = 0.25,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.l_min = l_min
        self.branch = FNO2d(inner_modes, inner_width, inner_layers, 3, 1, generator=g,
                            padding_frac=padding_frac)
        self.fusion = self._fusion(width, g)
        self.heads = _fno_heads(modes, width, fno_layers, head_dims, padding_frac, g)
        self.eval()
        self.to(default_device(device))

    @staticmethod
    def _fusion(width, g):
        return MeanFieldFusion(width, grid_channels=2, generator=g)

    def fields(self, x, grid):
        """The inner FNO2d over all B·L snapshots, each with the grid as two more
        channels: (B, L, Nx, Ny)."""
        b, l, nx, ny = x.shape
        snaps = torch.cat([x.reshape(b * l, nx, ny, 1), _grid_feats(grid, b * l)], dim=-1)
        return self.branch(snaps).reshape(b, l, nx, ny)

    def forward(self, x, grid, *, generator: torch.Generator | None = None, subsample=None):
        x, mask = train_subsample(self, x, generator, subsample)
        feats = self.fusion(_grid_feats(grid, x.shape[0]), self.fields(x, grid), mask)
        return _heads(self.heads, feats)


class NIOFNOAttn2D(NIOFNO2D):
    """:class:`NIOFNO2D` with the token self-attention after the inner FNO2d and a
    :class:`~blindno_torch.nn.setops.TokenMeanFusion` over all T = L + 2 attended tokens
    in place of the mean-field fusion (``blindno/models/nio2d.py:173-198``)."""

    @staticmethod
    def _fusion(width, g):
        return TokenMeanFusion(width, n_always=2, generator=g)

    def forward(self, x, grid, *, generator: torch.Generator | None = None, subsample=None):
        x, mask = train_subsample(self, x, generator, subsample)
        z, _ = _token_attention_tokens(self.fields(x, grid), grid, mask)
        return _heads(self.heads, self.fusion(z, mask))


class NIOTrans2D(nn.Module):
    """Transolver NIO (``blindno/models/nio2d.py:93-115``): a structured-mesh
    :class:`~blindno_torch.nn.transolver.Transolver` (``trans``) shared by all snapshots
    turns each snapshot's (value, grid x, grid y) tokens into a field, then the
    mean-field fusion and the FNO2d heads as in :class:`NIOFP2D`."""

    def __init__(self, fno_layers: int = 3, width: int = 12, modes: int = 32,
                 head_dims=(1, 1), trans_layers: int = 3, trans_hidden: int = 32,
                 trans_heads: int = 4, slice_num: int = 16, l_min: int = 50,
                 padding_frac: float = 0.25, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.l_min = l_min
        self.trans = Transolver(space_dim=2, n_layers=trans_layers, n_hidden=trans_hidden,
                                n_head=trans_heads, fun_dim=1, out_dim=1, slice_num=slice_num,
                                mesh_ndim=2, generator=g)
        self.fusion = MeanFieldFusion(width, grid_channels=2, generator=g)
        self.heads = _fno_heads(modes, width, fno_layers, head_dims, padding_frac, g)
        self.eval()
        self.to(default_device(device))

    def fields(self, x, grid):
        """The Transolver over all B·L snapshots, called as the JAX package calls it:
        the snapshot's values as ``x`` and the grid as ``fx``, so each token's features
        are (value, grid x, grid y). (B, L, Nx, Ny)."""
        b, l, nx, ny = x.shape
        vals = x.reshape(b * l, nx * ny, 1)
        g = grid.reshape(1, nx * ny, 2).expand(b * l, nx * ny, 2)
        return self.trans(vals, g, mesh_shape=(nx, ny)).reshape(b, l, nx, ny)

    def forward(self, x, grid, *, generator: torch.Generator | None = None, subsample=None):
        x, mask = train_subsample(self, x, generator, subsample)
        feats = self.fusion(_grid_feats(grid, x.shape[0]), self.fields(x, grid), mask)
        return _heads(self.heads, feats)


class NIOTransAttn2D(NIOTrans2D):
    """:class:`NIOTrans2D` with the token self-attention between the Transolver and the
    fusion (``blindno/models/nio2d.py:139-170``), as :class:`NIOAttn2D` has it after its
    DeepONet. Its parameters and their names are :class:`NIOTrans2D`'s."""

    def forward(self, x, grid, *, generator: torch.Generator | None = None, subsample=None):
        x, mask = train_subsample(self, x, generator, subsample)
        z, _ = _token_attention_tokens(self.fields(x, grid), grid, mask)
        return _heads(self.heads, self.fusion(z[:, :2].movedim(1, -1), z[:, 2:], mask))
