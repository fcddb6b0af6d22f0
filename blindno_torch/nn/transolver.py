"""Transolver, the physics slice-attention transformer (counterpart of
``blindno/nn/transolver.py``).

The slice attention projects N grid tokens onto G learned "physics slices" through a
temperature-scaled softmax over G, runs QKV attention among the G slice tokens, and
spreads the result back over the N tokens.

flax builds its modules at call time, so the JAX package reads the mesh's shape from
the input. Here the modules are built ahead: ``mesh_ndim`` (None for an irregular mesh,
2 for a structured 2-D one) fixes the parameters, and the forward takes the tokens'
``mesh_shape``. Tokens are the row-major flattening of the mesh, channel-last.

Each module keeps its sub-modules in lists in flax's order of creation, so that entry k
is flax's ``Dense_k``, ``LayerNorm_k`` or ``TorchConv_k`` (``blindno_torch.convert``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from blindno_torch.nn.embedding import timestep_embedding
from blindno_torch.nn.torch_layers import Conv2d, Conv3d, LayerNorm, Linear, gelu, promoted
from blindno_torch.utils import torch_init as tinit

LN_EPS = 1e-6  # flax's LayerNorm default


def _trunc_linear(in_features, out_features, generator, bias=True):
    """The Transolver's Linear: trunc_normal(0.02) weight, zero bias."""
    m = skip_init(Linear, in_features, out_features, bias=bias)
    tinit.trunc_normal_(m.weight, 0.02, generator)
    if bias:
        nn.init.zeros_(m.bias)
    return m


def _conv(ndim, cin, cout, generator):
    """A 3^ndim convolution with padding 1 and torch's default init (``TorchConv``)."""
    m = skip_init({2: Conv2d, 3: Conv3d}[ndim], cin, cout, 3, padding=1)
    return tinit.torch_default_(m, cin * 3 ** ndim, generator)


class PhysicsAttention(nn.Module):
    """Slice attention. ``mesh_ndim=None``: Linear in-projections; ``mesh_ndim`` 2 or 3:
    3x3 (x3) convolutions over the mesh as in-projections, and the temperature clamped to
    [0.1, 5]. ``dense`` holds, in flax's order, the two in-projections (irregular mesh
    only), the slice projection (orthogonal init), q, k, v (no bias) and the output
    projection. x: (B, N, dim) -> (B, N, dim)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, slice_num: int = 64,
                 mesh_ndim: int | None = None, dropout: float = 0.0, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        inner = heads * dim_head
        self.heads, self.dim_head, self.mesh_ndim = heads, dim_head, mesh_ndim
        self.temperature = nn.Parameter(torch.full((1, heads, 1, 1), 0.5))
        dense = []
        if mesh_ndim is None:
            self.convs = nn.ModuleList()
            dense += [_trunc_linear(dim, inner, g), _trunc_linear(dim, inner, g)]
        else:
            self.convs = nn.ModuleList(_conv(mesh_ndim, dim, inner, g) for _ in range(2))
        to_slice = skip_init(Linear, dim_head, slice_num)
        tinit.orthogonal_(to_slice.weight, g)
        nn.init.zeros_(to_slice.bias)
        dense += [to_slice] + [_trunc_linear(dim_head, dim_head, g, bias=False) for _ in range(3)]
        dense.append(_trunc_linear(inner, dim, g))
        self.dense = nn.ModuleList(dense)
        self.dropout = nn.Dropout(dropout)

    def _in_projections(self, x, mesh_shape):
        if self.mesh_ndim is None:
            return self.dense[0](x), self.dense[1](x), self.temperature
        b, n, c = x.shape
        xg = x.reshape(b, *mesh_shape, c).movedim(-1, 1)
        fx_mid, x_mid = (conv(xg).movedim(1, -1).reshape(b, n, -1) for conv in self.convs)
        return fx_mid, x_mid, self.temperature.clamp(0.1, 5.0)

    def forward(self, x, mesh_shape=None):
        b, n, _ = x.shape
        fx_mid, x_mid, temp = self._in_projections(x, mesh_shape)
        split = lambda t: t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
        fx_mid, x_mid = split(fx_mid), split(x_mid)  # (B, H, N, dh)
        to_slice, to_q, to_k, to_v, to_out = self.dense[-5:]

        slice_weights = torch.softmax(to_slice(x_mid) / temp, dim=-1)  # (B, H, N, G)
        slice_norm = slice_weights.sum(2)  # (B, H, G)
        slice_token = torch.einsum("bhnc,bhng->bhgc", *promoted(fx_mid, slice_weights))
        slice_token = slice_token / (slice_norm[..., None] + 1e-5)

        q, k, v = to_q(slice_token), to_k(slice_token), to_v(slice_token)
        attn = self.dropout(torch.softmax(q @ k.transpose(-1, -2) * self.dim_head ** -0.5, dim=-1))
        out = torch.einsum("bhgc,bhng->bhnc", *promoted(attn @ v, slice_weights))
        return self.dropout(to_out(out.transpose(1, 2).reshape(b, n, -1)))


class TransolverMLP(nn.Module):
    """Linear, exact gelu, ``n_layers`` inner Linear + gelu (residual with ``res``), and
    an output Linear; ``layers`` in that order."""

    def __init__(self, n_input: int, n_hidden: int, n_output: int, n_layers: int = 0,
                 res: bool = True, *, generator: torch.Generator):
        super().__init__()
        self.res = res
        self.layers = nn.ModuleList(
            [_trunc_linear(n_input, n_hidden, generator)]
            + [_trunc_linear(n_hidden, n_hidden, generator) for _ in range(n_layers)]
            + [_trunc_linear(n_hidden, n_output, generator)])

    def forward(self, x):
        h = gelu(self.layers[0](x))
        for layer in self.layers[1:-1]:
            inner = gelu(layer(h))
            h = inner + h if self.res else inner
        return self.layers[-1](h)


class TransolverBlock(nn.Module):
    """Pre-LayerNorm slice attention and MLP, each with its residual; the last block
    adds a LayerNorm and a Linear to ``out_dim``. ``norms`` are flax's LayerNorm_0..2."""

    def __init__(self, num_heads: int, hidden_dim: int, dropout: float = 0.0,
                 mlp_ratio: int = 1, last_layer: bool = False, out_dim: int = 1,
                 slice_num: int = 32, mesh_ndim: int | None = None, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.attn = PhysicsAttention(hidden_dim, num_heads, hidden_dim // num_heads, slice_num,
                                     mesh_ndim, dropout, generator=g)
        self.norms = nn.ModuleList(LayerNorm(hidden_dim, eps=LN_EPS)
                                   for _ in range(3 if last_layer else 2))
        self.mlp = TransolverMLP(hidden_dim, hidden_dim * mlp_ratio, hidden_dim, 0, False,
                                 generator=g)
        self.out = _trunc_linear(hidden_dim, out_dim, g) if last_layer else None

    def forward(self, fx, mesh_shape=None):
        fx = self.attn(self.norms[0](fx), mesh_shape) + fx
        fx = self.mlp(self.norms[1](fx)) + fx
        return fx if self.out is None else self.out(self.norms[2](fx))


def unified_pos_features(mesh_shape, ref: int):
    """The distances from each point of the (h, w) mesh on [0, 1]^2 to each point of a
    ref x ref reference mesh: (1, h*w, ref*ref), float32."""
    h, w = mesh_shape
    gx, gy = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    grid = np.stack([gx, gy], -1).reshape(h * w, 1, 2)
    rx, ry = np.meshgrid(np.linspace(0, 1, ref), np.linspace(0, 1, ref), indexing="ij")
    refg = np.stack([rx, ry], -1).reshape(1, ref * ref, 2)
    pos = np.sqrt(((grid - refg) ** 2).sum(-1)).reshape(1, h * w, ref * ref)
    return torch.tensor(pos, dtype=torch.float32)


class Transolver(nn.Module):
    """The Transolver model, called ``forward(x, fx=None, t=None, mesh_shape=None)`` as
    the JAX package calls it: ``x`` (B, N, space_dim) and ``fx`` (B, N, fun_dim),
    concatenated as ``[x, fx]`` before the input MLP, whose width is ``space_dim +
    fun_dim`` (``unified_pos`` replaces ``x`` by the distances to a ref x ref mesh, ref²
    features). The NIOs pass the snapshot's values as ``x`` and the grid as ``fx``, one
    and two features, which the default ``space_dim=2, fun_dim=1`` adds up to.
    ``fun_dim=0`` means no ``fx``: a learned ``placeholder`` (U[0, 1) / n_hidden) is added
    after the MLP instead. ``time_input`` adds an embedding of ``t`` through two Linears
    (``time_fc``). Output (B, N, out_dim)."""

    def __init__(self, space_dim: int = 2, n_layers: int = 3, n_hidden: int = 32,
                 dropout: float = 0.0, n_head: int = 4, mlp_ratio: int = 1, fun_dim: int = 1,
                 out_dim: int = 1, slice_num: int = 16, ref: int = 8,
                 unified_pos: bool = False, mesh_ndim: int | None = None,
                 time_input: bool = False, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.ref, self.fun_dim, self.n_hidden = ref, fun_dim, n_hidden
        self.unified_pos = unified_pos and mesh_ndim is not None
        n_in = (ref * ref if self.unified_pos else space_dim) + fun_dim
        self.preprocess = TransolverMLP(n_in, n_hidden * 2, n_hidden, 0, False, generator=g)
        if fun_dim == 0:
            self.placeholder = nn.Parameter(
                torch.rand(n_hidden, generator=g) / n_hidden)
        self.time_fc = nn.ModuleList(_trunc_linear(n_hidden, n_hidden, g)
                                     for _ in range(2 if time_input else 0))
        self.blocks = nn.ModuleList(
            TransolverBlock(n_head, n_hidden, dropout, mlp_ratio, i == n_layers - 1, out_dim,
                            slice_num, mesh_ndim, generator=g)
            for i in range(n_layers))

    def forward(self, x, fx=None, t=None, mesh_shape=None):
        if (fx is None) != (self.fun_dim == 0):
            raise ValueError("Transolver: pass fx exactly when fun_dim > 0")
        if self.unified_pos:
            pos = unified_pos_features(mesh_shape, self.ref).to(x.device)
            x = pos.expand(x.shape[0], *pos.shape[1:])
        if fx is not None:
            fx = self.preprocess(torch.cat([x, fx], dim=-1))
        else:
            fx = self.preprocess(x) + self.placeholder
        if t is not None and len(self.time_fc):
            emb = timestep_embedding(t, self.n_hidden)
            fx = fx + self.time_fc[1](F.silu(self.time_fc[0](emb)))
        for block in self.blocks:
            fx = block(fx, mesh_shape)
        return fx
