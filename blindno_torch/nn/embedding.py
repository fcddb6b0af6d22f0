"""Positional, rotary and timestep embeddings (counterpart of
``blindno/nn/embedding.py``): plain functions on tensors. Only
:func:`timestep_embedding` is reached, by the Transolver's time conditioning; the other
two are kept as the JAX package keeps them."""
from __future__ import annotations

import math

import torch


def timestep_embedding(timesteps, dim: int, max_period: int = 10000):
    """Sinusoidal timestep embeddings: timesteps (N,) -> (N, 1, dim), the cosines of the
    ``dim // 2`` frequencies, then their sines, then a zero column where ``dim`` is
    odd."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb[:, None, :]


def sinusoidal_position_encoding(n_pos: int, dim: int, device=None):
    """The transformer's positional encoding table (n_pos, dim): sines in the even
    columns, cosines in the odd ones."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(n_pos, dim, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: (dim + 1) // 2])
    return pe


def rotary_embedding(x, base: float = 10000.0):
    """Rotary position embedding over the token axis of x (B, T, D): the first two
    halves of the features rotated by the token's angles, an odd last feature kept."""
    b, t, d = x.shape
    half = d // 2
    freqs = 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:2 * half]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos, x[..., 2 * half:]], dim=-1)
