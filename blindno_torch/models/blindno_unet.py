"""BlinDNO: the permutation-invariant attention UNet with FNO heads (counterpart of
``blindno/models/blindno_unet.py``), the paper's main model.

Input x (B, L, *spatial) and a grid it ignores, as JAX does; output
(B, *spatial, sum(head_dims)). Each snapshot runs through a UNet (channels
``base_ch * 2^i``, ConvNeXt or plain blocks); at the bottleneck and at every skip
connection a set self-attention over the snapshot axis and a (masked) mean pool the
set; a 1x1 conv to ``width`` channels feeds the FNO heads, whose layers run the
``fno1d_layer`` or ``fno2d_layer`` kernel. The convolutions, pools and the attention are
plain torch (cuDNN and cuBLAS on the card), as they are XLA operations in JAX.
"""
from __future__ import annotations

import torch
from torch import nn

from blindno_torch import default_device
from blindno_torch.nn.convnext import ConvNeXtBlock, PlainConvBlock
from blindno_torch.nn.fno import FNO1d, FNO2d
from blindno_torch.nn.setops import TemporalSelfAttention, masked_mean, subsample_set
from blindno_torch.nn.torch_layers import (BatchNorm1d, BatchNorm2d, ConvTranspose, conv1d,
                                           conv2d, max_pool)

BLOCKS = {"convnext": ConvNeXtBlock, "plain": PlainConvBlock}


def _unet_shapes(input_size, depth):
    """Per-level spatial sizes and the transposed convs' output paddings that restore
    them (odd sizes: 61 -> 30 -> 15 -> 7 -> 3 and back)."""
    sizes = [tuple(input_size)]
    for _ in range(depth):
        sizes.append(tuple(s // 2 for s in sizes[-1]))
    pads = []
    cur = sizes[-1]
    for size in reversed(sizes[:-1]):
        pads.append(tuple(s - ((c - 1) * 2 + 2) for s, c in zip(size, cur)))
        cur = size
    return sizes, pads


class PermInvUNetAttn(nn.Module):
    """The JAX class's options: ``input_size`` (N,) or (H, W), ``depth``, ``base_ch``,
    ``width``, ``fno_modes``, ``fno_layers``, ``head_dims``, ``block`` ("convnext" or
    "plain"), ``use_attention``, ``subsample`` with ``l_min``, and ``padding_frac``, the
    FNO heads' domain padding (JAX's ``FNO1d``/``FNO2d`` field). Weights are drawn from
    ``generator`` on the CPU and the model moves to ``device`` (CUDA unless the caller
    passes another); it is built in eval mode.

    The modules are kept in the order flax creates them, so that entry k of each list
    is flax's ``_k``: ``convs`` the down path's convs, the up path's and the 1x1 fuse
    last; ``blocks`` likewise; ``attention`` the bottleneck's, then the skip of up step
    i as entry i+1; ``transposes`` and ``skip_norms`` one per up step.

    In train mode with ``subsample`` the forward first subsamples the set
    (:func:`~blindno_torch.nn.setops.subsample_set` with ``l_min``) from ``generator``
    or from the injected ``subsample=(indices, mask)``; BatchNorm uses batch
    statistics, and the set pools mask their means.
    """

    def __init__(self, input_size, depth: int = 4, base_ch: int = 1, width: int = 30,
                 fno_modes: int = 15, fno_layers: int = 3, head_dims=(1, 1),
                 block: str = "convnext", use_attention: bool = True, subsample: bool = False,
                 l_min: int = 50, padding_frac: float = 0.25,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if block not in BLOCKS:
            raise ValueError(f"unknown block {block!r} (want one of {sorted(BLOCKS)})")
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.input_size = tuple(input_size)
        self.depth, self.subsample, self.l_min = depth, subsample, l_min
        ndim = len(self.input_size)
        conv, bn, fno = (conv1d, BatchNorm1d, FNO1d) if ndim == 1 else (conv2d, BatchNorm2d, FNO2d)
        chs = [base_ch * 2 ** i for i in range(depth + 1)]
        sizes, pads = _unet_shapes(self.input_size, depth)
        up = [depth - 1 - i for i in range(depth)]  # the level of up step i
        self.convs = nn.ModuleList(
            [conv(chs[i - 1] if i else 1, chs[i], 3, 1, 1, g) for i in range(depth + 1)]
            + [conv(2 * chs[lv], chs[lv], 3, 1, 1, g) for lv in up]
            + [conv(chs[0], width, 1, 1, 0, g)])
        self.blocks = nn.ModuleList(BLOCKS[block](chs[lv], ndim, g)
                                    for lv in [*range(depth + 1), *up])
        self.attention = nn.ModuleList(
            TemporalSelfAttention(chs[lv], sizes[lv]) for lv in [depth, *up]
        ) if use_attention else None
        self.transposes = nn.ModuleList(
            ConvTranspose(chs[lv + 1], chs[lv], (2,) * ndim, (2,) * ndim, pads[i], g)
            for i, lv in enumerate(up))
        self.skip_norms = nn.ModuleList(bn(chs[lv]) for lv in up)
        self.heads = nn.ModuleList(fno(fno_modes, width, fno_layers, width, d, generator=g,
                                       padding_frac=padding_frac) for d in head_dims)
        self.eval()
        self.to(default_device(device))

    def _set_pool(self, feat, k, b, l, mask):
        """Level features (B·L, C, *spatial) -> set attention ``k`` and the (masked) mean
        over L -> (B, C, *spatial)."""
        seq = feat.reshape(b, l, *feat.shape[1:])
        if self.attention is not None:
            seq = self.attention[k](seq, mask)
        return seq.mean(1) if mask is None else masked_mean(seq, mask, 1)

    def forward(self, x, grid=None, *, generator: torch.Generator | None = None, subsample=None):
        mask = None
        if self.training and self.subsample:
            x, mask = subsample_set(x, self.l_min, generator, *(subsample or ()))
        fused = self.features(x, mask)
        return torch.cat([head(fused) for head in self.heads], dim=-1)

    def features(self, x, mask=None):
        """The set encoder: snapshots (B, L, *spatial) and the subsample's mask (or None)
        -> the heads' input (B, *spatial, width)."""
        b, l, *spatial = x.shape
        if tuple(spatial) != self.input_size:
            raise ValueError(f"PermInvUNetAttn: snapshots of {tuple(spatial)}, built for "
                             f"{self.input_size}")
        depth = self.depth
        h = x.reshape(b * l, 1, *spatial)
        feats = []
        for i in range(depth + 1):
            h = self.blocks[i](self.convs[i](h))
            feats.append(h)
            if i < depth:
                h = max_pool(h, 2)
        h = self._set_pool(h, 0, b, l, mask)
        for i in range(depth):
            skip = self.skip_norms[i](self._set_pool(feats[depth - 1 - i], i + 1, b, l, mask))
            h = torch.cat([self.transposes[i](h), skip], dim=1)
            h = self.blocks[depth + 1 + i](self.convs[depth + 1 + i](h))
        return self.convs[-1](h).movedim(1, -1)
