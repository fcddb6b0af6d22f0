"""One FNO layer as plain PyTorch (counterpart of ``blindno/ops/fno_layer.py``).

:func:`fno1d_layer_plain` and :func:`fno2d_layer_plain` are the plain versions of the
CUDA kernels ``fno1d_layer_cuda`` and ``fno2d_layer_cuda``
(:mod:`blindno_torch.ops.spectral_cuda`): ``act(spectral_conv(x) + pk^T x + pb)`` with
the exact (erf) gelu. Forward only so far.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from blindno_torch.ops.spectral import spectral_conv1d, spectral_conv2d


def fno1d_layer_plain(x, wr, wi, pk, pb, dc_half: bool = True, apply_act: bool = True):
    """x: (B, Cin, N); wr/wi: (Cin, Cout, modes); pk: (Cin, Cout); pb: (Cout,)."""
    y = spectral_conv1d(x, wr, wi, dc_half) + torch.einsum("bcn,co->bon", x, pk) + pb.reshape(1, -1, 1)
    return F.gelu(y) if apply_act else y


def fno2d_layer_plain(x, wr, wi, pk, pb, apply_act: bool = True):
    """x: (B, Cin, H, W); wr/wi: (Cin, Cout, 2*m1, m2); pk: (Cin, Cout); pb: (Cout,)."""
    y = spectral_conv2d(x, wr, wi) + torch.einsum("bchw,co->bohw", x, pk) + pb.reshape(1, -1, 1, 1)
    return F.gelu(y) if apply_act else y
