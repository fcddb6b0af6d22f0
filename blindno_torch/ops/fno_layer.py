"""One FNO layer as plain PyTorch (counterpart of ``blindno/ops/fno_layer.py``).

:func:`fno1d_layer_plain` and :func:`fno2d_layer_plain` are the plain versions of the
CUDA kernels ``fno1d_layer_cuda`` and ``fno2d_layer_cuda``
(:mod:`blindno_torch.ops.spectral_cuda`): ``act(spectral_conv(x) + pk^T x + pb)`` with
the exact (erf) gelu. :func:`fno1d_layer_backward_plain` and
:func:`fno2d_layer_backward_plain` are the gradients of the layers' linear parts (no
activation), the transpose chains that the JAX package writes in einsums beside its
Pallas forwards; ``fno1d_layer_cuda`` and ``fno2d_layer_cuda`` run them as the backwards
of their ``torch.autograd.Function`` classes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from blindno_torch.ops.spectral import (dft_matrices_1d, dft_matrices_2d, spectral_conv1d,
                                        spectral_conv2d)


def fno1d_layer_plain(x, wr, wi, pk, pb, dc_half: bool = True, apply_act: bool = True):
    """x: (B, Cin, N); wr/wi: (Cin, Cout, modes); pk: (Cin, Cout); pb: (Cout,)."""
    y = spectral_conv1d(x, wr, wi, dc_half) + torch.einsum("bcn,co->bon", x, pk) + pb.reshape(1, -1, 1)
    return F.gelu(y) if apply_act else y


def fno2d_layer_plain(x, wr, wi, pk, pb, apply_act: bool = True):
    """x: (B, Cin, H, W); wr/wi: (Cin, Cout, 2*m1, m2); pk: (Cin, Cout); pb: (Cout,)."""
    y = spectral_conv2d(x, wr, wi) + torch.einsum("bchw,co->bohw", x, pk) + pb.reshape(1, -1, 1, 1)
    return F.gelu(y) if apply_act else y


def fno1d_layer_backward_plain(x, wr, wi, pk, du, dc_half: bool = True):
    """Gradients ``(dx, dwr, dwi, dpk, dpb)`` of ``u = spectral_conv1d(x) + pk^T x + pb``
    for the upstream gradient ``du`` (B, Cout, N), after ``_linear1d``'s ``bwd``
    (``blindno/ops/fno_layer.py:47-66``). The forward rDFT matrix is the one the forward
    used, its DC column halved under ``dc_half``, both for ``dx`` and for the spectrum
    that the weight gradients recompute; the inverse has no halving."""
    n, modes = x.shape[-1], wr.shape[-1]
    fre, fim, gre, gim = dft_matrices_1d(n, modes, dc_half, x.dtype, x.device)
    ein = torch.einsum
    # inverse rDFT: u = or gre + oi gim
    d_or, d_oi = ein("bon,kn->bok", du, gre), ein("bon,kn->bok", du, gim)
    # channel mix: or = xr wr - xi wi; oi = xr wi + xi wr
    d_xr = ein("bok,iok->bik", d_or, wr) + ein("bok,iok->bik", d_oi, wi)
    d_xi = ein("bok,iok->bik", d_oi, wr) - ein("bok,iok->bik", d_or, wi)
    # forward rDFT (real input): xr = x fre; xi = x fim
    dx = (ein("bik,nk->bin", d_xr, fre) + ein("bik,nk->bin", d_xi, fim)
          + ein("bon,io->bin", du, pk))
    # the weight gradients need the forward spectrum, recomputed
    xr, xi = ein("bcn,nk->bck", x, fre), ein("bcn,nk->bck", x, fim)
    dwr = ein("bik,bok->iok", xr, d_or) + ein("bik,bok->iok", xi, d_oi)
    dwi = ein("bik,bok->iok", xr, d_oi) - ein("bik,bok->iok", xi, d_or)
    dpk = ein("bin,bon->io", x, du)
    dpb = du.sum(dim=(0, 2))
    return dx, dwr, dwi, dpk, dpb


def fno2d_layer_backward_plain(x, wr, wi, pk, du):
    """Gradients ``(dx, dwr, dwi, dpk, dpb)`` of ``u = spectral_conv2d(x) + pk^T x + pb``
    for the upstream gradient ``du`` (B, Cout, H, W), after
    ``blindno/ops/fno_layer.py:98-132``: each matrix of the forward chain transposed, in
    reverse order, and the forward spectrum recomputed for the weight gradients."""
    h, w = x.shape[-2:]
    m1, m2 = wr.shape[2] // 2, wr.shape[3]
    fyre, fyim, fxre, fxim, gxre, gxim, gyre, gyim = dft_matrices_2d(
        h, w, m1, m2, x.dtype, x.device)
    ein = torch.einsum
    # inverse rDFT along W: s = zr gyre + zi gyim
    d_zr, d_zi = ein("bohw,mw->bohm", du, gyre), ein("bohw,mw->bohm", du, gyim)
    # inverse +/- DFT along H: zr = or gxre - oi gxim; zi = or gxim + oi gxre
    d_or = ein("bohm,kh->bokm", d_zr, gxre) + ein("bohm,kh->bokm", d_zi, gxim)
    d_oi = ein("bohm,kh->bokm", d_zi, gxre) - ein("bohm,kh->bokm", d_zr, gxim)
    # channel mix: or = xr wr - xi wi; oi = xr wi + xi wr
    d_xr = ein("bokm,iokm->bikm", d_or, wr) + ein("bokm,iokm->bikm", d_oi, wi)
    d_xi = ein("bokm,iokm->bikm", d_oi, wr) - ein("bokm,iokm->bikm", d_or, wi)
    # forward +/- DFT along H: xr = yr fxre - yi fxim; xi = yr fxim + yi fxre
    d_yr = ein("bckm,hk->bchm", d_xr, fxre) + ein("bckm,hk->bchm", d_xi, fxim)
    d_yi = ein("bckm,hk->bchm", d_xi, fxre) - ein("bckm,hk->bchm", d_xr, fxim)
    # forward rDFT along W (real input): yr = x fyre; yi = x fyim
    dx = (ein("bchm,wm->bchw", d_yr, fyre) + ein("bchm,wm->bchw", d_yi, fyim)
          + ein("bohw,io->bihw", du, pk))
    # the weight gradients need the forward spectrum, recomputed
    yr, yi = ein("bchw,wm->bchm", x, fyre), ein("bchw,wm->bchm", x, fyim)
    xr = ein("bchm,hk->bckm", yr, fxre) - ein("bchm,hk->bckm", yi, fxim)
    xi = ein("bchm,hk->bckm", yr, fxim) + ein("bchm,hk->bckm", yi, fxre)
    dwr = ein("bikm,bokm->iokm", xr, d_or) + ein("bikm,bokm->iokm", xi, d_oi)
    dwi = ein("bikm,bokm->iokm", xr, d_oi) - ein("bikm,bokm->iokm", xi, d_or)
    dpk = ein("bihw,bohw->io", x, du)
    dpb = du.sum(dim=(0, 2, 3))
    return dx, dwr, dwi, dpk, dpb
