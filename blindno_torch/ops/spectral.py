"""Spectral convolution as a truncated-DFT product chain (counterpart of
``blindno/ops/spectral.py``).

- :func:`spectral_conv1d` and :func:`spectral_conv2d` are the plain PyTorch versions of
  the CUDA kernels ``spectral_conv1d_cuda`` and ``spectral_conv2d_cuda``
  (:mod:`blindno_torch.ops.spectral_cuda`).
- :func:`spectral_conv1d_fft` and :func:`spectral_conv2d_fft` restate the same operators
  with ``torch.fft``; tests and ``chip_smoke.py`` use them as references and
  yardsticks, the port's path never does.

Weights are real and imaginary planes ``wr, wi``: (Cin, Cout, modes) in 1-D, and
(Cin, Cout, 2*m1, m2) in 2-D with the +/- row blocks stacked along axis 2 (rows [0, m1)
then [H-m1, H)).
"""
from __future__ import annotations

import torch

from blindno_torch.ops.dft import dft_forward_pm, dft_inverse_pm, rdft_forward, rdft_inverse


def dft_matrices_1d(n: int, modes: int, dc_half: bool, dtype, device):
    """The four matrices of the 1-D chain: forward (n, modes) with the DC column halved
    when ``dc_half``, and inverse (modes, n), each as (re, im)."""
    return (*rdft_forward(n, modes, dtype, device, dc_half), *rdft_inverse(n, modes, dtype, device))


def spectral_conv1d(x, wr, wi, dc_half: bool = True):
    """x: (B, Cin, N) real; wr/wi: (Cin, Cout, modes). Returns (B, Cout, N).

    ``dc_half`` halves the DC coefficient before the mix, the reference's 1-D quirk."""
    fre, fim, gre, gim = dft_matrices_1d(x.shape[-1], wr.shape[-1], dc_half, x.dtype, x.device)
    ein = torch.einsum
    xr, xi = ein("bcn,nk->bck", x, fre), ein("bcn,nk->bck", x, fim)
    outr = ein("bik,iok->bok", xr, wr) - ein("bik,iok->bok", xi, wi)
    outi = ein("bik,iok->bok", xr, wi) + ein("bik,iok->bok", xi, wr)
    return ein("bok,kn->bon", outr, gre) + ein("bok,kn->bon", outi, gim)


def spectral_conv1d_fft(x, wr, wi, dc_half: bool = True):
    """``torch.fft`` restatement of :func:`spectral_conv1d`: rfft, the DC halved, the
    first ``modes`` coefficients mixed, irfft."""
    n, modes = x.shape[-1], wr.shape[-1]
    xf = torch.fft.rfft(x)[..., :modes]
    if dc_half:
        xf = torch.cat([xf[..., :1] * 0.5, xf[..., 1:]], dim=-1)
    full = torch.zeros(x.shape[0], wr.shape[1], n // 2 + 1, dtype=xf.dtype, device=x.device)
    full[..., :modes] = torch.einsum("bik,iok->bok", xf, torch.complex(wr, wi))
    return torch.fft.irfft(full, n=n)


def dft_matrices_2d(h: int, w: int, m1: int, m2: int, dtype, device):
    """The eight matrices of the 2-D chain, in the order the kernel takes them:
    forward W (W, m2), forward +/-H (H, 2*m1), inverse +/-H (2*m1, H), inverse W (m2, W),
    each as (re, im)."""
    return (*rdft_forward(w, m2, dtype, device), *dft_forward_pm(h, m1, dtype, device),
            *dft_inverse_pm(h, m1, dtype, device), *rdft_inverse(w, m2, dtype, device))


def spectral_conv2d(x, wr, wi):
    """x: (B, Cin, H, W) real; wr/wi: (Cin, Cout, 2*m1, m2). Returns (B, Cout, H, W)."""
    h, w = x.shape[-2:]
    m1, m2 = wr.shape[2] // 2, wr.shape[3]
    fyre, fyim, fxre, fxim, gxre, gxim, gyre, gyim = dft_matrices_2d(
        h, w, m1, m2, x.dtype, x.device)
    ein = torch.einsum
    # truncated rDFT along W (real input)
    yr, yi = ein("bchw,wm->bchm", x, fyre), ein("bchw,wm->bchm", x, fyim)
    # +/- block DFT along H (complex input)
    xr = ein("bchm,hk->bckm", yr, fxre) - ein("bchm,hk->bckm", yi, fxim)
    xi = ein("bchm,hk->bckm", yr, fxim) + ein("bchm,hk->bckm", yi, fxre)
    # per-mode complex channel mix
    outr = ein("bikm,iokm->bokm", xr, wr) - ein("bikm,iokm->bokm", xi, wi)
    outi = ein("bikm,iokm->bokm", xr, wi) + ein("bikm,iokm->bokm", xi, wr)
    # inverse DFT along H
    zr = ein("bokm,kh->bohm", outr, gxre) - ein("bokm,kh->bohm", outi, gxim)
    zi = ein("bokm,kh->bohm", outr, gxim) + ein("bokm,kh->bohm", outi, gxre)
    # inverse rDFT along W, real part
    return ein("bohm,mw->bohw", zr, gyre) + ein("bohm,mw->bohw", zi, gyim)


def spectral_conv2d_fft(x, wr, wi):
    """``torch.fft`` restatement of :func:`spectral_conv2d`: rfft2, the two +/- row
    blocks times the first m2 columns, irfft2."""
    b, _, h, w_len = x.shape
    m1, m2 = wr.shape[2] // 2, wr.shape[3]
    wc = torch.complex(wr, wi)
    xf = torch.fft.rfft2(x)
    full = torch.zeros(b, wr.shape[1], h, w_len // 2 + 1, dtype=xf.dtype, device=x.device)
    mix = lambda a, ww: torch.einsum("bikm,iokm->bokm", a, ww)
    full[:, :, :m1, :m2] = mix(xf[:, :, :m1, :m2], wc[:, :, :m1])
    full[:, :, h - m1:, :m2] = mix(xf[:, :, h - m1:, :m2], wc[:, :, m1:])
    return torch.fft.irfft2(full, s=(h, w_len))
