"""Spectral convolution as a truncated-DFT product chain (counterpart of
``blindno/ops/spectral.py``).

- :func:`spectral_conv1d` and :func:`spectral_conv2d` are the plain PyTorch versions of
  the CUDA kernels ``spectral_conv1d_cuda`` and ``spectral_conv2d_cuda``
  (:mod:`blindno_torch.ops.spectral_cuda`).
- :func:`spectral_conv3d` is ``FNO3d``'s spectral convolution. The JAX package computes
  it outside any Pallas kernel (``blindno/nn/fno.py:84`` calls the einsum chain), and so
  does the port, on every device.
- :func:`spectral_conv1d_fft`, :func:`spectral_conv2d_fft` and
  :func:`spectral_conv3d_fft` restate the same operators with ``torch.fft``; tests and
  ``chip_smoke.py`` use them as references and yardsticks, the port's path never does.

Weights are real and imaginary planes ``wr, wi``: (Cin, Cout, modes) in 1-D,
(Cin, Cout, 2*m1, m2) in 2-D with the +/- row blocks stacked along axis 2 (rows [0, m1)
then [H-m1, H)), and (Cin, Cout, 2*m1, 2*m2, m3) in 3-D, the four +/- corner blocks
stacked as [[w1, w3], [w2, w4]] over the halves of axes 2 and 3. The products run at
full float32 where TF32 is off, torch's default for matmul (JAX computes them at
``Precision.HIGHEST``).
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


def spectral_conv3d(x, wr, wi):
    """x: (B, Cin, D1, D2, D3) real; wr/wi: (Cin, Cout, 2*m1, 2*m2, m3). Returns
    (B, Cout, D1, D2, D3): the truncated rDFT along D3, the +/- DFTs along D2 and D1, the
    per-mode channel mix, and the inverse chain."""
    d1, d2, d3 = x.shape[-3:]
    m1, m2, m3 = wr.shape[2] // 2, wr.shape[3] // 2, wr.shape[4]
    fzre, fzim = rdft_forward(d3, m3, x.dtype, x.device)
    fyre, fyim = dft_forward_pm(d2, m2, x.dtype, x.device)
    fxre, fxim = dft_forward_pm(d1, m1, x.dtype, x.device)
    gxre, gxim = dft_inverse_pm(d1, m1, x.dtype, x.device)
    gyre, gyim = dft_inverse_pm(d2, m2, x.dtype, x.device)
    gzre, gzim = rdft_inverse(d3, m3, x.dtype, x.device)
    ein = torch.einsum

    def cmul(s, ar, ai, br, bi):
        """(ar + i ai) x (br + i bi) contracted by the einsum ``s``."""
        return ein(s, ar, br) - ein(s, ai, bi), ein(s, ar, bi) + ein(s, ai, br)

    zr, zi = ein("bcxyz,zm->bcxym", x, fzre), ein("bcxyz,zm->bcxym", x, fzim)
    yr, yi = cmul("bcxym,yk->bcxkm", zr, zi, fyre, fyim)
    xr, xi = cmul("bcxkm,xj->bcjkm", yr, yi, fxre, fxim)
    outr, outi = cmul("bijkm,iojkm->bojkm", xr, xi, wr, wi)
    ar, ai = cmul("bojkm,jx->boxkm", outr, outi, gxre, gxim)
    br, bi = cmul("boxkm,ky->boxym", ar, ai, gyre, gyim)
    return ein("boxym,mz->boxyz", br, gzre) + ein("boxym,mz->boxyz", bi, gzim)


def spectral_conv3d_fft(x, wr, wi):
    """``torch.fft`` restatement of :func:`spectral_conv3d`: rfftn over the three spatial
    axes, the four +/- corner blocks mixed, irfftn."""
    b, _, d1, d2, d3 = x.shape
    m1, m2, m3 = wr.shape[2] // 2, wr.shape[3] // 2, wr.shape[4]
    wc = torch.complex(wr, wi)
    xf = torch.fft.rfftn(x, dim=(-3, -2, -1))
    full = torch.zeros(b, wr.shape[1], d1, d2, d3 // 2 + 1, dtype=xf.dtype, device=x.device)
    mix = lambda a, ww: torch.einsum("bijkm,iojkm->bojkm", a, ww)
    for rows, wrows in ((slice(0, m1), slice(0, m1)), (slice(d1 - m1, d1), slice(m1, 2 * m1))):
        for cols, wcols in ((slice(0, m2), slice(0, m2)), (slice(d2 - m2, d2), slice(m2, 2 * m2))):
            full[:, :, rows, cols, :m3] = mix(xf[:, :, rows, cols, :m3], wc[:, :, wrows, wcols])
    return torch.fft.irfftn(full, s=(d1, d2, d3), dim=(-3, -2, -1))
