"""Truncated DFT matrices for the spectral layers (counterpart of ``blindno/ops/dft.py``).

An FNO keeps only ``modes << n`` frequencies, so each transform needs just the first
``modes`` columns of the DFT matrix (or the ``2*modes`` +/- rows along a full complex
axis). The spectral layer then becomes a chain of small dense products with explicit
real and imaginary planes. Every matrix is built in float64 numpy, cast to the target
dtype, and cached per (n, modes, dtype, device), as a normal tensor even when first asked
for under ``torch.inference_mode``, and copied to a card without a host synchronization.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["rdft_forward", "rdft_inverse", "dft_forward_pm", "dft_inverse_pm"]


def _pair(re, im, dtype, device):
    # the cached matrices serve inference and autograd alike: never inference tensors,
    # which autograd refuses to save, even when the first call comes under
    # torch.inference_mode(). A card gets them by an asynchronous copy from pinned
    # memory, so that a training step that first asks for them does not wait on the card
    with torch.inference_mode(False):
        def as_t(a):
            t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            if torch.device(device).type != "cuda":
                return t.to(device)
            return t.pin_memory().to(device, non_blocking=True)

        return as_t(re), as_t(im)


def _check_rdft(n, modes):
    if modes > n // 2 + 1:
        raise ValueError(f"modes={modes} exceeds n//2+1={n // 2 + 1} for n={n}")


def _check_pm(n, modes):
    if 2 * modes > n:
        raise ValueError(f"2*modes={2 * modes} exceeds n={n}: +/- mode blocks overlap")


@functools.lru_cache(maxsize=64)
def rdft_forward(n: int, modes: int, dtype=torch.float32, device="cpu", dc_half: bool = False):
    """Real-input truncated DFT ``X_k = sum_j x_j e^{-2 pi i j k / n}``, k < modes.

    Returns ``(fre, fim)`` of shape (n, modes): ``x @ fre + i x @ fim`` equals
    ``rfft(x)[..., :modes]``. ``dc_half`` halves the DC column (the 1-D quirk).
    """
    _check_rdft(n, modes)
    ang = 2.0 * np.pi * np.arange(n)[:, None] * np.arange(modes)[None, :] / n
    fre, fim = np.cos(ang), -np.sin(ang)
    if dc_half:
        fre[:, 0] *= 0.5
    return _pair(fre, fim, dtype, device)


@functools.lru_cache(maxsize=64)
def rdft_inverse(n: int, modes: int, dtype=torch.float32, device="cpu"):
    """Inverse of a mode-truncated rfft, ``y = Xr @ gre + Xi @ gim``; shapes (modes, n).

    Equals ``irfft`` of the spectrum zero-padded past ``modes``: coefficient 1 for the
    DC (and a kept Nyquist) mode, 2 for the interior modes, all over n.
    """
    _check_rdft(n, modes)
    ang = 2.0 * np.pi * np.arange(modes)[:, None] * np.arange(n)[None, :] / n
    coef = np.full((modes, 1), 2.0)
    coef[0] = 1.0
    if n % 2 == 0 and modes == n // 2 + 1:
        coef[-1] = 1.0
    return _pair(coef * np.cos(ang) / n, -coef * np.sin(ang) / n, dtype, device)


def _pm_freqs(n, modes):
    return np.concatenate([np.arange(modes), np.arange(n - modes, n)])


@functools.lru_cache(maxsize=64)
def dft_forward_pm(n: int, modes: int, dtype=torch.float32, device="cpu"):
    """Complex DFT restricted to the kept +/- frequencies ``[0, modes)`` and
    ``[n-modes, n)``. Returns ``(fre, fim)`` of shape (n, 2*modes); on ``z = zr + i zi``
    along the axis, ``Z = (zr fre - zi fim) + i (zr fim + zi fre)``."""
    _check_pm(n, modes)
    ang = 2.0 * np.pi * np.arange(n)[:, None] * _pm_freqs(n, modes)[None, :] / n
    return _pair(np.cos(ang), -np.sin(ang), dtype, device)


@functools.lru_cache(maxsize=64)
def dft_inverse_pm(n: int, modes: int, dtype=torch.float32, device="cpu"):
    """Inverse DFT from the 2*modes +/- frequencies back to n points (all others zero),
    ``z_j = (1/n) sum_k Z_k e^{+2 pi i j k / n}``. Returns ``(gre, gim)``, (2*modes, n)."""
    _check_pm(n, modes)
    ang = 2.0 * np.pi * _pm_freqs(n, modes)[:, None] * np.arange(n)[None, :] / n
    return _pair(np.cos(ang) / n, np.sin(ang) / n, dtype, device)
