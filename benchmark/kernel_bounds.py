"""Peaks of one H100 and the least time of an FNO layer call: the yardstick of every
roofline and MFU share the benchmark reports.

A frozen copy of ``chip_smoke.py``'s ``fft_flops`` and ``layer_bound`` and of its two
peaks, kept here so that a change to the program cannot move the yardstick.
"""
from __future__ import annotations

import math

# H100 SXM published peaks (NVIDIA data sheet, 700 W): float32 outside the tensor cores,
# which is all that a float32 run with TF32 off may use, and HBM3
PEAK_F32_FLOP_S = 67e12
PEAK_BYTES_S = 3.35e12


def fft_flops(n, real):
    """Operations of an n-point FFT by the usual count, 5 n log2 n (half for real data)."""
    return (2.5 if real else 5.0) * n * math.log2(n)


def layer_bound(shape, epilogue):
    """Least time for one layer call, 1-D shape (B, C, N, modes) or 2-D shape
    (B, C, H, W, m1, m2[, Cout]): the larger of its bytes (inputs read once, output
    written once) over the memory rate and the least operations that compute it over the
    f32 peak. The least operations do the truncated transforms as FFTs: the kernels'
    dense DFT products (``mflop_dense_dft``, reported beside) are their own algorithm,
    not what the function needs. The forward transforms run over the C input channels,
    the inverse ones over the Cout output channels."""
    if len(shape) == 4:
        b, c, n, m = shape
        o = c
        dense = b * c * n * m * 4 + b * c * c * m * 8 + b * c * m * n * 4
        least = 2 * b * c * fft_flops(n, True) + b * c * c * m * 8
        floats = 2 * b * c * n + 2 * c * c * m
        points = b * c * n
    else:
        b, c, h, w, m1, m2 = shape[:6]
        o = shape[6] if len(shape) > 6 else c
        k = 2 * m1
        dense = (b * c * h * m2 * w * 4 + b * c * k * m2 * h * 8 + b * c * o * k * m2 * 8
                 + b * o * h * m2 * k * 8 + b * o * h * w * m2 * 4)
        least = (b * (c + o) * h * fft_flops(w, True) + b * (c + o) * m2 * fft_flops(h, False)
                 + b * c * o * k * m2 * 8)
        floats = b * (c + o) * h * w + 2 * c * o * k * m2
        points = b * o * h * w
    if epilogue:
        pointwise = points * (2 * c + 1)
        dense += pointwise
        least += pointwise
        floats += c * o + o
    t_ops, t_bytes = least / PEAK_F32_FLOP_S, 4 * floats / PEAK_BYTES_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_bytes_ms=1e3 * t_bytes, bound_ops_ms=1e3 * t_ops,
                mflop_least=least / 1e6, mflop_dense_dft=dense / 1e6, mbytes=4 * floats / 1e6)
