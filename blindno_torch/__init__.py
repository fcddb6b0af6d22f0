"""blindno_torch: the PyTorch + CUDA port of ``blindno`` for NVIDIA Hopper (H100).

Layout mirrors ``blindno/`` (``ops``, ``nn``, ``models``, ``solvers``, ``data``,
``train``, ``eval``, ``suites``, ``utils``) so each module's counterpart is found by
name. Public functions keep the JAX package's layouts
(snapshot sets (B, L, N) or (B, L, H, W), grids (N, 1) or (H, W, 2), outputs
(B, N, F) or (B, H, W, 2), channel-first FNO interiors (B, C, N) or (B, C, H, W)), so
the parity tests compare like with like.

The FNO1d and FNO2d layers run through hand-written CUDA kernels (``csrc/fno1d_layer.cu``,
``csrc/fno2d_layer.cu``) on a CUDA tensor, and through their plain PyTorch versions only
for a tensor on the CPU.
This package never imports JAX or anything of ``blindno``.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks otherwise.

    There is no silent CPU fallback: with no CUDA device, only an explicit ``"cpu"``
    (or another non-CUDA device) is accepted.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return dev
