"""Split-step Fourier solver for the 1-D Schrodinger / Gross-Pitaevskii equation
``i psi_t = -1/2 psi_xx + (V + g|psi|^2 + kappa|psi|^4) psi`` (counterpart of
``blindno/solvers/gpe.py``): Strang (2nd order) and Yoshida (4th order) splitting, a
loop over complex64 states on ``torch.fft``.

Float32 and complex64 throughout, as JAX without x64 has them: the grid, its spacing and
the wave numbers too. Where JAX ``vmap``s over orbits, these functions take a batch:
psi0 (B, Nx) or (Nx,), v (B, Nx) or (Nx,), g and kappa scalars or (B,).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def get_initial_condition(ic: int, x):
    """The three fixed initial conditions; ic=2, sin(x)/cosh(x), is the one used
    everywhere."""
    if ic == 1:
        return torch.exp(-(x**2) / 10.0)
    if ic == 2:
        return 2.0 * torch.sin(x) / (torch.exp(x) + torch.exp(-x))
    if ic == 3:
        return 2.0 * torch.cos(x) / (torch.exp(x) + torch.exp(-x))
    raise ValueError("ic must be 1, 2 or 3")


def _step_nonlinear(psi, dt, v, g, kappa):
    absq = torch.abs(psi) ** 2
    return torch.exp(-1j * dt * (v + g * absq + kappa * absq**2)) * psi


def _step_linear(psi, dt, k):
    return torch.fft.ifft(torch.exp(-1j * dt * 0.5 * (k**2)) * torch.fft.fft(psi))


def _strang(psi, dt, k, v, g, kappa):
    psi = _step_nonlinear(psi, dt / 2.0, v, g, kappa)
    psi = _step_linear(psi, dt, k)
    return _step_nonlinear(psi, dt / 2.0, v, g, kappa)


def _yoshida4(psi, dt, k, v, g, kappa):
    """The 4th-order Yoshida triple jump, strang(w1) o strang(w2) o strang(w1) with
    adjacent nonlinear half-steps merged (the JAX package's correct scheme, not the
    reference's unused ``step_fourth_order``)."""
    w1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
    w2 = 1.0 - 2.0 * w1
    psi = _step_nonlinear(psi, w1 / 2.0 * dt, v, g, kappa)
    psi = _step_linear(psi, w1 * dt, k)
    psi = _step_nonlinear(psi, (w1 + w2) / 2.0 * dt, v, g, kappa)
    psi = _step_linear(psi, w2 * dt, k)
    psi = _step_nonlinear(psi, (w1 + w2) / 2.0 * dt, v, g, kappa)
    psi = _step_linear(psi, w1 * dt, k)
    return _step_nonlinear(psi, w1 / 2.0 * dt, v, g, kappa)


def wave_numbers(x):
    """``2 pi fftfreq(Nx, dx)`` as JAX computes it in float32: the integer frequencies
    over ``dx * Nx``, ``dx = x[1] - x[0]``."""
    nx = x.shape[0]
    ints = torch.cat([torch.arange(0, (nx - 1) // 2 + 1), torch.arange(-(nx // 2), 0)])
    dx = x[1] - x[0]
    return 2.0 * math.pi * (ints.to(x) / (dx * nx))


def _per_orbit(value, like):
    t = torch.as_tensor(value, dtype=torch.float32, device=like.device)
    return t[..., None] if t.dim() == 1 else t


def solve_gpe(psi0, x, dt, nt: int, g, kappa, v, order: int = 2):
    """The split-step integrator over ``nt - 1`` steps; returns the record including
    t = 0, (nt, Nx) for one orbit or (B, nt, Nx) for a batch (a psi0 of (Nx,) is shared
    by all orbits), complex64 (``solve_GPE_custom`` with ``nt = int(t_final/dt) + 1``)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    k = wave_numbers(x)
    v = torch.as_tensor(v, dtype=torch.float32, device=x.device)
    psi = torch.as_tensor(psi0, device=x.device).to(torch.complex64)
    psi = psi.expand(torch.broadcast_shapes(psi.shape, v.shape))
    g, kappa = _per_orbit(g, x), _per_orbit(kappa, x)
    stepper = _strang if order == 2 else _yoshida4
    rec = [psi]
    for _ in range(nt - 1):
        psi = stepper(psi, dt, k, v, g, kappa)
        rec.append(psi)
    return torch.stack(rec, dim=-2)


def solve_gpe_batch(psi0, x, dt, nt: int, g, kappa, v, order: int = 2):
    """The batch solve: psi0 (B, Nx), or (Nx,) shared by all; g, kappa (B,); v (B, Nx).
    Returns (B, nt, Nx)."""
    return solve_gpe(psi0, x, dt, nt, g, kappa, v, order)


def time_grid(dt, t_final):
    nt = int(round(t_final / dt)) + 1
    return np.linspace(0.0, t_final, nt), nt
