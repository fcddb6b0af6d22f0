"""Potential, force and density constructors for the Fokker-Planck solver suites
(counterpart of ``blindno/solvers/potentials.py``), on tensors.

Each constructor returns a callable of the grid's coordinate tensors, computed in their
dtype; ``combine`` sums callables. The conventions (1/e half-width, attractive wells for
a positive amplitude, mass normalized by the solver) are the JAX package's
(``docs/fplanck_conventions.md``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "gaussian_potential",
    "gaussian_pdf",
    "combine",
    "potential_from_data",
    "uniform_pdf",
    "harmonic_potential",
    "spiral_force",
    "quadratic_cos2_potential",
]


def _vector(v):
    return np.atleast_1d(np.asarray(v, np.float64) * 1.0)


def gaussian_potential(center, width, amplitude):
    """Gaussian well ``U(x) = -A * prod_i exp(-((x_i - c_i)/w_i)^2)``, attractive for
    A > 0."""
    center = _vector(center)
    width = np.broadcast_to(_vector(width), center.shape)

    def u(*coords):
        val = 1.0
        for i, c in enumerate(coords):
            val = val * torch.exp(-(((c - float(center[i])) / float(width[i])) ** 2))
        return -amplitude * val

    return u


def gaussian_pdf(center, width):
    """Unnormalized Gaussian density ``exp(-sum_i ((x_i - c_i)/w)^2)``; the solver
    normalizes an initial condition to unit mass."""
    center = _vector(center)

    def p(*coords):
        val = 1.0
        for i, c in enumerate(coords):
            val = val * torch.exp(-(((c - float(center[i])) / width) ** 2))
        return val

    return p


def uniform_pdf():
    def p(*coords):
        return torch.ones_like(coords[0])

    return p


def harmonic_potential(k):
    def u(*coords):
        val = 0.0
        for c in coords:
            val = val + 0.5 * k * c**2
        return val

    return u


def combine(*funcs):
    """The sum of potential callables (``fplanck.combine``)."""

    def u(*coords):
        total = funcs[0](*coords)
        for f in funcs[1:]:
            total = total + f(*coords)
        return total

    return u


def _interp(x, xp, fp):
    """``np.interp`` on tensors: linear between the knots xp (increasing), fp[0] left of
    them and fp[-1] right."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    t = ((x - x0) / (x1 - x0)).clamp(0.0, 1.0)
    return f0 + t * (f1 - f0)


def potential_from_data(grid, data):
    """Linear (1-D) or bilinear (2-D) interpolation of tabulated potential values, the
    reference's ``RegularGridInterpolator`` replacement. ``grid``: the axis coordinates
    (a vector, or a pair of vectors or of meshgrids); ``data``: the values on that grid.
    Returns a callable usable as ``potential=`` for
    :class:`~blindno_torch.solvers.fokker_planck.FokkerPlanck`."""
    data = torch.as_tensor(data)
    if data.dim() == 1:
        nested = isinstance(grid, (tuple, list)) or torch.as_tensor(grid).dim() == 2
        axis = torch.as_tensor(grid[0] if nested else grid).reshape(-1)

        def u(*coords):
            return _interp(coords[0], axis.to(coords[0]), data.to(coords[0]))

        return u
    if data.dim() == 2:
        gx, gy = torch.as_tensor(grid[0]), torch.as_tensor(grid[1])
        ax = gx[:, 0] if gx.dim() == 2 else gx.reshape(-1)
        ay = gy[0, :] if gy.dim() == 2 else gy.reshape(-1)

        def u(x, y):
            axx, ayy, d = ax.to(x), ay.to(x), data.to(x)
            ix = (torch.searchsorted(axx, x.contiguous(), right=True) - 1).clamp(0, axx.shape[0] - 2)
            iy = (torch.searchsorted(ayy, y.contiguous(), right=True) - 1).clamp(0, ayy.shape[0] - 2)
            tx = ((x - axx[ix]) / (axx[ix + 1] - axx[ix])).clamp(0.0, 1.0)
            ty = ((y - ayy[iy]) / (ayy[iy + 1] - ayy[iy])).clamp(0.0, 1.0)
            return (d[ix, iy] * (1 - tx) * (1 - ty) + d[ix + 1, iy] * tx * (1 - ty)
                    + d[ix, iy + 1] * (1 - tx) * ty + d[ix + 1, iy + 1] * tx * ty)

        return u
    raise ValueError(f"potential_from_data supports 1-D/2-D data, got ndim={data.dim()}")


def spiral_force(L, a, b, c, d, scale=1e-12):
    """The ncfpe2d suite's non-conservative spiral force:
    ``F_phi = scale * (r/L) exp(-r b / L) a``, ``F_rad = scale * (1 - r/L) exp(-r d / L) c``.
    Returns a callable (x, y) -> (Fx, Fy) stacked on axis 0."""

    def f(x, y):
        rad = torch.sqrt(x**2 + y**2)
        phi = torch.atan2(y, x)
        f_phi = scale * rad / L * torch.exp(-rad / L * b) * a
        f_rad = scale * (1 - rad / L) * torch.exp(-rad / L * d) * c
        fx = -torch.sin(phi) * f_phi + torch.cos(phi) * f_rad
        fy = torch.cos(phi) * f_phi + torch.sin(phi) * f_rad
        return torch.stack([fx, fy])

    return f


def quadratic_cos2_potential(a, b, c, x0):
    """The GPE suites' random potential family ``V(x) = a (x - x0)^2 + b cos^2(c (x - x0))``."""

    def v(x):
        return a * (x - x0) ** 2 + b * torch.cos(c * (x - x0)) ** 2

    return v
