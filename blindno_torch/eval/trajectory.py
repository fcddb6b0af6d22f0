"""Density and wavefunction trajectories from given (true or predicted) coefficients,
the data of the figures (counterpart of ``blindno/eval/trajectory.py``): each rolls out
one set of coefficients on the reference's rollout grid and returns numpy
``(times, Pt)``. They run on ``device`` (CUDA unless the caller passes another)."""
from __future__ import annotations

import numpy as np
import torch

from blindno_torch import default_device
from blindno_torch.data.generate import BASE_DRAG, BETA, KB, NM, TEMPERATURE, f32
from blindno_torch.solvers import gpe as gpe_solver
from blindno_torch.solvers.fokker_planck import grid_from_extent, propagate_expm


def gaussian_p0(extent, resolution, init_center, init_width):
    """The normalized Gaussian initial density on the float32 grid, flattened, float32,
    and the grid's axes (numpy)."""
    axes = [a.numpy() for a in grid_from_extent(extent, resolution)]
    mesh = np.meshgrid(*axes, indexing="ij")
    p0 = np.exp(-sum(((c - c0) / init_width) ** 2 for c, c0 in zip(mesh, init_center)))
    return (p0 / p0.sum()).ravel().astype(np.float32), axes


def _shape(axes):
    return tuple(len(a) for a in axes)


def fpe1d_trajectory(u, drag, *, tf: float = 2e-3, nsteps: int = 400,
                     extent: float = 800 * NM, resolution: float = 10 * NM,
                     init_center: float = 0.0, init_width: float = 50 * NM, device=None):
    """(time (Nt,), Pt (Nt, Nx)) for one potential and scalar drag (a Gaussian initial
    density at ``init_center``, width 50nm)."""
    dev = default_device(device)
    p0, _ = gaussian_p0(extent, resolution, (init_center,), init_width)
    times = torch.linspace(0.0, tf, nsteps, device=dev)
    u_t = f32(u, dev)
    pt = propagate_expm(u_t[None], (KB * TEMPERATURE / drag * torch.ones_like(u_t))[None],
                        resolution, BETA, f32(p0, dev), times)
    return times.cpu().numpy(), pt[0].cpu().numpy()


def fpe2d_trajectory(u, gamma, *, tf: float = 2e-4, nsteps: int = 1000,
                     extent=(600 * NM, 600 * NM), resolution: float = 10 * NM,
                     init_center=(0.0, 0.0), init_width: float = 50 * NM,
                     clamp_potential: bool = True, device=None):
    """The 2-D rollout; ``clamp_potential`` sets ``U >= 0`` to 0 first, as the
    reference's ``2d_FPE/cal_traj.py:131`` does."""
    dev = default_device(device)
    p0, axes = gaussian_p0(extent, resolution, init_center, init_width)
    u = np.asarray(u, np.float32).copy()
    if clamp_potential:
        u[u >= 0] = 0.0
    times = torch.linspace(0.0, tf, nsteps, device=dev)
    pt = propagate_expm(f32(u, dev)[None], (KB * TEMPERATURE / f32(gamma, dev))[None],
                        resolution, BETA, f32(p0, dev), times)
    return times.cpu().numpy(), pt[0].cpu().numpy().reshape(nsteps, *_shape(axes))


def ncfpe2d_trajectory(f, *, tf: float = 10e-3, nsteps: int = 500,
                       extent=(800 * NM, 800 * NM), resolution: float = 10 * NM,
                       init_center=(-150 * NM, -150 * NM), init_width: float = 30 * NM,
                       device=None):
    """The force-driven rollout of one force field f (2, Nx, Ny) at the fixed drag."""
    dev = default_device(device)
    p0, axes = gaussian_p0(extent, resolution, init_center, init_width)
    times = torch.linspace(0.0, tf, nsteps, device=dev)
    zero_u = torch.zeros((1,) + _shape(axes), device=dev)
    pt = propagate_expm(zero_u, KB * TEMPERATURE / BASE_DRAG, resolution, BETA, f32(p0, dev),
                        times, force=f32(f, dev)[None])
    return times.cpu().numpy(), pt[0].cpu().numpy().reshape(nsteps, *_shape(axes))


def gpe_trajectory(v, g: float, kappa: float, *, nx: int = 128, dt: float = 0.005,
                   t_final: float = 5.0, ic: int = 2, device=None):
    """(time, |psi| (Nt, Nx)) for one potential at the given g and kappa."""
    dev = default_device(device)
    x = torch.linspace(-10.0, 10.0, nx, device=dev)
    nt = int(round(t_final / dt)) + 1
    psi0 = gpe_solver.get_initial_condition(ic, x)
    rec = gpe_solver.solve_gpe(psi0, x, dt, nt, g, kappa, f32(v, dev))
    return np.linspace(0.0, t_final, nt), torch.abs(rec).cpu().numpy()
