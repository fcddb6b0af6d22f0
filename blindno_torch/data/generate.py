"""Dataset generation for every suite (counterpart of ``blindno/data/generate.py``).

The parameters are drawn on the host with numpy, call for call as the JAX package draws
them (the rejection sampling of the well centers, one ``rng.choice`` per set, the order
of every draw), so ``np.random.default_rng(seed)`` gives the same sets and the
parameter arrays (``potential``, ``drag``, ``F``, ``V``, ``time``, ``grid``) equal the
JAX package's bit for bit. The grid is float32 as JAX has it. The PDE solves run on
``device`` (CUDA unless the caller passes another) in batches, and the archives keep the
JAX package's npz keys:

- FPE suites: ``time, grid, trajectories, potential, drag`` (``F`` in place of the
  last two for ncfpe2d);
- GPE suites: ``y, g, kappa, V``.
"""
from __future__ import annotations

import numpy as np
import torch

from blindno_torch import default_device
from blindno_torch.solvers import gpe as gpe_solver
from blindno_torch.solvers.fokker_planck import KB, grid_from_extent, propagate_expm

NM = 1e-9
VISCOSITY = 8e-4
RADIUS = 50 * NM
BASE_DRAG = 6 * np.pi * VISCOSITY * RADIUS
TEMPERATURE = 300.0
BETA = 1.0 / (KB * TEMPERATURE)
NC_MASS_TOL = 1e-2  # the ncfpe2d archive's largest |mass - 1| per snapshot


def f32(a, device):
    """An array (or tensor) as a float32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


def _axes(extent, resolution):
    """The float32 grid axes as numpy vectors (``grid_from_extent`` on the CPU)."""
    return [a.numpy() for a in grid_from_extent(extent, resolution)]


def _snapshot_times(rng, m, nsteps, n_snapshots, tf):
    """Each set's sorted random snapshot indices into ``linspace(0, tf, nsteps)``, one
    ``rng.choice`` per set: (full time grid, indices (M, n), their times (M, n))."""
    full_time = np.linspace(0.0, tf, nsteps)
    sel = np.stack([np.sort(rng.choice(nsteps, size=n_snapshots, replace=False))
                    for _ in range(m)])
    return full_time, sel, full_time[sel]


def _rollouts(m, batch, solve):
    """``solve(s, e)`` -> the trajectories of sets [s, e) as a tensor, over the batches;
    concatenated on the host."""
    return np.concatenate([solve(s, min(s + batch, m)).cpu().numpy()
                           for s in range(0, m, batch)])


def _selected(pt, sel, dev):
    """pt (B, nsteps, N) -> the snapshots at ``sel`` (B, n)."""
    idx = torch.as_tensor(sel, device=dev)
    return pt.gather(1, idx[..., None].expand(*idx.shape, pt.shape[-1]))


# ------------------------------------------------------------------ 1D FPE

def _sample_wells_1d(rng, n_wells=3, lo=-150 * NM, hi=150 * NM, min_dist=80 * NM):
    """Rejection-sample well centers more than ``min_dist`` apart."""
    while True:
        centers = rng.uniform(lo, hi, size=n_wells)
        if all(
            abs(centers[i] - centers[j]) > min_dist
            for i in range(n_wells)
            for j in range(i + 1, n_wells)
        ):
            return centers


def sample_fpe1d_params(rng, m):
    centers = np.stack([_sample_wells_1d(rng) for _ in range(m)])  # (M, 3)
    widths = rng.uniform(20 * NM, 80 * NM, size=(m, 3))
    amps = rng.uniform(1e-20, 2e-20, size=(m, 3))
    visc = rng.uniform(1.0, 2.0, size=(m, 1))
    return centers, widths, amps * visc, BASE_DRAG * visc[:, 0]


def _wells_on_grid(x, centers, widths, amps):
    """U(x) = -sum_i A_i exp(-((x - c_i)/w_i)^2), batched: (M, 3) params -> (M, Nx)."""
    d = (x[None, None, :] - centers[:, :, None]) / widths[:, :, None]
    return -(amps[:, :, None] * np.exp(-(d**2))).sum(axis=1)


def generate_fpe1d(seed: int, m: int, n_snapshots: int = 100, tf: float = 2e-3,
                   nsteps: int = 400, resolution: float = 10 * NM, extent: float = 800 * NM,
                   init_width: float = 50 * NM, batch: int = 64, store_pt: bool = False,
                   device=None):
    """The 1-D FPE drift-diffusion archive: one ``expm`` of the per-step propagator and
    a rollout over the uniform output grid per set, then each set's random snapshots.
    ``store_pt=True`` also stores the full trajectory over all ``nsteps`` times as
    ``Pt`` (M, nsteps, Nx) and ``time_full``, the reference's evaluation format."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    x = _axes(extent, resolution)[0]
    centers, widths, amps, drags = sample_fpe1d_params(rng, m)
    u = _wells_on_grid(x, centers, widths, amps)  # (M, Nx)
    full_time, sel, times = _snapshot_times(rng, m, nsteps, n_snapshots, tf)
    p0 = np.exp(-((x / init_width) ** 2))
    p0 = p0 / p0.sum()
    diff = KB * TEMPERATURE / drags  # (M,)
    fulls = []

    def solve(s, e):
        u_b = f32(u[s:e], dev)
        pt = propagate_expm(u_b, f32(diff[s:e], dev)[:, None] * torch.ones_like(u_b),
                            resolution, BETA, f32(p0, dev), f32(full_time, dev))
        if store_pt:
            fulls.append(pt.cpu().numpy())
        return _selected(pt, sel[s:e], dev)

    trajectories = _rollouts(m, batch, solve)  # (M, n_snapshots, Nx)
    d = {
        "time": times,
        "grid": np.broadcast_to(x, (m, x.shape[0])).copy(),
        "trajectories": trajectories,
        "potential": u,
        "drag": drags,
    }
    if store_pt:
        d["Pt"] = np.concatenate(fulls)
        d["time_full"] = np.broadcast_to(full_time, (m, nsteps)).copy()
    return d


# ------------------------------------------------------------------ 2D FPE

def sample_fpe2d_params(rng, m):
    centers = []
    for _ in range(m):
        while True:
            c = rng.uniform(-100 * NM, 100 * NM, size=(3, 2))
            dist = np.sqrt(((c[:, None] - c[None, :]) ** 2).sum(-1))
            if np.all(dist[np.triu_indices(3, k=1)] > 90 * NM):
                break
        centers.append(c)
    centers = np.stack(centers)  # (M, 3, 2)
    widths = rng.uniform(20 * NM, 80 * NM, size=(m, 3))
    amps = rng.uniform(1e-20, 2e-20, size=(m, 3))
    visc = rng.uniform(0.0, 2.0, size=(m,))
    diff_centers = rng.uniform(-100 * NM, 100 * NM, size=(m, 2))
    return centers, widths, amps, visc, diff_centers


def generate_fpe2d(seed: int, m: int, n_snapshots: int = 100, tf: float = 2e-4,
                   nsteps: int = 1000, resolution: float = 10 * NM,
                   extent=(600 * NM, 600 * NM), init_width: float = 50 * NM, batch: int = 8,
                   device=None):
    """The 2-D FPE archive with a space-varying drag: three Gaussian wells and
    ``gamma(x, y) = drag * (1 + v xs^2 + v ys^2)`` per set."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    axes = _axes(extent, resolution)
    gx, gy = np.meshgrid(axes[0], axes[1], indexing="ij")
    centers, widths, amps, visc, diff_centers = sample_fpe2d_params(rng, m)

    d2 = ((gx[None, None] - centers[:, :, 0, None, None]) ** 2
          + (gy[None, None] - centers[:, :, 1, None, None]) ** 2)
    u = -(amps[:, :, None, None] * np.exp(-d2 / widths[:, :, None, None] ** 2)).sum(axis=1)
    # gamma(x, y) = drag * (1 + vf * xs^2 + vf * ys^2), xs = (x - dcx)/250nm
    xs = (gx[None] - diff_centers[:, 0, None, None]) / (250 * NM)
    ys = (gy[None] - diff_centers[:, 1, None, None]) / (250 * NM)
    gamma = BASE_DRAG * (1.0 + visc[:, None, None] * xs**2 + visc[:, None, None] * ys**2)
    diff = KB * TEMPERATURE / gamma  # (M, Nx, Ny)
    full_time, sel, times = _snapshot_times(rng, m, nsteps, n_snapshots, tf)
    p0 = np.exp(-((gx / init_width) ** 2) - ((gy / init_width) ** 2))
    p0 = (p0 / p0.sum()).ravel()

    def solve(s, e):
        pt = propagate_expm(f32(u[s:e], dev), f32(diff[s:e], dev), resolution, BETA,
                            f32(p0, dev), f32(full_time, dev))
        return _selected(pt, sel[s:e], dev).reshape(e - s, n_snapshots, *gx.shape)

    trajectories = _rollouts(m, batch, solve)
    grid = np.stack([gx, gy])  # (2, Nx, Ny)
    return {
        "time": times,
        "grid": np.broadcast_to(grid, (m,) + grid.shape).copy(),
        "trajectories": trajectories,
        "potential": u,
        "drag": gamma,
    }


# ------------------------------------------------------------------ 2D non-conservative FPE

def sample_ncfpe2d_params(rng, m):
    return {
        "L": rng.uniform(50 * NM, 150 * NM, size=m),
        "a": rng.uniform(0.5, 2.0, size=m),
        "b": rng.uniform(0.5, 2.0, size=m),
        "c": rng.uniform(0.5, 2.0, size=m),
        "d": rng.uniform(0.5, 2.0, size=m),
    }


def _spiral_on_grid(gx, gy, p):
    """(M,) params -> F (M, 2, Nx, Ny), the spiral force of each set."""
    rad = np.sqrt(gx**2 + gy**2)[None]
    phi = np.arctan2(gy, gx)[None]
    L = p["L"][:, None, None]
    f_phi = 1e-12 * rad / L * np.exp(-rad / L * p["b"][:, None, None]) * p["a"][:, None, None]
    f_rad = 1e-12 * (1 - rad / L) * np.exp(-rad / L * p["d"][:, None, None]) * p["c"][:, None, None]
    fx = -np.sin(phi) * f_phi + np.cos(phi) * f_rad
    fy = np.cos(phi) * f_phi + np.sin(phi) * f_rad
    return np.stack([fx, fy], axis=1)


def generate_ncfpe2d(seed: int, m: int, n_snapshots: int = 100, tf: float = 10e-3,
                     nsteps: int = 500, resolution: float = 10 * NM,
                     extent=(800 * NM, 800 * NM), init_center=(-150 * NM, -150 * NM),
                     init_width: float = 30 * NM, batch: int = 2, device=None,
                     dtype=torch.float32):
    """The 2-D FPE driven by a non-conservative spiral force. Each batch's snapshot
    masses are checked: a drift beyond ``NC_MASS_TOL`` raises ``RuntimeError`` at once.
    ``dtype=torch.float64`` solves in float64 (the float32 archive's reference)."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    axes = _axes(extent, resolution)
    gx, gy = np.meshgrid(axes[0], axes[1], indexing="ij")
    params = sample_ncfpe2d_params(rng, m)
    f = _spiral_on_grid(gx, gy, params)  # (M, 2, Nx, Ny)
    u = np.zeros((m,) + gx.shape)
    diff = KB * TEMPERATURE / BASE_DRAG
    full_time, sel, times = _snapshot_times(rng, m, nsteps, n_snapshots, tf)
    p0 = np.exp(-(((gx - init_center[0]) / init_width) ** 2)
                - (((gy - init_center[1]) / init_width) ** 2))
    p0 = (p0 / p0.sum()).ravel()
    as_t = lambda a: f32(a, dev).to(dtype)

    def solve(s, e):
        pt = propagate_expm(as_t(u[s:e]), diff, resolution, BETA, as_t(p0), as_t(full_time),
                            force=as_t(f[s:e]))
        out = _selected(pt, sel[s:e], dev).reshape(e - s, n_snapshots, *gx.shape)
        # the propagator is a truncated matmul series: a solver fault shows as mass drift,
        # caught in the first batch rather than after the whole archive
        mass_dev = float((out.sum(dim=(2, 3)) - 1.0).abs().max())
        if not mass_dev <= NC_MASS_TOL:
            raise RuntimeError(f"NC datagen mass drift {mass_dev:.3e} (> {NC_MASS_TOL}) in "
                               f"samples [{s}:{e}); solver regression")
        return out

    trajectories = _rollouts(m, batch, solve)
    grid = np.stack([gx, gy])
    return {
        "time": times,
        "grid": np.broadcast_to(grid, (m,) + grid.shape).copy(),
        "trajectories": trajectories,
        "F": f,
    }


# ------------------------------------------------------------------ 1D GPE / Schrodinger

def generate_gpe1d(seed: int, num_orbits: int, g: float, kappa: float, nx: int = 128,
                   dt: float = 0.005, t_final: float = 5.0, stride: int = 10,
                   batch: int = 256, device=None):
    """The Schrodinger (g = kappa = 0) or GPE (g = kappa = 2) orbit archive: |psi| every
    ``stride`` steps, ``nt // stride + 1`` = 101 snapshots per orbit (the reference's
    random indices are drawn by it and ignored)."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    x = np.linspace(-10.0, 10.0, nx)
    nt = int(t_final / dt) + 1
    a = rng.uniform(0.1, 0.3, size=num_orbits)
    b = rng.uniform(0.5, 2.0, size=num_orbits)
    c = rng.uniform(0.5, 2.0, size=num_orbits)
    x0 = rng.uniform(-3.0, 3.0, size=num_orbits)
    v = (a[:, None] * (x[None] - x0[:, None]) ** 2
         + b[:, None] * np.cos(c[:, None] * (x[None] - x0[:, None])) ** 2)
    xt = f32(x, dev)
    psi0 = gpe_solver.get_initial_condition(2, xt)

    def solve(s, e):
        rec = gpe_solver.solve_gpe(psi0, xt, dt, nt, g, kappa, f32(v[s:e], dev))
        return torch.abs(rec[:, ::stride])

    y = _rollouts(num_orbits, batch, solve)  # (M, nt // stride + 1, Nx)
    return {
        "y": y,
        "g": np.full(num_orbits, float(g)),
        "kappa": np.full(num_orbits, float(kappa)),
        "V": v,
    }
