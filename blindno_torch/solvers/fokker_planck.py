"""The Fokker-Planck (Smoluchowski) solver as a detailed-balance master equation
(counterpart of ``blindno/solvers/fokker_planck.py``), on tensors.

The continuum operator ``dp/dt = div(D (grad p + beta p grad U))`` becomes a lattice
master equation with the hopping rates

    w(n -> n+e_i) = D_bond / h^2 * exp(-beta * dU_bond / 2)
    w(n+e_i -> n) = D_bond / h^2 * exp(+beta * dU_bond / 2)

where ``dU_bond = U[n+e_i] - U[n] - W_bond`` and ``W_bond`` is the trapezoid work of a
non-conservative force along the bond; reflecting boundaries are absent bonds. The
generator is a dense (N, N) matrix (N <= 6400 cells).

Where the JAX package ``vmap``s a per-sample function, these functions take a leading
batch axis: potentials (B, n1[, n2]), propagators (B, N, N), trajectories (B, Nt, N).
Their matrix products run in full float32 (or float64): the solver turns TF32 off for
its own products (:func:`full_precision`), as JAX multiplies at ``Precision.HIGHEST``.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from blindno_torch import default_device

KB = 1.380649e-23  # Boltzmann constant, J/K (scipy.constants.k)


@contextlib.contextmanager
def full_precision():
    """TF32 off for CUDA matrix products inside the block, restored after it. TF32
    leaves the propagator's columns about 1% off after a rollout, which a 500-step
    rollout amplifies (``blindno/solvers/fokker_planck.py:158-163``)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def grid_from_extent(extent, resolution, dtype=torch.float32, device=None):
    """fplanck's grid: ``ceil(extent / resolution)`` cells per axis, centered on the
    origin (800nm/10nm -> 80, 600nm/10nm -> 61). A list of per-axis coordinate vectors,
    computed in float64 and rounded to ``dtype`` (float32, as JAX without x64 has
    them)."""
    axes = []
    for ext in np.atleast_1d(extent).astype(np.float64):
        n = int(np.ceil(ext / resolution))
        axes.append(torch.tensor((np.arange(n) - (n - 1) / 2.0) * resolution, dtype=dtype,
                                 device=device))
    return axes


def _per_sample(value, like):
    """A scalar, a (B,) vector (one value per sample) or a (B, *grid) field, as a
    tensor broadcastable to ``like`` (B, *grid)."""
    t = torch.as_tensor(value, dtype=like.dtype, device=like.device)
    if t.dim() == 1:
        t = t.reshape(-1, *([1] * (like.dim() - 1)))
    return t.expand_as(like)


def build_generator(potential, diffusion, resolution, beta, force=None):
    """Dense master-equation generators M with dp/dt = M p (reflecting boundaries).

    potential: (B, n1[, n2]) energy per cell [J]; diffusion: a scalar, (B,) or a
    (B, n1[, n2]) field [m^2/s]; force: None or (B, ndim, n1[, n2]) [N], which adds -W
    to the bond's dU. Returns (B, N, N), N = prod(grid), row-major cells. The bonds'
    rates go in by scatter-adds (``index_add_``), per axis in JAX's order.
    """
    b, *shape = potential.shape
    ndim, n = len(shape), math.prod(shape)
    diff = _per_sample(diffusion, potential)
    flat_index = torch.arange(n, device=potential.device).reshape(shape)
    m = torch.zeros(b, n * n, dtype=potential.dtype, device=potential.device)
    h = resolution
    for axis in range(ndim):
        lo = [slice(None)] * ndim
        hi = [slice(None)] * ndim
        lo[axis], hi[axis] = slice(0, shape[axis] - 1), slice(1, shape[axis])
        lo, hi = tuple(lo), tuple(hi)
        du = potential[(slice(None),) + hi] - potential[(slice(None),) + lo]
        if force is not None:
            fa = force[:, axis]
            du = du - 0.5 * (fa[(slice(None),) + hi] + fa[(slice(None),) + lo]) * h
        d_bond = 0.5 * (diff[(slice(None),) + hi] + diff[(slice(None),) + lo])
        rate = d_bond / (h * h)
        up = (rate * torch.exp(-beta * du / 2.0)).reshape(b, -1)  # n -> n+1
        dn = (rate * torch.exp(beta * du / 2.0)).reshape(b, -1)  # n+1 -> n
        src, dst = flat_index[lo].reshape(-1), flat_index[hi].reshape(-1)
        m.index_add_(1, dst * n + src, up)
        m.index_add_(1, src * n + src, -up)
        m.index_add_(1, src * n + dst, dn)
        m.index_add_(1, dst * n + dst, -dn)
    return m.reshape(b, n, n)


def propagate_eigh(potential, diffusion, resolution, beta, p0, times):
    """Exact propagation at all ``times`` by one symmetric eigendecomposition, for
    conservative problems (no force; space-varying diffusion allowed). p0: (N,) or
    (B, N), each summing to 1; times: (Nt,). Returns (B, Nt, N)."""
    with full_precision():
        m = build_generator(potential, diffusion, resolution, beta)
        b = m.shape[0]
        u_half = (beta * potential.reshape(b, -1) / 2.0).to(m.dtype)
        u_half = u_half - u_half.min(dim=1, keepdim=True).values  # gauge: no overflow in exp
        s_inv, s = torch.exp(u_half), torch.exp(-u_half)  # pi^{-1/2}, pi^{+1/2} up to constants
        sym = (s_inv[:, :, None] * m) * s[:, None, :]
        sym = 0.5 * (sym + sym.transpose(1, 2))  # exact symmetry before eigh
        lam, v = torch.linalg.eigh(sym)
        # a generator is negative semidefinite: the clamp kills float32 eigenvalue noise
        # that would grow as exp(+eps t)
        lam = lam.clamp_max(0.0)
        q0 = (v.transpose(1, 2) @ (s_inv * p0)[..., None])[..., 0]  # (B, N)
        evol = torch.exp(times[None, :, None] * lam[:, None, :]) * q0[:, None, :]
        return (evol @ v.transpose(1, 2)) * s[:, None, :]


def expm_markov(m, dt, tail_sigmas: float = 10.0, max_terms: int = 1024, squarings: int = 4):
    """Matmul-only ``expm(m * dt)`` for Markov generators m (B, N, N), by
    uniformization: ``e^{M dt} = e^{-a} sum_k a^k/k! P^k`` with ``P = I + M/lam`` and
    ``a = lam dt / 2^squarings``, then ``squarings`` squarings.

    Each sample sums its own ``n_terms = min(a + tail_sigmas sqrt(a) + tail_sigmas,
    max_terms)`` terms: the loop runs to the batch's largest count, and a sample's sum
    stays as it is once its own count is reached (JAX's ``while_loop`` under ``vmap``).
    A sample whose tail bound exceeds ``max_terms`` comes out all NaN, never as a
    renormalized wrong answer. The columns are renormalized to sum to 1 after the series
    and after each squaring, so rollouts conserve mass. Products in full precision.
    """
    with full_precision():
        b, n, _ = m.shape
        eye = torch.eye(n, dtype=m.dtype, device=m.device).expand(b, n, n)
        lam = (-m.diagonal(dim1=1, dim2=2)).amax(1) * (1.0 + 1e-6) + torch.tensor(
            1e-300, dtype=m.dtype, device=m.device)
        a = lam * dt / (2.0 ** squarings)
        p = eye + m / lam[:, None, None]
        max_f = torch.tensor(float(max_terms), dtype=m.dtype, device=m.device)
        need = a + tail_sigmas * torch.sqrt(a) + tail_sigmas
        n_terms = torch.minimum(need, max_f)
        # k = 0, 1, ... while k < n_terms: ceil(n_terms) terms (none for a NaN count)
        n_iter = int(torch.ceil(n_terms).nan_to_num(0.0).max())
        pk, acc, w = eye, torch.zeros_like(m), torch.exp(-a)
        for k in range(n_iter):
            active = (k < n_terms)[:, None, None]
            acc = torch.where(active, acc + w[:, None, None] * pk, acc)
            if k + 1 < n_iter:
                pk = p @ pk
            w = w * a / (k + 1.0)
        acc = torch.where((need <= max_f)[:, None, None], acc, torch.full_like(acc, math.nan))
        acc = acc / acc.sum(1, keepdim=True)
        for _ in range(squarings):
            acc = acc @ acc
            acc = acc / acc.sum(1, keepdim=True)
        return acc


# Pade coefficients b_0..b_m of degree m (Higham 2005), as jax.scipy.linalg.expm has them
_PADE = {
    3: (120., 60., 12., 1.),
    5: (30240., 15120., 3360., 420., 30., 1.),
    7: (17297280., 8648640., 1995840., 277200., 25200., 1512., 56., 1.),
    9: (17643225600., 8821612800., 2075673600., 302702400., 30270240., 2162160., 110880.,
        3960., 90., 1.),
    13: (64764752532480000., 32382376266240000., 7771770303897600., 1187353796428800.,
         129060195264000., 10559470521600., 670442572800., 33522128640., 1323241920.,
         40840800., 960960., 16380., 182., 1.),
}
# per dtype: the largest scaled 1-norm, the 1-norm bounds between degrees, the degrees
_PADE_RULES = {
    torch.float32: (3.925724783138660, (4.258730016922831e-001, 1.880152677804762e+000),
                    (3, 5, 7)),
    torch.float64: (5.371920351148152, (1.495585217958292e-002, 2.539398330063230e-001,
                                        9.504178996162932e-001, 2.097847961257068e+000),
                    (3, 5, 7, 9, 13)),
}


def _pade_uv(a, degree):
    """The odd part U and the even part V of the degree-``degree`` Pade approximant,
    summed in ``jax.scipy.linalg``'s order."""
    b = _PADE[degree]
    ident = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    a2 = a @ a
    a4 = a2 @ a2
    if degree == 3:
        return a @ (b[3] * a2 + b[1] * ident), b[2] * a2 + b[0] * ident
    if degree == 5:
        return a @ (b[5] * a4 + b[3] * a2 + b[1] * ident), b[4] * a4 + b[2] * a2 + b[0] * ident
    a6 = a4 @ a2
    if degree == 7:
        return (a @ (b[7] * a6 + b[5] * a4 + b[3] * a2 + b[1] * ident),
                b[6] * a6 + b[4] * a4 + b[2] * a2 + b[0] * ident)
    if degree == 9:
        a8 = a6 @ a2
        return (a @ (b[9] * a8 + b[7] * a6 + b[5] * a4 + b[3] * a2 + b[1] * ident),
                b[8] * a8 + b[6] * a6 + b[4] * a4 + b[2] * a2 + b[0] * ident)
    u = a @ (a6 @ (b[13] * a6 + b[11] * a4 + b[9] * a2)
             + b[7] * a6 + b[5] * a4 + b[3] * a2 + b[1] * ident)
    v = (a6 @ (b[12] * a6 + b[10] * a4 + b[8] * a2)
         + b[6] * a6 + b[4] * a4 + b[2] * a2 + b[0] * ident)
    return u, v


def expm(a, max_squarings: int = 16):
    """``jax.scipy.linalg.expm`` on a batch a (B, N, N): Pade scaling and squaring, each
    sample with its own squarings ``max(0, floor(log2(|a|_1 / maxnorm)))`` and its own
    degree by its 1-norm (3, 5 or 7 in float32; up to 13 in float64), then
    ``solve(Q, P)`` and the squarings. Products in full precision."""
    maxnorm, bounds, degrees = _PADE_RULES[a.dtype]
    with full_precision():
        norm1 = a.abs().sum(1).amax(1)  # the largest column sum
        n_sq = torch.floor(torch.log2(norm1 / maxnorm)).clamp_min(0.0)
        scaled = a / (2.0 ** n_sq)[:, None, None]
        which = torch.bucketize(norm1, torch.tensor(bounds, dtype=a.dtype, device=a.device),
                                right=True)
        u, v = torch.empty_like(a), torch.empty_like(a)
        for i in which.unique().tolist():
            rows = (which == i).nonzero()[:, 0]
            u[rows], v[rows] = _pade_uv(scaled[rows], degrees[i])
        r = torch.linalg.solve(v - u, u + v)
        for i in range(min(int(n_sq.max()), max_squarings)):
            r = torch.where((i < n_sq)[:, None, None], r @ r, r)
        return r


# the generator size from which the JAX package takes expm_markov (its Pade expm's LU
# block broke the TPU's scoped-memory limit above it); kept so that both run the same
# algorithm at each size
_EXPM_MARKOV_MIN_N = 4096


def propagate_expm(potential, diffusion, resolution, beta, p0, times, force=None):
    """Propagation by one dense ``expm`` of the per-step propagator and a rollout of
    matrix-vector products. ``times`` (Nt,) uniformly spaced from 0 (fplanck's
    ``propagate_interval`` grid); non-conservative forces allowed. Generators of N >=
    4096 cells (the 80x80 ncfpe2d grid) take :func:`expm_markov`, smaller ones the Pade
    :func:`expm`. p0: (N,) or (B, N). Returns (B, Nt, N)."""
    with full_precision():
        m = build_generator(potential, diffusion, resolution, beta, force=force)
        dt = times[1] - times[0]
        if m.shape[-1] >= _EXPM_MARKOV_MIN_N:
            prop = expm_markov(m, dt)
        else:
            prop = expm(m * dt)
        p = p0.to(m.dtype).expand(m.shape[0], m.shape[-1])[..., None]
        out = [p]
        for _ in range(times.shape[0] - 1):
            p = prop @ p
            out.append(p)
        return torch.cat(out, dim=2).transpose(1, 2)


@dataclass
class FokkerPlanck:
    """fplanck's facade (``fokker_planck(...)`` in the reference): ``drag`` a scalar or a
    callable gamma(*grid), ``potential`` a callable U(*grid), ``force`` a callable
    returning (ndim, *grid); reflecting boundaries only. ``dtype`` float32 by default
    (float64 on request), on ``device`` (the card unless the CPU is asked for)."""

    temperature: float
    drag: float | Callable
    extent: float | Sequence[float]
    resolution: float
    boundary: str = "reflecting"
    potential: Callable | None = None
    force: Callable | None = None
    dtype: torch.dtype = torch.float32
    device: str | torch.device | None = None

    def __post_init__(self):
        if self.boundary != "reflecting":
            raise NotImplementedError("only reflecting boundaries are supported (as used by the reference)")
        self.device = default_device(self.device)
        self.axes = grid_from_extent(self.extent, self.resolution, self.dtype, self.device)
        coords = torch.meshgrid(*self.axes, indexing="ij")
        self.grid = torch.stack(coords) if len(self.axes) > 1 else coords[0].reshape(1, -1)
        self.ndim = len(self.axes)
        self.beta = 1.0 / (KB * self.temperature)
        u = (self.potential(*coords) if self.potential is not None
             else torch.zeros(coords[0].shape, dtype=self.dtype, device=self.device))
        self.potential_values = torch.as_tensor(u, dtype=self.dtype, device=self.device)
        gamma = self.drag(*coords) if callable(self.drag) else self.drag
        self.diffusion = (KB * self.temperature / torch.as_tensor(
            gamma, dtype=self.dtype, device=self.device)) * torch.ones_like(self.potential_values)
        self.force_values = (torch.as_tensor(self.force(*coords), dtype=self.dtype,
                                             device=self.device)
                             if self.force is not None else None)

    def propagate_interval(self, pdf, tf, Nsteps, normalize=True):
        """Evolve over [0, tf] and return the ``Nsteps`` states at ``linspace(0, tf,
        Nsteps)``: (time (Nsteps,), Pt (Nsteps, *grid))."""
        coords = torch.meshgrid(*self.axes, indexing="ij")
        p0 = torch.as_tensor(pdf(*coords), dtype=self.dtype, device=self.device).reshape(-1)
        if normalize:
            p0 = p0 / p0.sum()
        times = torch.linspace(0.0, tf, Nsteps, dtype=self.dtype, device=self.device)
        args = (self.potential_values[None], self.diffusion[None], self.resolution, self.beta,
                p0, times)
        if self.force_values is None:
            pt = propagate_eigh(*args)
        else:
            pt = propagate_expm(*args, force=self.force_values[None])
        return times, pt[0].reshape((Nsteps,) + tuple(self.potential_values.shape))


# alias matching the reference's import name
fokker_planck = FokkerPlanck


class boundary:  # noqa: N801 - fplanck API parity
    reflecting = "reflecting"
    periodic = "periodic"
