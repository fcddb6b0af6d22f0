"""The solution-space metric (counterpart of ``blindno/eval/time_error.py``): re-solve the
PDE with the predicted coefficients and compare the density (or |psi|) trajectories,

    Err = (1/T) * integral_0^T ||rho_pred(., t) - rho_ref(., t)||_2 / ||rho_ref(., t)||_2 dt

with trapezoid rules in space (the L2 norms) and in time. The rollouts run on
``device`` (CUDA unless the caller passes another), batched over the samples.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from blindno_torch import default_device
from blindno_torch.data.generate import BASE_DRAG, BETA, KB, NM, TEMPERATURE, f32
from blindno_torch.eval.trajectory import gaussian_p0
from blindno_torch.solvers import gpe as gpe_solver
from blindno_torch.solvers.fokker_planck import propagate_expm


def time_averaged_rel_l2(rho_ref, rho_pred, x_axes, times, eps: float = 1e-12):
    """rho_*: (..., Nt, *grid); x_axes: one coordinate vector per grid axis; times
    (Nt,). The squared norms by the trapezoid rule over each grid axis in turn, the
    relative errors' trapezoid average over time. Returns (...)."""
    sq_diff, sq_ref = (rho_pred - rho_ref) ** 2, rho_ref**2
    axis = rho_ref.dim() - len(x_axes)  # each integration moves the next axis here
    for coords in x_axes:
        sq_diff = torch.trapezoid(sq_diff, x=coords, dim=axis)
        sq_ref = torch.trapezoid(sq_ref, x=coords, dim=axis)
    rel = torch.sqrt(sq_diff.clamp_min(0.0)) / (torch.sqrt(sq_ref.clamp_min(0.0)) + eps)
    dt = torch.diff(times)
    integral = (0.5 * (rel[..., :-1] + rel[..., 1:]) * dt).sum(-1)
    return integral / (times[-1] - times[0])


def _gaussian_p0(extent, resolution, init_center, init_width, dev):
    p0, axes = gaussian_p0(extent, resolution, init_center, init_width)
    return torch.tensor(p0, device=dev), [torch.tensor(a, device=dev) for a in axes]


def _batched(n, batch, fn):
    return torch.cat([fn(s, min(s + batch, n)) for s in range(0, n, batch)])


# ------------------------------------------------------------------ 1D FPE

def fpe1d_rollout_error(u_true, drag_true, u_pred, drag_pred, *, tf: float = 2e-3,
                        nsteps: int = 400, extent: float = 800 * NM,
                        resolution: float = 10 * NM, init_width: float = 50 * NM, device=None):
    """u_* (M, Nx), drag_* (M,), as arrays or tensors. Returns (M,) errors (numpy)."""
    dev = default_device(device)
    p0, axes = _gaussian_p0(extent, resolution, (0.0,), init_width, dev)
    times = torch.linspace(0.0, tf, nsteps, device=dev)
    rho = []
    for u, d in ((u_true, drag_true), (u_pred, drag_pred)):
        u = f32(u, dev)
        diff = KB * TEMPERATURE / f32(d, dev)[:, None] * torch.ones_like(u)
        rho.append(propagate_expm(u, diff, resolution, BETA, p0, times))
    return time_averaged_rel_l2(*rho, axes, times).cpu().numpy()


# ------------------------------------------------------------------ 2D FPE

def fpe2d_rollout_error(u_true, gamma_true, u_pred, gamma_pred, *, tf: float = 2e-4,
                        nsteps: int = 1000, extent=(600 * NM, 600 * NM),
                        resolution: float = 10 * NM, init_width: float = 50 * NM,
                        batch: int = 4, device=None):
    """args (M, Nx, Ny); ``batch`` samples at a time. nsteps=1000 is the reference's
    recorded time grid (``2d_FPE/cal_traj.py:150-151``). Returns (M,) errors."""
    dev = default_device(device)
    p0, axes = _gaussian_p0(extent, resolution, (0.0, 0.0), init_width, dev)
    times = torch.linspace(0.0, tf, nsteps, device=dev)

    def errs(s, e):
        rho = [propagate_expm(f32(u[s:e], dev), KB * TEMPERATURE / f32(g[s:e], dev),
                              resolution, BETA, p0, times).reshape(e - s, nsteps, *np.shape(u)[1:])
               for u, g in ((u_true, gamma_true), (u_pred, gamma_pred))]
        return time_averaged_rel_l2(*rho, axes, times)

    return _batched(len(u_true), batch, errs).cpu().numpy()


# ------------------------------------------------------------------ 2D NC FPE

def ncfpe2d_rollout_error(f_true, f_pred, *, tf: float = 10e-3, nsteps: int = 500,
                          extent=(800 * NM, 800 * NM), resolution: float = 10 * NM,
                          init_center=(-150 * NM, -150 * NM), init_width: float = 30 * NM,
                          batch: int = 2, device=None):
    """args (M, 2, Nx, Ny): the fixed drag, a Gaussian initial density at (-150nm,
    -150nm) of width 30nm, 500 steps. Returns (M,) errors."""
    dev = default_device(device)
    p0, axes = _gaussian_p0(extent, resolution, init_center, init_width, dev)
    times = torch.linspace(0.0, tf, nsteps, device=dev)
    diff = KB * TEMPERATURE / BASE_DRAG
    shape = np.shape(f_true)[2:]

    def errs(s, e):
        zero_u = torch.zeros((e - s,) + tuple(shape), device=dev)
        rho = [propagate_expm(zero_u, diff, resolution, BETA, p0, times,
                              force=f32(f[s:e], dev)).reshape(e - s, nsteps, *shape)
               for f in (f_true, f_pred)]
        return time_averaged_rel_l2(*rho, axes, times)

    return _batched(len(f_true), batch, errs).cpu().numpy()


# ------------------------------------------------------------------ 1D GPE / Schrodinger

def gpe_rollout_error(v_true, v_pred, g, kappa, *, nx: int = 128, dt: float = 0.005,
                      t_final: float = 5.0, ic: int = 2, device=None):
    """v_* (M, Nx); g, kappa (M,): the TRUE g and kappa with the predicted V, the error
    on |psi|. Returns (M,) errors."""
    dev = default_device(device)
    x = torch.linspace(-10.0, 10.0, nx, device=dev)
    nt = int(round(t_final / dt)) + 1
    times = torch.linspace(0.0, t_final, nt, device=dev)
    psi0 = gpe_solver.get_initial_condition(ic, x)
    g, kappa = f32(g, dev), f32(kappa, dev)
    rho = [torch.abs(gpe_solver.solve_gpe(psi0, x, dt, nt, g, kappa, f32(v, dev)))
           for v in (v_true, v_pred)]
    return time_averaged_rel_l2(*rho, [x], times).cpu().numpy()


# ------------------------------------------------------------------ suite orchestration

def time_error_suite(spec, model_name: str, workdir: str, num_samples: int = 100,
                     seed: int = 42, device=None):
    """Load the test set and the best checkpoint, predict the fields of ``num_samples``
    test sets (the reference's seed-42 choice), denormalize them, roll out the true and
    the predicted coefficients, and return the mean and standard deviation of the
    time-averaged errors; the report is also written to
    ``{workdir}/eval/{suite}_{model}/time_error.json``. fpe2d's predicted drag is
    floored at 0.05 * BASE_DRAG (gamma <= 0 would blow up kT/gamma); the GPE suites roll
    out the predicted V with the true g and kappa."""
    from blindno_torch.eval.field_eval import (_load_npz, cached_train_stats,
                                               denormalize_predictions, normalized_test_inputs,
                                               predict_fields)
    from blindno_torch.train.checkpoint import load_best

    dev = default_device(device)
    train_ds = cached_train_stats(spec, workdir)
    test = _load_npz(os.path.join(workdir, "data", spec.test_file))
    inputs = normalized_test_inputs(train_ds, test)

    n_total = inputs.shape[0]
    num_samples = min(num_samples, n_total)
    idx = np.random.default_rng(seed).choice(n_total, size=num_samples, replace=False)

    ckpt = load_best(os.path.join(workdir, "ckpt", f"{spec.name}_{model_name}"), dev)
    model = spec.models[model_name](device=dev)
    model.load_state_dict({**ckpt["params"], **ckpt["batch_stats"]})
    model.eval()
    preds = denormalize_predictions(spec, train_ds,
                                    predict_fields(model, inputs[idx], spec.grid, device=dev))

    if spec.name == "fpe1d":
        errs = fpe1d_rollout_error(test["potential"][idx], test["drag"][idx], preds[..., 0],
                                   preds[..., 1].mean(axis=1), device=dev)
    elif spec.name == "fpe2d":
        gamma_floor = 0.05 * BASE_DRAG
        errs = fpe2d_rollout_error(test["potential"][idx], test["drag"][idx], preds[..., 0],
                                   np.maximum(preds[..., 1], gamma_floor), device=dev)
    elif spec.name == "ncfpe2d":
        errs = ncfpe2d_rollout_error(test["F"][idx], np.moveaxis(preds, -1, 1), device=dev)
    elif spec.name in ("schrodinger1d", "gpe1d", "gpe1d_vgk"):
        errs = gpe_rollout_error(test["V"][idx], preds[..., 0], test["g"][idx],
                                 test["kappa"][idx], device=dev)
    else:
        raise ValueError(f"unknown suite {spec.name}")

    report = {
        "suite": spec.name,
        "model": model_name,
        "num_samples": int(num_samples),
        "mean_err_l2": float(errs.mean()),
        "std_err_l2": float(errs.std()),
    }
    out_dir = os.path.join(workdir, "eval", f"{spec.name}_{model_name}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "time_error.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    return report
