"""The port's solvers against the JAX package's on the CPU: the potentials, the
Fokker-Planck generator and propagators (``blindno_torch/solvers/fokker_planck.py``),
the split-step GPE solver, the trajectories and the rollout errors of the time-error
metric, each on the same numpy-seeded inputs at the tolerances of
``tests/test_solver_fpe.py``: rtol 2e-4 and atol 2e-6 for float32 batches, rtol 1e-6
where float64 is used. The 2-D cases run on coarse grids (16x16, 20x20)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blindno.eval.time_error as jax_time_error
import blindno.eval.trajectory as jax_trajectory
import blindno.solvers.fokker_planck as jax_fp
import blindno.solvers.gpe as jax_gpe
import blindno.solvers.potentials as jax_potentials
from blindno_torch.eval import time_error, trajectory
from blindno_torch.solvers import fokker_planck as fp
from blindno_torch.solvers import gpe, potentials

NM = 1e-9
BETA = 1.0 / (fp.KB * 300.0)
DRAG = 6 * np.pi * 8e-4 * 50 * NM
F32 = dict(rtol=2e-4, atol=2e-6)   # tests/test_solver_fpe.py:208
F64 = dict(rtol=1e-6, atol=1e-9)   # tests/test_solver_fpe.py:189
METRIC_TOL = 1e-4                  # the time-averaged errors, relative


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _wells_1d(rng, m, n=80):
    x = fp.grid_from_extent(800 * NM, 10 * NM)[0].numpy()
    c = rng.uniform(-150 * NM, 150 * NM, (m, 1))
    return (-1.5e-20 * np.exp(-((x - c) / (50 * NM)) ** 2)).astype(np.float32), x


def _jax_each(fn, *batches):
    return np.stack([np.asarray(fn(*(jnp.asarray(b[i]) for b in batches)))
                     for i in range(len(batches[0]))])


# ------------------------------------------------------------------ potentials


def test_potentials_match_jax():
    """All eight constructors on a 2-D (or 1-D) float32 grid."""
    x = np.linspace(-200 * NM, 200 * NM, 9, dtype=np.float32)
    gx, gy = np.meshgrid(x, x + 5 * NM, indexing="ij")
    data = np.random.default_rng(0).standard_normal((9, 9)).astype(np.float32)
    cases = [
        ("gaussian_potential", dict(center=(10 * NM, -20 * NM), width=60 * NM, amplitude=1e-20)),
        ("gaussian_pdf", dict(center=(0.0, 30 * NM), width=50 * NM)),
        ("uniform_pdf", {}),
        ("harmonic_potential", dict(k=3e-6)),
        ("spiral_force", dict(L=100 * NM, a=1.2, b=0.7, c=1.5, d=0.9)),
        ("potential_from_data", dict(grid=(x, x), data=data)),
    ]
    for name, kw in cases:
        want = np.asarray(getattr(jax_potentials, name)(**kw)(jnp.asarray(gx), jnp.asarray(gy)))
        got = getattr(potentials, name)(**kw)(torch.tensor(gx), torch.tensor(gy)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
    both = lambda m: m.combine(m.gaussian_potential(0.0, 40 * NM, 1e-20),
                               m.harmonic_potential(1e-6))
    xs = np.linspace(-300, 300, 31).astype(np.float32) * NM
    np.testing.assert_allclose(both(potentials)(torch.tensor(xs)).numpy(),
                               np.asarray(both(jax_potentials)(jnp.asarray(xs))), rtol=1e-5)
    v = (0.2, 1.1, 0.8, -0.5)
    xg = np.linspace(-10, 10, 128).astype(np.float32)
    np.testing.assert_allclose(potentials.quadratic_cos2_potential(*v)(torch.tensor(xg)).numpy(),
                               np.asarray(jax_potentials.quadratic_cos2_potential(*v)(jnp.asarray(xg))),
                               rtol=1e-5, atol=1e-6)
    table = np.linspace(0.0, 1.0, 9).astype(np.float32) ** 2
    at = np.linspace(-300, 300, 25).astype(np.float32) * NM  # beyond the knots too
    np.testing.assert_allclose(
        potentials.potential_from_data(x, table)(torch.tensor(at)).numpy(),
        np.asarray(jax_potentials.potential_from_data(x, table)(jnp.asarray(at))), rtol=1e-6)
    assert set(potentials.__all__) == set(jax_potentials.__all__)


# ------------------------------------------------------------------ Fokker-Planck


def test_grid_and_generator_match_jax():
    """fplanck's grid sizes, bit for bit; the generator, with a force, within rounding
    of ``exp`` (1e-6 relative)."""
    for extent, n in ((800 * NM, 80), (600 * NM, 61)):
        got = fp.grid_from_extent(extent, 10 * NM)[0].numpy()
        want = np.asarray(jax_fp.grid_from_extent(extent, 10 * NM)[0])
        assert got.shape == (n,) and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(0)
    u, _ = _wells_1d(rng, 2)
    d = rng.uniform(1e-11, 3e-11, (2, 80)).astype(np.float32)
    want = _jax_each(lambda a, b: jax_fp.build_generator(a, b, 10 * NM, BETA), u, d)
    got = fp.build_generator(torch.tensor(u), torch.tensor(d), 10 * NM, BETA).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    u2 = rng.standard_normal((2, 7, 9)).astype(np.float32)
    f2 = 0.5 * rng.standard_normal((2, 2, 7, 9)).astype(np.float32)
    want = _jax_each(lambda a, f: jax_fp.build_generator(a, 0.7, 0.1, 1.0, force=f), u2, f2)
    got = fp.build_generator(torch.tensor(u2), 0.7, 0.1, 1.0, force=torch.tensor(f2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(got.sum(1), 0.0, atol=1e-5 * np.abs(got).max())  # mass


def test_propagate_expm_and_eigh_match_jax_float32():
    """A float32 batch of 1-D wells with per-sample drags, 400 steps (fpe1d's rollout)."""
    rng = np.random.default_rng(1)
    u, x = _wells_1d(rng, 3)
    d = (fp.KB * 300.0 / (DRAG * rng.uniform(1.0, 2.0, (3, 1))) * np.ones((1, 80))).astype(np.float32)
    p0 = np.exp(-((x / (50 * NM)) ** 2))
    p0 = (p0 / p0.sum()).astype(np.float32)
    times = jnp.linspace(0.0, 2e-3, 400)
    want = _jax_each(lambda a, b: jax_fp.propagate_expm(a, b, 10 * NM, BETA, jnp.asarray(p0), times), u, d)
    args = torch.tensor(u), torch.tensor(d), 10 * NM, BETA, torch.tensor(p0)
    got = fp.propagate_expm(*args, torch.tensor(np.asarray(times))).numpy()
    assert got.shape == (3, 400, 80)
    np.testing.assert_allclose(got, want, **F32)
    # mass drifts by float32 rounding over the rollout, as much as JAX's
    drift = np.abs(got.sum(-1) - 1.0).max()
    assert drift <= 2 * np.abs(want.sum(-1) - 1.0).max() + 1e-6, drift
    want = _jax_each(lambda a, b: jax_fp.propagate_eigh(a, b, 10 * NM, BETA, jnp.asarray(p0),
                                                        times[:11]), u, d)
    np.testing.assert_allclose(fp.propagate_eigh(*args, torch.tensor(np.asarray(times[:11]))).numpy(),
                               want, **F32)


def test_propagate_eigh_and_pade_expm_match_jax_float64(jax_x64):
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 6, 7))
    d = rng.uniform(0.5, 1.0, (2, 6, 7))
    p0 = rng.uniform(0.1, 1.0, 42)
    p0 /= p0.sum()
    times = np.linspace(0.0, 0.5, 6)
    want = _jax_each(lambda a, b: jax_fp.propagate_eigh(a, b, 0.2, 1.0, jnp.asarray(p0),
                                                        jnp.asarray(times)), u, d)
    got = fp.propagate_eigh(torch.tensor(u), torch.tensor(d), 0.2, 1.0, torch.tensor(p0),
                            torch.tensor(times)).numpy()
    np.testing.assert_allclose(got, want, **F64)
    # the Pade expm at every float64 degree (1-norms from 0.01 to 40) and in float32
    a = rng.standard_normal((5, 12, 12)) * np.array([0.002, 0.03, 0.15, 0.4, 4.0])[:, None, None]
    np.testing.assert_allclose(fp.expm(torch.tensor(a)).numpy(),
                               _jax_each(jax.scipy.linalg.expm, a), **F64)
    a32 = a.astype(np.float32) * 2
    np.testing.assert_allclose(fp.expm(torch.tensor(a32)).numpy(),
                               _jax_each(jax.scipy.linalg.expm, a32), rtol=2e-4, atol=2e-5)


def _generators(rng, n, scales, force=True):
    """Generators on an n x n grid whose samples differ in stiffness, as expm_markov's
    tests build them (tests/test_solver_fpe.py:180-194)."""
    x = np.linspace(-1, 1, n)
    gx, gy = np.meshgrid(x, x, indexing="ij")
    u = np.stack([np.exp(-(gx**2 + gy**2)) * 2.0 * s for s in scales])
    f = 0.5 * rng.standard_normal((len(scales), 2, n, n)) if force else None
    return u, f


def test_expm_markov_matches_jax_float64_with_its_guard(jax_x64):
    """The float64 series against JAX's and against the Pade expm; a max_terms below the
    tail bound poisons the whole propagator with NaN."""
    u, f = _generators(np.random.default_rng(3), 12, [1.0, 3.0])
    m = fp.build_generator(torch.tensor(u), 0.7, 2.0 / 11, 1.0, force=torch.tensor(f))
    want = _jax_each(lambda a, b: jax_fp.expm_markov(jax_fp.build_generator(a, 0.7, 2.0 / 11, 1.0,
                                                                           force=b), 0.05), u, f)
    got = fp.expm_markov(m, 0.05).numpy()
    np.testing.assert_allclose(got, want, **F64)
    np.testing.assert_allclose(got, fp.expm(m * 0.05).numpy(), **F64)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-9)
    lam = float((-m.diagonal(dim1=1, dim2=2)).max()) * (1 + 1e-6)
    poisoned = fp.expm_markov(m, 600.0 / lam, max_terms=60).numpy()
    assert np.isnan(poisoned[0]).all() or np.isnan(poisoned[1]).all()


def test_expm_markov_f32_batch_with_different_term_counts():
    """A float32 batch whose samples need 18, 31 and 134 terms (on an 80x80-shaped
    problem's algorithm, at 16x16): each stops at its own count, as under JAX's vmap, and
    matches JAX's per-sample result and the Pade expm."""
    rng = np.random.default_rng(4)
    u = (rng.standard_normal((3, 16, 16)) * np.array([0.2, 1.0, 3.0])[:, None, None]).astype(np.float32)
    m = fp.build_generator(torch.tensor(u), 0.5, 2.0 / 15, 1.0)
    lam = (-m.diagonal(dim1=1, dim2=2)).amax(1).numpy() * (1 + 1e-6)
    a = lam * 0.05 / 16
    need = np.ceil(a + 10 * np.sqrt(a) + 10)
    assert len(set(need)) == 3
    got = fp.expm_markov(m, 0.05).numpy()
    want = _jax_each(lambda a_: jax_fp.expm_markov(jax_fp.build_generator(a_, 0.5, 2.0 / 15, beta=1.0),
                                                   0.05), u)
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got, fp.expm(m * 0.05).numpy(), **F32)
    one = [fp.expm_markov(m[i:i + 1], 0.05).numpy()[0] for i in range(3)]
    np.testing.assert_allclose(got, np.stack(one), rtol=1e-6, atol=1e-7)


def test_fokker_planck_facade_matches_jax():
    """fplanck's facade: a 2-D space-varying drag through eigh and a spiral force through
    expm, 16x16 and 20x20 cells."""
    def drag(m):
        return lambda x, y: DRAG * (1 + 0.5 * (x / (250 * NM)) ** 2 + 0.5 * (y / (250 * NM)) ** 2)

    for kw, tf in ((dict(extent=[160 * NM, 160 * NM], potential="gauss", drag="field"), 2e-4),
                   (dict(extent=[200 * NM, 200 * NM], force="spiral"), 1e-2)):
        out = []
        for m in (jax_potentials, potentials):
            args = dict(temperature=300.0, resolution=10 * NM, extent=kw["extent"])
            args["drag"] = drag(m) if kw.get("drag") else DRAG
            if kw.get("potential"):
                args["potential"] = m.gaussian_potential((0.0, 0.0), 60 * NM, 1.2e-20)
            if kw.get("force"):
                args["force"] = m.spiral_force(L=100 * NM, a=1.0, b=1.0, c=1.0, d=1.0)
            if m is potentials:
                args["device"] = "cpu"
            sim = (jax_fp if m is jax_potentials else fp).FokkerPlanck(**args)
            t, pt = sim.propagate_interval(m.gaussian_pdf((-30 * NM, -30 * NM), 30 * NM), tf,
                                           Nsteps=20)
            out.append(np.asarray(pt))
        assert out[1].shape == out[0].shape and out[1].shape[1:] in ((16, 16), (20, 20))
        np.testing.assert_allclose(out[1], out[0], **F32)


def test_fokker_planck_facade_takes_the_card_by_default():
    """The facade is an entry point: with no device it builds on the card, and with no
    card it refuses rather than fall back to the CPU; the CPU only when asked for."""
    args = dict(temperature=300.0, drag=DRAG, extent=100 * NM, resolution=10 * NM)
    if torch.cuda.is_available():
        assert fp.FokkerPlanck(**args).grid.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fp.FokkerPlanck(**args)
    sim = fp.FokkerPlanck(**args, device="cpu")
    assert sim.grid.device.type == sim.potential_values.device.type == "cpu"


# ------------------------------------------------------------------ GPE


@pytest.mark.parametrize("order", [2, 4])
def test_solve_gpe_matches_jax(order):
    """Four orbits (g = kappa = 0 and 2) of 1001 steps: |psi| within 1e-4 relative L2 per
    orbit; complex64 and the float32 wave numbers as JAX has them."""
    rng = np.random.default_rng(5)
    x = np.linspace(-10, 10, 128)
    v = 0.2 * (x[None] - rng.uniform(-3, 3, (4, 1))) ** 2 + np.cos(x[None]) ** 2
    g = np.array([0.0, 0.0, 2.0, 2.0], np.float32)
    xj = jnp.asarray(x, jnp.float32)
    psi0 = jax_gpe.get_initial_condition(2, xj)
    want = np.abs(np.asarray(jax.vmap(lambda vv, gg: jax_gpe.solve_gpe(
        psi0, xj, 0.005, 1001, gg, gg, vv, order))(jnp.asarray(v, jnp.float32), jnp.asarray(g))))
    xt = torch.tensor(x, dtype=torch.float32)
    np.testing.assert_array_equal(gpe.wave_numbers(xt).numpy(),
                                  np.asarray(2 * jnp.pi * jnp.fft.fftfreq(128, d=xj[1] - xj[0])))
    rec = gpe.solve_gpe_batch(gpe.get_initial_condition(2, xt), xt, 0.005, 1001,
                              torch.tensor(g), torch.tensor(g), torch.tensor(v, dtype=torch.float32),
                              order)
    assert rec.dtype == torch.complex64 and rec.shape == (4, 1001, 128)
    got = rec.abs().numpy()
    errs = np.linalg.norm(got - want, axis=(1, 2)) / np.linalg.norm(want, axis=(1, 2))
    assert errs.max() < 1e-4, errs
    assert gpe.time_grid(0.005, 5.0)[1] == jax_gpe.time_grid(0.005, 5.0)[1] == 1001


# ------------------------------------------------------------------ trajectories and rollout errors


def test_trajectories_match_jax():
    rng = np.random.default_rng(6)
    u, _ = _wells_1d(rng, 1)
    t, pt = trajectory.fpe1d_trajectory(u[0], 1.3 * DRAG, nsteps=100, device="cpu")
    jt, jpt = jax_trajectory.fpe1d_trajectory(u[0], 1.3 * DRAG, nsteps=100)
    np.testing.assert_allclose(pt, jpt, **F32)
    np.testing.assert_allclose(t, jt, rtol=1e-6)
    gx, gy = np.meshgrid(*[fp.grid_from_extent(160 * NM, 10 * NM)[0].numpy()] * 2, indexing="ij")
    u2 = (1e-20 * (np.exp(-(gx**2 + gy**2) / (40 * NM) ** 2) - 0.3)).astype(np.float32)
    gamma = (DRAG * (1 + 0.3 * rng.random(gx.shape))).astype(np.float32)
    kw = dict(extent=(160 * NM, 160 * NM), nsteps=30)
    _, pt = trajectory.fpe2d_trajectory(u2, gamma, device="cpu", **kw)
    np.testing.assert_allclose(pt, jax_trajectory.fpe2d_trajectory(u2, gamma, **kw)[1], **F32)
    _, clamped = trajectory.fpe2d_trajectory(np.maximum(u2, 0), gamma, device="cpu", **kw)
    _, free = trajectory.fpe2d_trajectory(np.zeros_like(u2), gamma, device="cpu", **kw)
    np.testing.assert_array_equal(clamped, free)  # U >= 0 is set to 0 first
    f = (1e-13 * rng.standard_normal((2, 20, 20))).astype(np.float32)
    kw = dict(extent=(200 * NM, 200 * NM), nsteps=30, init_center=(-50 * NM, -50 * NM))
    _, pt = trajectory.ncfpe2d_trajectory(f, device="cpu", **kw)
    np.testing.assert_allclose(pt, jax_trajectory.ncfpe2d_trajectory(f, **kw)[1], **F32)
    v = (0.2 * np.linspace(-10, 10, 64) ** 2).astype(np.float32)
    _, psi = trajectory.gpe_trajectory(v, 2.0, 2.0, nx=64, t_final=1.0, device="cpu")
    jpsi = jax_trajectory.gpe_trajectory(v, 2.0, 2.0, nx=64, t_final=1.0)[1]
    assert np.linalg.norm(psi - jpsi) / np.linalg.norm(jpsi) < 1e-4


def test_rollout_errors_match_jax():
    """The four rollout errors on the same true and perturbed coefficients, within 1e-4
    relative: fpe1d at its own 400 steps, the 2-D suites on coarse grids. Each
    perturbation gives an error above 0.05, or exactly 0: an error of e is a difference of
    two float32 rollouts whose rounding (1e-6 to 1e-5 of the density, in JAX's rollouts
    as in these) it magnifies by 1/e, so near 0 both packages lie more than 1e-4 apart
    from a float64 rollout."""
    rng = np.random.default_rng(7)
    u, _ = _wells_1d(rng, 3)
    d = np.full(3, DRAG, np.float32)
    up, dp = u * np.float32([1.0, 0.6, 1.2])[:, None], d * np.float32([1.0, 1.3, 0.6])
    pairs = [(time_error.fpe1d_rollout_error(u, d, up, dp, device="cpu"),
              jax_time_error.fpe1d_rollout_error(*map(jnp.asarray, (u, d, up, dp))))]
    gx, gy = np.meshgrid(*[fp.grid_from_extent(160 * NM, 10 * NM)[0].numpy()] * 2, indexing="ij")
    u2 = np.stack([-1e-20 * np.exp(-(gx**2 + gy**2) / (40 * NM) ** 2)] * 2).astype(np.float32)
    g2 = np.full(u2.shape, DRAG, np.float32)
    kw = dict(extent=(160 * NM, 160 * NM), nsteps=100)
    args = u2, g2, u2 * np.float32([[[0.5]], [[0.7]]]), g2 * np.float32([[[1.6]], [[1.1]]])
    pairs.append((time_error.fpe2d_rollout_error(*args, device="cpu", **kw),
                  jax_time_error.fpe2d_rollout_error(*map(jnp.asarray, args), **kw)))
    f = (1e-13 * rng.standard_normal((2, 2, 20, 20))).astype(np.float32)
    kw = dict(extent=(200 * NM, 200 * NM), nsteps=50, init_center=(-50 * NM, -50 * NM))
    fp_ = f * np.float32(0.2)
    pairs.append((time_error.ncfpe2d_rollout_error(f, fp_, device="cpu", **kw),
                  jax_time_error.ncfpe2d_rollout_error(jnp.asarray(f), jnp.asarray(fp_), **kw)))
    x = np.linspace(-10, 10, 128)
    v = np.stack([0.2 * x**2, 0.15 * (x - 1) ** 2]).astype(np.float32)
    g = np.float32([0.0, 2.0])
    pairs.append((time_error.gpe_rollout_error(v, v * np.float32(1.3), g, g, device="cpu"),
                  jax_time_error.gpe_rollout_error(*map(jnp.asarray, (v, v * 1.3, g, g)))))
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape and ((want > 0.05) | (want == 0)).all(), want
        np.testing.assert_allclose(got, want, rtol=METRIC_TOL, atol=1e-7)
    rho = torch.rand(5, 6, 7, dtype=torch.float64)
    axes = [torch.linspace(0, 1, 6, dtype=torch.float64), torch.linspace(0, 2, 7, dtype=torch.float64)]
    times = torch.linspace(0, 1, 5, dtype=torch.float64)
    assert float(time_error.time_averaged_rel_l2(rho, rho, axes, times)) == 0.0
    np.testing.assert_allclose(
        float(time_error.time_averaged_rel_l2(rho, 1.1 * rho, axes, times)),
        float(jax_time_error.time_averaged_rel_l2(jnp.asarray(rho.numpy()), jnp.asarray(1.1 * rho.numpy()),
                                                  [jnp.asarray(a.numpy()) for a in axes],
                                                  jnp.asarray(times.numpy()))), rtol=1e-6)
