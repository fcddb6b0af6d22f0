"""The port's four 1-D suites (fpe1d, schrodinger1d, gpe1d, gpe1d_vgk) against the JAX
package on the CPU.

- The loaders (``load_fpe1d``; ``load_gpe1d`` in each ``thirds`` and ``include_gk``
  mode) equal JAX's bit for bit on archives from JAX's own datagen at a few sets.
- The suite eval's 1-D target branches, its GPE input scaling and the ``max__`` keys of
  its statistics sidecar equal JAX's.
- The port's ``evaluate_suite_model`` of one committed checkpoint per suite (through
  ``from_flax``) equals JAX's on the same small datagen archives, the flip average
  included, within 2e-3.
- The CLI trains (one epoch; in fpe1d then a resumed one) and evaluates every registered
  model of every 1-D suite on small archives in the datagen's format.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import blindno.data.datasets as jd
import blindno.eval.field_eval as jfe
import blindno.suites.registry as jax_registry
import blindno_torch.data.datasets as td
import blindno_torch.eval.field_eval as tfe
import blindno_torch.suites.registry as registry
from blindno.data import generate as G
from blindno_torch.convert import from_flax
from blindno_torch.suites.run import main
from test_torch_suites import (REPORT_KEYS, _assert_eval_matches_jax, _assert_figures,
                               _port_best_from_jax)

CKPT = os.path.join(os.path.dirname(__file__), "..", "runs", "ckpt")
SUITES_1D = ("fpe1d", "schrodinger1d", "gpe1d", "gpe1d_vgk")


@pytest.fixture(scope="module")
def archives():
    """Train (10 sets) and test (4 sets) archives of JAX's datagen for fpe1d, the GPE
    suites (g = kappa = 2, shared by gpe1d and gpe1d_vgk) and Schrodinger (g = kappa = 0),
    seeded as ``python -m blindno.suites.run --stage datagen`` seeds them."""
    return {"fpe1d": (G.generate_fpe1d(0, 10), G.generate_fpe1d(1, 4)),
            "gpe1d": (G.generate_gpe1d(0, 10, g=2.0, kappa=2.0),
                      G.generate_gpe1d(1, 4, g=2.0, kappa=2.0)),
            "schrodinger1d": (G.generate_gpe1d(0, 10, g=0.0, kappa=0.0),
                              G.generate_gpe1d(1, 4, g=0.0, kappa=0.0))}


def _archive_of(suite):
    return "gpe1d" if suite == "gpe1d_vgk" else suite


def _assert_stats_equal(got, want):
    assert got.keys() == want.keys()
    for k, s in got.items():
        w = want[k]
        if isinstance(s, td.MaxStats):
            assert dataclasses.astuple(s) == dataclasses.astuple(w)
        else:
            assert s.scale == w.scale
            np.testing.assert_array_equal(s.mean, w.mean)
            np.testing.assert_array_equal(s.std, w.std)


# ------------------------------------------------------------------ loaders


def test_fpe1d_scales_are_the_jax_packages():
    assert td.FPE1D_SCALES == jd.FPE1D_SCALES


def test_load_fpe1d_equals_jax_bit_for_bit(archives):
    train, _ = archives["fpe1d"]
    got, want = td.load_fpe1d(train), jd.load_fpe1d(train)
    assert got.inputs.shape == (10, 100, 80) and got.targets.shape == (10, 80, 2)
    np.testing.assert_array_equal(got.inputs, want.inputs)
    np.testing.assert_array_equal(got.targets, want.targets)
    assert got.inputs.dtype == got.targets.dtype == np.float32
    # the scalar drag, replicated over the grid
    assert (got.targets[..., 1] == got.targets[:, :1, 1]).all()
    _assert_stats_equal(got.stats, want.stats)


@pytest.mark.parametrize("archive,thirds,include_gk", [
    ("gpe1d", True, False), ("gpe1d", False, True), ("gpe1d", True, True),
    ("gpe1d", False, False), ("schrodinger1d", True, False)])
def test_load_gpe1d_equals_jax_bit_for_bit(archives, archive, thirds, include_gk):
    """Every mode on the GPE archive, and Schrodinger's, whose g and kappa are zero (their
    maxima then default to 1)."""
    train, _ = archives[archive]
    got = td.load_gpe1d(train, thirds, include_gk)
    want = jd.load_gpe1d(train, thirds, include_gk)
    assert got.inputs.shape == (10, 101, 128)
    assert got.targets.shape == (10, 128, 3 if include_gk else 1)
    np.testing.assert_array_equal(got.inputs, want.inputs)
    np.testing.assert_array_equal(got.targets, want.targets)
    assert got.inputs.dtype == got.targets.dtype == np.float32
    _assert_stats_equal(got.stats, want.stats)
    if archive == "schrodinger1d":
        assert (got.stats["max"].g_max, got.stats["max"].kappa_max) == (1.0, 1.0)


# ------------------------------------------------------------------ the suite eval's branches


@pytest.mark.parametrize("suite", SUITES_1D)
def test_test_inputs_targets_and_denormalization_equal_jax(archives, suite):
    """The test archive's inputs (standardized, or divided by the snapshots' maximum),
    ``_normalized_test_targets`` and ``denormalize_predictions`` equal JAX's on the
    suite's train statistics; the denormalization undoes the targets' normalization
    (fpe1d's drag through the mean of its channel over the grid)."""
    train, test = archives[_archive_of(suite)]
    jstats = jax_registry.SUITES[suite].loader(train)
    ts = tfe.TrainStats(registry.SUITES[suite].loader(train).stats, jstats.targets.shape[-1])
    jts = jfe.TrainStats(jstats.stats, jstats.targets.shape[-1])
    inputs = tfe.normalized_test_inputs(ts, test)
    want_inputs = (np.asarray(test["y"], np.float32) / jts.stats["max"].y_max if "max" in jts.stats
                   else jts.stats["traj"].normalize(np.asarray(test["trajectories"])))
    np.testing.assert_array_equal(inputs, want_inputs)
    targets = tfe._normalized_test_targets(None, ts, test)
    want = jfe._normalized_test_targets(None, jts, test)
    assert targets.shape == (4, inputs.shape[-1], ts.n_fields) and targets.dtype == np.float32
    np.testing.assert_array_equal(targets, want)
    preds = np.random.default_rng(2).standard_normal(targets.shape).astype(np.float32)
    phys = tfe.denormalize_predictions(None, ts, preds)
    np.testing.assert_array_equal(phys, np.asarray(jfe.denormalize_predictions(None, jts, preds)))
    back = tfe.denormalize_predictions(None, ts, targets)
    if suite == "fpe1d":
        raw = np.stack([test["potential"], np.repeat(test["drag"][:, None], 80, 1)], -1)
    else:
        v = test["V"]
        raw = np.stack([v, *(np.broadcast_to(test[k][:, None], v.shape) for k in ("g", "kappa"))],
                       -1)[..., :ts.n_fields]
    for f in range(ts.n_fields):
        scale = np.abs(raw[..., f]).max()
        np.testing.assert_allclose(back[..., f], raw[..., f], rtol=1e-5, atol=1e-5 * scale)


def test_sidecar_keeps_each_gpe_suites_max_stats(archives, tmp_path):
    """gpe1d and gpe1d_vgk read one archive with different maxima (a third of the
    maxima, or the maxima): each writes its own sidecar with the ``max__`` keys, equal to
    JAX's arrays, and reads it back equal."""
    os.makedirs(tmp_path / "data")
    np.savez(tmp_path / "data" / "gpe1d_train.npz", **archives["gpe1d"][0])
    read = {}
    for suite in ("gpe1d", "gpe1d_vgk"):
        sidecar = tmp_path / "data" / f"{suite}.stats.npz"
        jfe.cached_train_stats(jax_registry.SUITES[suite], str(tmp_path))
        with np.load(sidecar) as z:
            want = {k: z[k] for k in z.files}
        os.remove(sidecar)
        written = tfe.cached_train_stats(registry.SUITES[suite], str(tmp_path))
        with np.load(sidecar) as z:
            assert set(z.files) == set(want) == {"src_mtime", "src_size", "n_fields", "max__max"}
            for k in z.files:
                np.testing.assert_array_equal(z[k], want[k], err_msg=k)
        read[suite] = tfe.cached_train_stats(registry.SUITES[suite], str(tmp_path))
        assert read[suite].n_fields == written.n_fields
        _assert_stats_equal(read[suite].stats, written.stats)
    assert (read["gpe1d"].n_fields, read["gpe1d_vgk"].n_fields) == (1, 3)
    assert read["gpe1d"].stats["max"].v_max * 3 == pytest.approx(read["gpe1d_vgk"].stats["max"].v_max)


# ------------------------------------------------------------------ committed checkpoints


def test_from_flax_maps_the_full_width_unet_nobag_tree():
    """fpe1d's ``unet_nobag`` (depth 6, the full set, no mask) has no committed
    checkpoint: its flax tree (shapes from ``jax.eval_shape`` of the JAX registry's
    model) maps onto the port registry's model, every key and shape."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros((1, 3, 80))
    tree = jax.eval_shape(jax_registry.SUITES["fpe1d"].models["unet_nobag"]().init,
                          jax.random.PRNGKey(0), x)
    zeros = lambda t: jax.tree.map(lambda a: np.zeros(a.shape, np.float32), t)
    state = registry.SUITES["fpe1d"].models["unet_nobag"](device="cpu").state_dict()
    mapped = from_flax(zeros(tree["params"]), zeros(tree["batch_stats"]))
    assert mapped.keys() == state.keys()
    assert all(mapped[k].shape == state[k].shape for k in state)
    assert sum(k.startswith("convs.") and k.endswith(".weight") for k in state) == 2 * 6 + 2



@pytest.mark.parametrize("suite,model", [("fpe1d", "unet"), ("schrodinger1d", "nio"),
                                         ("gpe1d", "fno"), ("gpe1d_vgk", "nio")])
def test_committed_checkpoint_eval_matches_jax(archives, suite, model, tmp_path):
    """The committed ``runs/ckpt/{suite}_{model}``: JAX's eval of it and the port's eval
    of it through ``from_flax``, at the suite's own config on the same datagen archives,
    agree within 2e-3: the report with its flip-average columns, metrics.csv, the
    denormalized predictions and the sidecar."""
    jw, w = (str(tmp_path / d) for d in ("jax", "port"))
    spec, jspec = registry.SUITES[suite], jax_registry.SUITES[suite]
    train, test = archives[_archive_of(suite)]
    os.makedirs(os.path.join(jw, "data"))
    np.savez(os.path.join(jw, "data", spec.train_file), **train)
    np.savez(os.path.join(jw, "data", spec.test_file), **test)
    shutil.copytree(os.path.join(jw, "data"), os.path.join(w, "data"))
    name = f"{suite}_{model}"
    shutil.copytree(os.path.join(CKPT, name), os.path.join(jw, "ckpt", name))
    jreport = jfe.evaluate_suite_model(jspec, model, jw, make_figures=False)
    _port_best_from_jax(os.path.join(jw, "ckpt", name), os.path.join(w, "ckpt", name),
                        lambda: spec.models[model](device="cpu"))
    report = tfe.evaluate_suite_model(spec, model, w, device="cpu")
    _assert_eval_matches_jax(report, jreport, w, jw, suite, model, 4)


# ------------------------------------------------------------------ the CLI

M_TRAIN, M_TEST, L_SMALL = 40, 5, 6  # 32 train sets: one batch of the suites' 32


def _fpe1d_archive(m, rng, l=L_SMALL, n=80):
    """An fpe1d archive in the datagen's keys and magnitudes: trajectories (m, l, n) ~ 1e-2
    that relax towards a well, the well's potential (m, n) ~ 1e-20, a drag (m,) ~ 1e-9."""
    x = np.linspace(-1, 1, n)
    well = np.exp(-(x - rng.uniform(-0.5, 0.5, (m, 1))) ** 2 / 0.1)
    t = rng.uniform(0.2, 1.0, (m, l, 1))
    traj = (well[:, None] ** t + 0.05 * rng.random((m, l, n))) * 1e-2
    return {"trajectories": traj.astype(np.float32),
            "potential": (-well * 3e-20).astype(np.float32),
            "drag": (rng.uniform(0.5, 2.0, m) * 1e-9).astype(np.float32)}


def _gpe1d_archive(m, rng, g, l=L_SMALL, n=128):
    """A GPE archive in the datagen's keys: |psi| snapshots y (m, l, n) of a Gaussian
    moving in a well, the well V (m, n), and g and kappa (m,) constant."""
    x = np.linspace(-10, 10, n)
    x0 = rng.uniform(-3, 3, (m, 1))
    v = rng.uniform(0.1, 0.3, (m, 1)) * (x - x0) ** 2
    y = np.exp(-(x - x0[:, None] - rng.uniform(-1, 1, (m, l, 1))) ** 2 / 4)
    return {"y": y.astype(np.float32), "V": v.astype(np.float32), "g": np.full(m, g),
            "kappa": np.full(m, g)}


def _write_cli_archives(w):
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(w, "data"))
    for name, make in (("fpe1d", _fpe1d_archive),
                       ("gpe1d", lambda m, r: _gpe1d_archive(m, r, 2.0)),
                       ("schrodinger1d", lambda m, r: _gpe1d_archive(m, r, 0.0))):
        np.savez(os.path.join(w, "data", f"{name}_train.npz"), **make(M_TRAIN, rng))
        np.savez(os.path.join(w, "data", f"{name}_test.npz"), **make(M_TEST, rng))


@pytest.fixture(scope="module")
def cli_workdir(tmp_path_factory):
    w = str(tmp_path_factory.mktemp("cli1d"))
    _write_cli_archives(w)
    return w


MODELS_1D = [(s, m) for s in SUITES_1D for m in registry.SUITES[s].models]


def test_every_model_of_the_jax_registry_is_registered():
    assert {s: set(registry.SUITES[s].models) for s in SUITES_1D} == {
        s: set(jax_registry.SUITES[s].models) for s in SUITES_1D}
    assert {s: set(spec.models) for s, spec in registry.SUITES.items()} == {
        s: set(spec.models) for s, spec in jax_registry.SUITES.items()}


@pytest.mark.parametrize("suite,model", MODELS_1D, ids=[f"{s}-{m}" for s, m in MODELS_1D])
def test_cli_trains_resumes_and_evaluates(cli_workdir, suite, model):
    """``--stage train`` for one epoch (one step of the suite's batch of 32), in fpe1d a
    second ``--stage train`` that resumes into epoch 2, then ``--stage eval`` with the
    flip average: finite losses, the checkpoint layout, a report over the test sets, and
    predictions of the suite's fields in the archive's physical units. One thread, as
    the suite's steps are many small operations that oversubscribed threads slow down."""
    w = cli_workdir
    argv = ["--suite", suite, "--model", model, "--workdir", w, "--device", "cpu"]
    epochs = 2 if suite == "fpe1d" else 1
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for epoch in range(1, epochs + 1):
            res = main(argv + ["--stage", "train", "--epochs", str(epoch)])
            assert res.finished and [h["epoch"] for h in res.history] == [epoch]
        report = main(argv + ["--stage", "eval"])
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite([res.history[0]["train_loss"], res.history[0]["test_loss"]]).all()
    ckpt = os.listdir(os.path.join(w, "ckpt", f"{suite}_{model}"))
    assert "resume.msgpack" in ckpt and sum(f.startswith("best_") for f in ckpt) == 1
    assert set(report) == REPORT_KEYS | {"figures"} and report["n_test"] == M_TEST
    _assert_figures(report, w, suite, model, M_TEST)
    assert np.isfinite([report["mean_rel_l2_sum"], report["mean_rel_l2_sum_tta"]]).all()
    preds = np.load(os.path.join(w, "eval", f"{suite}_{model}", "predictions.npy"))
    n, fields = (80, 2) if suite == "fpe1d" else (128, 3 if suite == "gpe1d_vgk" else 1)
    assert preds.shape == (M_TEST, n, fields) and np.isfinite(preds).all()
    if suite == "fpe1d":  # the potential ~1e-20, the scalar drag ~1e-9 over the grid
        assert 1e-22 < np.abs(preds[..., 0]).max() < 1e-18
        assert 1e-11 < np.abs(preds[..., 1]).max() < 1e-7
        assert (preds[..., 1] == preds[:, :1, 1]).all()
    elif suite == "gpe1d_vgk":  # g and kappa ~2
        assert 0.1 < np.abs(preds[..., 1:]).max() < 50
