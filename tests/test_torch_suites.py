"""The port's suites CLI and suite eval against the JAX package's.

A module fixture runs the JAX CLI (``blindno.suites.run``: train 2 epochs, then eval) on
tiny synthetic fpe2d archives with the suite's config but a small ``NIOFP2D`` and batch
4, so that it compiles in seconds. Against it:

- the port's CLI (``blindno_torch.suites.run --device cpu``) on the same archives with
  the suite's own config, full width and batch 16, writes the same artifact layout,
  log records, summary and report keys;
- the port's ``evaluate_suite_model`` on the weights JAX trained (moved through
  ``from_flax`` into the port's ``best_*`` format) equals JAX's report, the TTA columns
  included, its metrics.csv and its predictions within 2e-3;
- the port's CLI trains and evaluates the fpe2d suite's BlinDNO UNet (``--model unet``,
  full width) on the same archives into the same layout;
- on a tiny synthetic ncfpe2d archive (16x16, so that the grid-agnostic ``NIOFNO2D``
  runs small through ``dataclasses.replace``, as ``tests/test_field_eval_2d.py`` does),
  the port's CLI trains and evaluates ``--suite ncfpe2d --model fno`` into the JAX CLI's
  layout, and its eval on the weights JAX trained equals JAX's;
- the port's eval of the committed ``runs/ckpt/ncfpe2d_unet`` (through ``from_flax``)
  equals JAX's eval of it on the same synthetic 80x80 archive.
"""
import contextlib
import csv
import dataclasses
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

import blindno.suites.registry as jax_registry
import blindno.suites.run as jax_run
import blindno_torch.suites.registry as registry
from blindno.eval.field_eval import evaluate_suite_model as jax_evaluate_suite_model
from blindno.models.nio2d import NIOFNO2D as JNIOFNO2D
from blindno.models.nio2d import NIOFP2D as JNIOFP2D
from blindno.train.checkpoint import load_best as jax_load_best
from blindno_torch.convert import from_flax
from blindno_torch.eval.field_eval import evaluate_suite_model
from blindno_torch.data.datasets import NCFPE2D_SCALES
from blindno_torch.models.nio2d import NIOFNO2D, NIOFP2D
from blindno_torch.suites.run import main
from blindno_torch.train.checkpoint import RESUME, save_best
from test_torch_loop import L_MIN, fpe2d_archive
from test_torch_train import CFG

EVAL_TOL = 2e-3  # the NIO parity bound, tests/test_nio2d_torch_parity.py:190
M_TRAIN, M_TEST = 20, 4  # 16 train samples: one full batch of the suite's 16
REPORT_KEYS = {"suite", "model", "n_test", "mean_rel_l2_per_field", "mean_rel_l2_sum",
               "ckpt_epoch", "ckpt_test_loss", "mean_rel_l2_per_field_tta",
               "mean_rel_l2_sum_tta"}


def _write_archives(workdir):
    os.makedirs(os.path.join(workdir, "data"), exist_ok=True)
    np.savez(os.path.join(workdir, "data", "fpe2d_train.npz"), **fpe2d_archive(M_TRAIN, seed=1))
    np.savez(os.path.join(workdir, "data", "fpe2d_test.npz"), **fpe2d_archive(M_TEST, seed=2))


def _layout(workdir):
    """Relative paths of the workdir's artifacts, a checkpoint's internals (an orbax
    directory in JAX, one file in the port), the figures left out."""
    out = set()
    for root, dirs, files in os.walk(workdir):
        rel = os.path.relpath(root, workdir)
        if os.path.basename(rel).startswith("best_"):
            dirs[:] = []
            continue
        for name in dirs + files:
            path = os.path.normpath(os.path.join(rel, name))
            if name.startswith("best_"):
                path = os.path.join(rel, "best_*")
            elif name.startswith("resume."):
                path = os.path.join(rel, "resume.*")
            if not name.endswith(".png"):
                out.add(path)
    return out


def _assert_figures(report, w, suite, model, n_test):
    """The report's ``figures`` entry: the PNG of each of the first three test samples,
    each drawn (more than 1000 bytes, as ``tests/test_plots.py`` holds the JAX figures)."""
    out = os.path.join(w, "eval", f"{suite}_{model}")
    want = [os.path.join(out, f"pred_sample_{i}.png") for i in range(min(3, n_test))]
    assert report["figures"] == want
    assert all(os.path.getsize(p) > 1000 for p in want)


def _small_jax_spec():
    spec = jax_registry.SUITES["fpe2d"]
    return dataclasses.replace(spec, models={"nio": lambda: JNIOFP2D(**CFG, l_min=L_MIN)},
                               train_cfg=dataclasses.replace(spec.train_cfg, batch_size=4))


@pytest.fixture(scope="module")
def jax_workdir(tmp_path_factory):
    """The JAX CLI's train and eval stages on the tiny archives; returns the workdir and
    its eval report."""
    w = str(tmp_path_factory.mktemp("jax"))
    _write_archives(w)
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_registry.SUITES, "fpe2d", _small_jax_spec())
    out = io.StringIO()
    try:
        for stage in ("train", "eval"):
            mp.setattr("sys.argv", ["run", "--suite", "fpe2d", "--model", "nio", "--stage", stage,
                                    "--workdir", w, "--epochs", "2"])
            with contextlib.redirect_stdout(out):
                jax_run.main()
    finally:
        mp.undo()
    # the eval stage prints its report last, as indented JSON
    printed = out.getvalue()
    return w, json.loads(printed[printed.rindex("\n{\n") + 1:])


def test_cli_writes_the_jax_layout(jax_workdir, tmp_path, capsys):
    """The suite's own config (NIOFP2D width 12, 32 modes, batch 16, d4_scalar,
    compress_inputs) for 2 epochs on the CPU, then the eval stage."""
    jw, jreport = jax_workdir
    w = str(tmp_path)
    _write_archives(w)
    res = main(["--suite", "fpe2d", "--model", "nio", "--stage", "train", "--workdir", w,
                "--epochs", "2", "--device", "cpu"])
    assert res.finished and [h["epoch"] for h in res.history] == [2]
    report = main(["--suite", "fpe2d", "--stage", "eval", "--workdir", w, "--device", "cpu"])
    assert _layout(w) == _layout(jw)
    assert os.path.exists(os.path.join(w, "ckpt", "fpe2d_nio", RESUME))
    assert set(report) == REPORT_KEYS | {"figures"} and set(jreport) == REPORT_KEYS
    _assert_figures(report, w, "fpe2d", "nio", M_TEST)
    assert report["n_test"] == M_TEST and report["ckpt_epoch"] == 2
    assert np.isfinite(report["mean_rel_l2_sum"]) and np.isfinite(report["mean_rel_l2_sum_tta"])
    assert capsys.readouterr().out.rstrip().endswith(json.dumps(report, indent=1))

    def load(workdir, name):
        with open(os.path.join(workdir, "logs", name)) as fh:
            return fh.read()

    summary, jsummary = (json.loads(load(d, "fpe2d_nio_summary.json")) for d in (w, jw))
    assert set(summary) == set(jsummary) == {"suite", "model", "best_test_loss", "history"}
    assert set(summary["history"][0]) == set(jsummary["history"][0])
    records, jrecords = ([json.loads(r) for r in load(d, "fpe2d_nio.jsonl").splitlines()]
                         for d in (w, jw))
    assert [set(r) for r in records] == [set(r) for r in jrecords]
    preds = np.load(os.path.join(w, "eval", "fpe2d_nio", "predictions.npy"))
    assert preds.shape == (M_TEST, 61, 61, 2) and np.isfinite(preds).all()
    # physical units: the potential's wells ~1e-21, the drag ~1e-6
    assert 1e-23 < np.abs(preds[..., 0]).max() < 1e-18
    assert 1e-8 < np.abs(preds[..., 1]).max() < 1e-4


def _port_best_from_jax(jax_ckpt_dir, ckpt_dir,
                        factory=lambda: NIOFP2D(**CFG, l_min=L_MIN, device="cpu")):
    """A JAX ``best_*`` checkpoint as the port's, through ``from_flax`` into the model
    ``factory`` builds."""
    raw = jax_load_best(jax_ckpt_dir)
    state = from_flax(raw["params"], raw["batch_stats"])
    model = factory()
    model.load_state_dict(state)
    params = dict(model.named_parameters())
    stats = dict(model.named_buffers())
    return save_best(ckpt_dir, params, stats, int(raw["epoch"]), float(raw["test_loss"]))


def _read_csv(path):
    with open(path) as fh:
        rows = list(csv.reader(fh))
    return rows[0], np.array(rows[1:], np.float64)


def _assert_eval_matches_jax(report, jreport, w, jw, suite, model, n_test):
    """The port's eval report, metrics.csv and predictions in workdir ``w`` against
    JAX's in ``jw``, within EVAL_TOL (each predicted field to its own physical scale),
    and the two sidecars of train statistics equal."""
    out, jout = (os.path.join(d, "eval", f"{suite}_{model}") for d in (w, jw))
    assert set(report) == set(jreport) | {"figures"}
    _assert_figures(report, w, suite, model, n_test)
    for k in ("suite", "model", "n_test", "ckpt_epoch", "ckpt_test_loss"):
        assert report[k] == jreport[k], k
    for k in ("mean_rel_l2_per_field", "mean_rel_l2_per_field_tta", "mean_rel_l2_sum",
              "mean_rel_l2_sum_tta"):
        np.testing.assert_allclose(report[k], jreport[k], rtol=EVAL_TOL, err_msg=k)
    # the TTA column is its own number, not the single pass again
    assert report["mean_rel_l2_sum_tta"] != report["mean_rel_l2_sum"]
    preds, jpreds = (np.load(os.path.join(d, "predictions.npy")) for d in (out, jout))
    assert preds.shape == jpreds.shape and preds.shape[0] == n_test
    (head, rows), (jhead, jrows) = (_read_csv(os.path.join(d, "metrics.csv")) for d in (out, jout))
    assert head == jhead and rows.shape == jrows.shape == (n_test, preds.shape[-1] + 2)
    np.testing.assert_allclose(rows, jrows, rtol=EVAL_TOL, atol=2e-6)
    for f in range(preds.shape[-1]):  # each field in its own physical units
        scale = np.abs(jpreds[..., f]).max()
        np.testing.assert_allclose(preds[..., f], jpreds[..., f], rtol=EVAL_TOL,
                                   atol=EVAL_TOL * scale, err_msg=f"field {f}")
    with np.load(os.path.join(w, "data", f"{suite}.stats.npz")) as a, \
            np.load(os.path.join(jw, "data", f"{suite}.stats.npz")) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_evaluate_suite_model_matches_jax_on_jax_weights(jax_workdir, tmp_path):
    jw, jreport = jax_workdir
    w = str(tmp_path)
    shutil.copytree(os.path.join(jw, "data"), os.path.join(w, "data"))
    os.remove(os.path.join(w, "data", "fpe2d.stats.npz"))  # the port computes its own
    _port_best_from_jax(os.path.join(jw, "ckpt", "fpe2d_nio"), os.path.join(w, "ckpt", "fpe2d_nio"))
    spec = dataclasses.replace(registry.SUITES["fpe2d"],
                               models={"nio": lambda **kw: NIOFP2D(**CFG, l_min=L_MIN, **kw)})
    report = evaluate_suite_model(spec, "nio", w, device="cpu")
    _assert_eval_matches_jax(report, jreport, w, jw, "fpe2d", "nio", M_TEST)


def test_cli_trains_and_evaluates_the_unet(jax_workdir, tmp_path):
    """``--model unet``: the suite's UNet (depth 4, width 12, 32 modes) for one epoch of
    one batch of 16 on the CPU, then the eval stage with the symmetry average; the
    layout is the NIO's under the model's name."""
    jw, _ = jax_workdir
    w = str(tmp_path)
    _write_archives(w)
    res = main(["--suite", "fpe2d", "--model", "unet", "--stage", "train", "--workdir", w,
                "--epochs", "1", "--device", "cpu"])
    assert res.finished and [h["epoch"] for h in res.history] == [1]
    assert np.isfinite([res.history[0]["train_loss"], res.history[0]["test_loss"]]).all()
    report = main(["--suite", "fpe2d", "--model", "unet", "--stage", "eval", "--workdir", w,
                   "--device", "cpu"])
    assert _layout(w) == {p.replace("fpe2d_nio", "fpe2d_unet") for p in _layout(jw)}
    assert set(report) == REPORT_KEYS | {"figures"} and report["model"] == "unet"
    _assert_figures(report, w, "fpe2d", "unet", M_TEST)
    assert report["n_test"] == M_TEST and report["ckpt_epoch"] == 1
    assert np.isfinite(report["mean_rel_l2_sum"]) and np.isfinite(report["mean_rel_l2_sum_tta"])
    preds = np.load(os.path.join(w, "eval", "fpe2d_unet", "predictions.npy"))
    assert preds.shape == (M_TEST, 61, 61, 2) and np.isfinite(preds).all()


# ------------------------------------------------------------------ the ncfpe2d suite

NC_TOY = 16  # NIOFNO2D is grid-agnostic: the suite's model runs small on a 16x16 grid
SMALL_FNO = dict(width=4, modes=4, inner_modes=4, inner_width=2, fno_layers=2)  # test_field_eval_2d.py:36
NC_TRAIN, NC_TEST = 10, 4  # 8 train samples: two batches of the suite's 4


def ncfpe2d_archive(m, l=4, n=NC_TOY, seed=0):
    """A synthetic ncfpe2d archive in the JAX datagen's keys and raw magnitudes
    (``blindno/data/generate.py:265-270``): trajectories (m, l, n, n) ~ 1e-10 and a
    spiral force F (m, 2, n, n) ~ 1e-12 around a random centre, the snapshots a blob
    drifting along it, plus noise."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n), indexing="ij")
    c = rng.uniform(-0.3, 0.3, (m, 2, 1, 1))
    a = rng.uniform(0.2, 1.0, (m, 1, 1))
    dx, dy = gx - c[:, 0], gy - c[:, 1]
    force = np.stack([-dy - a * dx, dx - a * dy], axis=1)
    t = rng.uniform(0.0, 1.0, (m, l, 1, 1))
    r = (dx[:, None] - 0.3 * np.cos(3 * t)) ** 2 + (dy[:, None] - 0.3 * np.sin(3 * t)) ** 2
    traj = np.exp(-r / 0.1) + 0.05 * rng.random((m, l, n, n))
    s = NCFPE2D_SCALES
    return {"trajectories": (traj / s["trajectories"]).astype(np.float32),
            "F": (force / s["F"]).astype(np.float32)}


def _toy_grid(n):
    gx, gy = np.meshgrid(np.linspace(-1, 1, n, dtype=np.float32),
                         np.linspace(-1, 1, n, dtype=np.float32), indexing="ij")
    return np.stack([gx, gy], axis=2)


def _write_nc_archives(workdir, n=NC_TOY, m=NC_TRAIN, m_test=NC_TEST):
    os.makedirs(os.path.join(workdir, "data"), exist_ok=True)
    np.savez(os.path.join(workdir, "data", "ncfpe2d_train.npz"), **ncfpe2d_archive(m, n=n, seed=1))
    np.savez(os.path.join(workdir, "data", "ncfpe2d_test.npz"),
             **ncfpe2d_archive(m_test, n=n, seed=2))


@pytest.fixture(scope="module")
def jax_nc_workdir(tmp_path_factory):
    """The JAX CLI's ncfpe2d train (2 epochs) and eval stages for a small ``NIOFNO2D``
    on the 16x16 archives, the suite's config otherwise; the workdir and its report."""
    w = str(tmp_path_factory.mktemp("jax_nc"))
    _write_nc_archives(w)
    spec = jax_registry.SUITES["ncfpe2d"]
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_registry.SUITES, "ncfpe2d", dataclasses.replace(
        spec, grid=_toy_grid(NC_TOY), models={"fno": lambda: JNIOFNO2D(**SMALL_FNO, l_min=L_MIN)}))
    out = io.StringIO()
    try:
        for stage in ("train", "eval"):
            mp.setattr("sys.argv", ["run", "--suite", "ncfpe2d", "--model", "fno", "--stage",
                                    stage, "--workdir", w, "--epochs", "2"])
            with contextlib.redirect_stdout(out):
                jax_run.main()
    finally:
        mp.undo()
    printed = out.getvalue()
    return w, json.loads(printed[printed.rindex("\n{\n") + 1:])


def _small_nc_spec():
    return dataclasses.replace(
        registry.SUITES["ncfpe2d"], grid=_toy_grid(NC_TOY),
        models={"fno": lambda **kw: NIOFNO2D(**SMALL_FNO, l_min=L_MIN, **kw)})


def test_ncfpe2d_cli_trains_and_evaluates_the_fno_model(jax_nc_workdir, tmp_path, monkeypatch):
    """``--suite ncfpe2d --model fno --stage train`` (the suite's batch of 4, lr 5e-4,
    ``c4_vector``, float32 inputs) then ``--stage eval`` on the CPU: the JAX CLI's
    layout, records and report keys, predictions in the force's physical units."""
    jw, jreport = jax_nc_workdir
    w = str(tmp_path)
    _write_nc_archives(w)
    monkeypatch.setitem(registry.SUITES, "ncfpe2d", _small_nc_spec())
    res = main(["--suite", "ncfpe2d", "--model", "fno", "--stage", "train", "--workdir", w,
                "--epochs", "2", "--device", "cpu"])
    assert res.finished and [h["epoch"] for h in res.history] == [2]
    report = main(["--suite", "ncfpe2d", "--model", "fno", "--stage", "eval", "--workdir", w,
                   "--device", "cpu"])
    assert _layout(w) == _layout(jw)
    assert set(report) == REPORT_KEYS | {"figures"} and set(jreport) == REPORT_KEYS
    _assert_figures(report, w, "ncfpe2d", "fno", NC_TEST)
    assert (report["suite"], report["model"], report["n_test"], report["ckpt_epoch"]) == (
        "ncfpe2d", "fno", NC_TEST, 2)
    assert np.isfinite(report["mean_rel_l2_sum"]) and np.isfinite(report["mean_rel_l2_sum_tta"])
    records, jrecords = ([json.loads(r) for r in open(os.path.join(d, "logs", "ncfpe2d_fno.jsonl"))]
                         for d in (w, jw))
    assert [set(r) for r in records] == [set(r) for r in jrecords]
    preds = np.load(os.path.join(w, "eval", "ncfpe2d_fno", "predictions.npy"))
    assert preds.shape == (NC_TEST, NC_TOY, NC_TOY, 2) and np.isfinite(preds).all()
    assert 1e-14 < np.abs(preds).max() < 1e-10  # the force ~1e-12


def test_ncfpe2d_eval_matches_jax_on_jax_weights(jax_nc_workdir, tmp_path):
    """The port's ncfpe2d eval on the ``NIOFNO2D`` weights JAX trained equals JAX's: the
    report with its ``c4_vector`` columns, metrics.csv, the denormalized ``F``
    predictions and the sidecar."""
    jw, jreport = jax_nc_workdir
    w = str(tmp_path)
    shutil.copytree(os.path.join(jw, "data"), os.path.join(w, "data"))
    os.remove(os.path.join(w, "data", "ncfpe2d.stats.npz"))  # the port computes its own
    _port_best_from_jax(os.path.join(jw, "ckpt", "ncfpe2d_fno"),
                        os.path.join(w, "ckpt", "ncfpe2d_fno"),
                        lambda: NIOFNO2D(**SMALL_FNO, l_min=L_MIN, device="cpu"))
    report = evaluate_suite_model(_small_nc_spec(), "fno", w, device="cpu")
    _assert_eval_matches_jax(report, jreport, w, jw, "ncfpe2d", "fno", NC_TEST)


def test_ncfpe2d_unet_checkpoint_eval_matches_jax(tmp_path):
    """The committed ``runs/ckpt/ncfpe2d_unet`` (plain blocks, depth 5, 80x80): JAX's
    eval of it and the port's eval of it through ``from_flax``, on the same synthetic
    80x80 archives at the suite's own config, agree within 2e-3 (``ROADMAP.md`` A.6.1).
    The committed figure (0.189110) needs the real archives (A.8)."""
    jw, w = (str(tmp_path / d) for d in ("jax", "port"))
    _write_nc_archives(jw, n=80, m=6, m_test=2)
    shutil.copytree(os.path.join(jw, "data"), os.path.join(w, "data"))
    ckpt = os.path.join(os.path.dirname(__file__), "..", "runs", "ckpt", "ncfpe2d_unet")
    shutil.copytree(ckpt, os.path.join(jw, "ckpt", "ncfpe2d_unet"))
    jreport = jax_evaluate_suite_model(jax_registry.SUITES["ncfpe2d"], "unet", jw,
                                       make_figures=False)
    spec = registry.SUITES["ncfpe2d"]
    _port_best_from_jax(os.path.join(jw, "ckpt", "ncfpe2d_unet"),
                        os.path.join(w, "ckpt", "ncfpe2d_unet"),
                        lambda: spec.models["unet"](device="cpu"))
    report = evaluate_suite_model(spec, "unet", w, device="cpu")
    assert report["ckpt_epoch"] == 400
    _assert_eval_matches_jax(report, jreport, w, jw, "ncfpe2d", "unet", 2)


def test_cli_defaults_to_cuda(monkeypatch, tmp_path):
    """Without --device the CLI asks for the card, and says how to run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _write_archives(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--suite", "fpe2d", "--stage", "train", "--workdir", str(tmp_path), "--epochs", "1"])
