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
- a suite, model or stage that is not ported exits non-zero naming its ROADMAP item.
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
from blindno.models.nio2d import NIOFP2D as JNIOFP2D
from blindno.train.checkpoint import load_best as jax_load_best
from blindno_torch.convert import from_flax
from blindno_torch.eval.field_eval import FIGURES_NOT_PORTED, evaluate_suite_model
from blindno_torch.models.nio2d import NIOFP2D
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
    directory in JAX, one file in the port) and the figures left out."""
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
    assert report["figures"] == FIGURES_NOT_PORTED
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


def _port_best_from_jax(jax_ckpt_dir, ckpt_dir):
    raw = jax_load_best(jax_ckpt_dir)
    state = from_flax(raw["params"], raw["batch_stats"])
    model = NIOFP2D(**CFG, l_min=L_MIN, device="cpu")
    model.load_state_dict(state)
    params = dict(model.named_parameters())
    stats = dict(model.named_buffers())
    return save_best(ckpt_dir, params, stats, int(raw["epoch"]), float(raw["test_loss"]))


def _read_csv(path):
    with open(path) as fh:
        rows = list(csv.reader(fh))
    return rows[0], np.array(rows[1:], np.float64)


def test_evaluate_suite_model_matches_jax_on_jax_weights(jax_workdir, tmp_path):
    jw, jreport = jax_workdir
    w = str(tmp_path)
    shutil.copytree(os.path.join(jw, "data"), os.path.join(w, "data"))
    os.remove(os.path.join(w, "data", "fpe2d.stats.npz"))  # the port computes its own
    _port_best_from_jax(os.path.join(jw, "ckpt", "fpe2d_nio"), os.path.join(w, "ckpt", "fpe2d_nio"))
    spec = dataclasses.replace(registry.SUITES["fpe2d"],
                               models={"nio": lambda **kw: NIOFP2D(**CFG, l_min=L_MIN, **kw)})
    report = evaluate_suite_model(spec, "nio", w, device="cpu")
    assert set(report) == set(jreport) | {"figures"}
    for k in ("suite", "model", "n_test", "ckpt_epoch", "ckpt_test_loss"):
        assert report[k] == jreport[k], k
    for k in ("mean_rel_l2_per_field", "mean_rel_l2_per_field_tta", "mean_rel_l2_sum",
              "mean_rel_l2_sum_tta"):
        np.testing.assert_allclose(report[k], jreport[k], rtol=EVAL_TOL, err_msg=k)
    # the TTA column is its own number, not the single pass again
    assert report["mean_rel_l2_sum_tta"] != report["mean_rel_l2_sum"]

    out, jout = (os.path.join(d, "eval", "fpe2d_nio") for d in (w, jw))
    (head, rows), (jhead, jrows) = (_read_csv(os.path.join(d, "metrics.csv")) for d in (out, jout))
    assert head == jhead and rows.shape == jrows.shape == (M_TEST, 4)
    np.testing.assert_allclose(rows, jrows, rtol=EVAL_TOL, atol=2e-6)
    preds, jpreds = (np.load(os.path.join(d, "predictions.npy")) for d in (out, jout))
    for f in range(2):  # each field in its own physical units
        scale = np.abs(jpreds[..., f]).max()
        np.testing.assert_allclose(preds[..., f], jpreds[..., f], rtol=EVAL_TOL,
                                   atol=EVAL_TOL * scale, err_msg=f"field {f}")
    # the sidecar of train statistics equals the JAX package's
    with np.load(os.path.join(w, "data", "fpe2d.stats.npz")) as a, \
            np.load(os.path.join(jw, "data", "fpe2d.stats.npz")) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


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
    assert report["n_test"] == M_TEST and report["ckpt_epoch"] == 1
    assert np.isfinite(report["mean_rel_l2_sum"]) and np.isfinite(report["mean_rel_l2_sum_tta"])
    preds = np.load(os.path.join(w, "eval", "fpe2d_unet", "predictions.npy"))
    assert preds.shape == (M_TEST, 61, 61, 2) and np.isfinite(preds).all()


NOT_PORTED_CASES = (
    [(["--suite", "fpe2d", "--stage", stage], item)
     for stage, item in registry.NOT_PORTED["stages"].items()]
    + [(["--suite", suite, "--stage", "train"], item)
       for suite, item in registry.NOT_PORTED["suites"].items()]
    + [(["--suite", suite, "--model", model, "--stage", "eval"], item)
       for suite, models in registry.NOT_PORTED["models"].items()
       for model, item in models.items()])


@pytest.mark.parametrize("argv,item", NOT_PORTED_CASES,
                         ids=[" ".join(a[1::2]) for a, _ in NOT_PORTED_CASES])
def test_unported_parts_exit_nonzero_naming_their_item(argv, item, tmp_path):
    with pytest.raises(SystemExit) as exc:
        main(argv + ["--workdir", str(tmp_path), "--device", "cpu"])
    assert exc.value.code not in (0, None)
    assert f"ROADMAP.md {item}" in str(exc.value.code)
    assert not os.listdir(tmp_path)


def test_cli_defaults_to_cuda(monkeypatch, tmp_path):
    """Without --device the CLI asks for the card, and says how to run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _write_archives(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--suite", "fpe2d", "--stage", "train", "--workdir", str(tmp_path), "--epochs", "1"])
