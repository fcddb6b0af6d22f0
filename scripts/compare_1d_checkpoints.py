"""The committed 1-D checkpoints through both packages' suite eval, on full-size archives.

Usage (on a CPU host with both packages; about ten minutes)::

    python scripts/compare_1d_checkpoints.py WORKDIR [--rows fpe1d_nio ...]

It makes the fpe1d, schrodinger1d and gpe1d archives with the JAX package's datagen
stage (``python -m blindno.suites.run --stage datagen``, the suites' own sizes and seeds)
under ``WORKDIR/jax/data`` unless they are there, then evaluates each committed row of
``runs/ckpt`` (the ten 1-D rows of ``runs/RESULTS.md``) twice on the same archives: with
JAX's ``evaluate_suite_model`` (the orbax checkpoint as committed) and with the port's
(the same weights through ``blindno_torch.convert.from_flax``, on the CPU), each with
its own statistics sidecar. It prints one JSON line per row with both ``rel_l2_sum``
figures, plain and with the flip average, and their differences, and exits non-zero
if any pair differs by more than 2e-3.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import blindno.suites.registry as jax_registry  # noqa: E402
import blindno.suites.run as jax_run  # noqa: E402
from blindno.eval.field_eval import evaluate_suite_model as jax_evaluate  # noqa: E402
from blindno.train.checkpoint import load_best as jax_load_best  # noqa: E402
from blindno_torch.convert import from_flax  # noqa: E402
from blindno_torch.eval.field_eval import evaluate_suite_model  # noqa: E402
from blindno_torch.suites import registry  # noqa: E402
from blindno_torch.train.checkpoint import save_best  # noqa: E402

ROWS = ["fpe1d_nio", "fpe1d_fno", "fpe1d_unet", "schrodinger1d_nio", "schrodinger1d_fno",
        "schrodinger1d_unet", "gpe1d_nio", "gpe1d_fno", "gpe1d_unet", "gpe1d_vgk_nio"]
TOL = 2e-3


def _datagen(workdir, suite):
    """The JAX CLI's datagen stage (its ``main`` reads ``sys.argv``)."""
    argv = sys.argv
    sys.argv = ["run", "--suite", suite, "--stage", "datagen", "--workdir", workdir]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            jax_run.main()
    finally:
        sys.argv = argv


def _port_checkpoint(jax_dir, port_dir, factory):
    raw = jax_load_best(jax_dir)
    model = factory(device="cpu")
    model.load_state_dict(from_flax(raw["params"], raw["batch_stats"]))
    save_best(port_dir, dict(model.named_parameters()), dict(model.named_buffers()),
              int(raw["epoch"]), float(raw["test_loss"]))


def compare(workdir, row):
    suite, model = row.rsplit("_", 1)
    jw, pw = os.path.join(workdir, "jax"), os.path.join(workdir, "port")
    for w in (jw, pw):
        os.makedirs(os.path.join(w, "data"), exist_ok=True)
        os.makedirs(os.path.join(w, "ckpt"), exist_ok=True)
    spec, jspec = registry.SUITES[suite], jax_registry.SUITES[suite]
    for name in (spec.train_file, spec.test_file):  # the port's own sidecar beside its links
        link = os.path.join(pw, "data", name)
        if not os.path.exists(link):
            os.symlink(os.path.join(jw, "data", name), link)
    jdir = os.path.join(jw, "ckpt", row)
    if not os.path.exists(jdir):
        shutil.copytree(os.path.join(ROOT, "runs", "ckpt", row), jdir)
    _port_checkpoint(jdir, os.path.join(pw, "ckpt", row), spec.models[model])
    with contextlib.redirect_stdout(io.StringIO()):
        want = jax_evaluate(jspec, model, jw, make_figures=False)
    got = evaluate_suite_model(spec, model, pw, device="cpu")
    out = {"row": row, "n_test": got["n_test"], "ckpt_epoch": got["ckpt_epoch"]}
    for key in ("mean_rel_l2_sum", "mean_rel_l2_sum_tta"):
        out[f"jax_{key}"], out[f"port_{key}"] = want[key], got[key]
        out[f"diff_{key}"] = got[key] - want[key]
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("workdir")
    p.add_argument("--rows", nargs="*", default=ROWS, choices=ROWS)
    args = p.parse_args()
    jw = os.path.join(args.workdir, "jax")
    for suite in ("fpe1d", "schrodinger1d", "gpe1d"):
        spec = jax_registry.SUITES[suite]
        if not os.path.exists(os.path.join(jw, "data", spec.test_file)):
            _datagen(jw, suite)
    worst = 0.0
    for row in args.rows:
        out = compare(args.workdir, row)
        worst = max(worst, abs(out["diff_mean_rel_l2_sum"]), abs(out["diff_mean_rel_l2_sum_tta"]))
        print(json.dumps(out), flush=True)
    print(json.dumps({"worst_abs_diff": worst, "tol": TOL}), flush=True)
    sys.exit(0 if worst <= TOL else 1)


if __name__ == "__main__":
    main()
