"""CLI entry point: training and evaluation of the ported suites (counterpart of
``blindno/suites/run.py``).

Usage:
    python -m blindno_torch.suites.run --suite fpe2d --model nio --stage train --workdir W
    python -m blindno_torch.suites.run --suite fpe2d --model nio --stage eval --workdir W

The archives are the JAX datagen's npz files under ``{workdir}/data/`` (made with
``python -m blindno.suites.run --suite fpe2d --stage datagen``); checkpoints land under
``ckpt/{suite}_{model}/``, the metrics JSONL and the run's summary under ``logs/``, and
the eval's metrics and predictions under ``eval/{suite}_{model}/``. ``--device`` picks
the device (``cuda`` by default). A suite, model or stage that is not ported yet exits
non-zero naming its ``ROADMAP.md`` item.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from blindno_torch import default_device
from blindno_torch.suites.registry import NOT_PORTED, SUITES

STAGES = ["datagen", "train", "eval", "time-error"]


def _data_path(workdir, name):
    return os.path.join(workdir, "data", name)


def _load_npz(path):
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


def stage_train(spec, args):
    from blindno_torch.train.loop import train_model

    data = spec.loader(_load_npz(_data_path(args.workdir, spec.train_file)))
    cfg = dataclasses.replace(
        spec.train_cfg,
        epochs=args.epochs or spec.train_cfg.epochs,
        ckpt_dir=os.path.join(args.workdir, "ckpt", f"{spec.name}_{args.model}"),
        log_path=os.path.join(args.workdir, "logs", f"{spec.name}_{args.model}.jsonl"),
        seed=args.seed,
        **({"tp": args.tp} if args.tp else {}),
    )
    dev = default_device(args.device)
    model = spec.models[args.model](generator=torch.Generator().manual_seed(args.seed),
                                    device=dev)
    print(f"[{spec.name}/{args.model}] training {cfg.epochs} epochs on {dev}...")
    res = train_model(model, data, spec.grid, cfg, device=dev)
    print(f"[{spec.name}/{args.model}] best test rel-L2 (sum over fields): {res.best_test_loss:.6f}")
    summary_path = os.path.join(args.workdir, "logs", f"{spec.name}_{args.model}_summary.json")
    with open(summary_path, "w") as fh:
        json.dump({"suite": spec.name, "model": args.model,
                   "best_test_loss": res.best_test_loss, "history": res.history}, fh, indent=1)
    return res


def stage_eval(spec, args):
    from blindno_torch.eval.field_eval import evaluate_suite_model

    report = evaluate_suite_model(spec, args.model, args.workdir, device=args.device)
    print(json.dumps(report, indent=1))
    return report


def _not_ported(args):
    """(what, ROADMAP.md item) for a suite, model or stage the port does not run yet,
    or None."""
    item = NOT_PORTED["stages"].get(args.stage)
    if item:
        return f"stage {args.stage!r}", item
    item = NOT_PORTED["suites"].get(args.suite)
    if item:
        return f"suite {args.suite!r}", item
    item = NOT_PORTED["models"].get(args.suite, {}).get(args.model)
    if item:
        return f"model {args.model!r} of suite {args.suite!r}", item
    return None


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--suite", required=True,
                   choices=sorted({*SUITES, *NOT_PORTED["suites"]}))
    p.add_argument("--model", default="nio")
    p.add_argument("--stage", required=True, choices=STAGES)
    p.add_argument("--workdir", default="runs")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--m", type=int, default=None)
    p.add_argument("--m-test", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel factor (only 1 is ported; ROADMAP.md A.10)")
    p.add_argument("--force", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="the device to train or evaluate on (default: cuda)")
    args = p.parse_args(argv)
    what = _not_ported(args)
    if what:
        sys.exit(f"blindno_torch: {what[0]} is not ported yet (ROADMAP.md {what[1]}); "
                 f"the JAX CLI runs it: python -m blindno.suites.run")
    spec = SUITES[args.suite]
    if args.model not in spec.models:
        p.error(
            f"unknown model {args.model!r} for suite {args.suite!r}; "
            f"choose from: {', '.join(sorted(spec.models))}"
        )
    os.makedirs(os.path.join(args.workdir, "logs"), exist_ok=True)
    return {"train": stage_train, "eval": stage_eval}[args.stage](spec, args)


if __name__ == "__main__":
    main()
