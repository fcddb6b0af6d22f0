"""CLI entry point: dataset generation, training, evaluation and the time-error metric
for every suite (counterpart of ``blindno/suites/run.py``).

Usage:
    python -m blindno_torch.suites.run --suite fpe2d --stage datagen --workdir W
    python -m blindno_torch.suites.run --suite fpe2d --model nio --stage train --workdir W
    python -m blindno_torch.suites.run --suite fpe2d --model nio --stage eval --workdir W
    python -m blindno_torch.suites.run --suite fpe2d --model nio --stage time-error --workdir W

The archives are npz files under ``{workdir}/data/`` in the JAX datagen's format (either
package's ``--stage datagen`` makes them: ``--m`` and ``--m-test`` sets, seed ``--seed``
and ``--seed`` + 1000, an existing archive kept unless ``--force``); checkpoints land
under ``ckpt/{suite}_{model}/``, the metrics JSONL and the run's summary under ``logs/``,
and the eval's metrics and predictions and the time-error report under
``eval/{suite}_{model}/``. ``--device`` picks the device (``cuda`` by default).

The train stage also runs data- and tensor-parallel, one process per rank under
torchrun (``--tp K`` shards the FNO layers' channels over K of them; the batch shards
over the rest)::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m blindno_torch.suites.run --suite fpe2d --model nio --stage train --workdir W --tp 2

Each rank takes the card ``LOCAL_RANK``; with ``--device cpu`` the ranks run over gloo.
At ``--tp 1`` a rank count that does not divide the batch trains as JAX's ``data_mesh``
does, on the most ranks that divide it (``--nproc-per-node 3`` on a batch of 32 trains on
two): the others idle until the run ends and exit 0, and rank 0 alone prints and writes
the summary. The other stages run in one process.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from blindno_torch import default_device
from blindno_torch.suites.registry import SUITES

STAGES = ["datagen", "train", "eval", "time-error"]


def _data_path(workdir, name):
    return os.path.join(workdir, "data", name)


def stage_datagen(spec, args):
    os.makedirs(os.path.join(args.workdir, "data"), exist_ok=True)
    dev = default_device(args.device)
    for split, make, m, seed in (("train", spec.datagen_train, args.m or spec.m_train, args.seed),
                                 ("test", spec.datagen_test, args.m_test or spec.m_test,
                                  args.seed + 1000)):
        path = _data_path(args.workdir, getattr(spec, f"{split}_file"))
        if os.path.exists(path) and not args.force:
            print(f"[{spec.name}] {split} set exists: {path}")
            continue
        print(f"[{spec.name}] generating {split} set (m={m}) on {dev}...")
        np.savez(path, **make(seed, m, device=dev))
        print(f"  -> {path}")


def _load_npz(path):
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


def stage_train(spec, args):
    from blindno_torch.parallel.mesh import init_distributed, is_distributed, is_main_process
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
    dev = init_distributed(device=args.device) if is_distributed() else default_device(args.device)
    main = is_main_process()  # asked before the group goes: then every process is its own
    try:
        model = spec.models[args.model](generator=torch.Generator().manual_seed(args.seed),
                                        device=dev)
        if main:
            print(f"[{spec.name}/{args.model}] training {cfg.epochs} epochs on {dev}...")
        # every rank returns once the run's result is in, the idle ones too
        res = train_model(model, data, spec.grid, cfg, device=dev)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if not main:
        return res
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


def stage_time_error(spec, args):
    from blindno_torch.eval.time_error import time_error_suite

    report = time_error_suite(spec, args.model, args.workdir, num_samples=args.m or 100,
                              device=args.device)
    print(json.dumps(report, indent=1))
    return report


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--suite", required=True, choices=sorted(SUITES))
    p.add_argument("--model", default="nio")
    p.add_argument("--stage", required=True, choices=STAGES)
    p.add_argument("--workdir", default="runs")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--m", type=int, default=None,
                   help="datagen: train sets (default: the suite's); time-error: samples "
                        "(default 100)")
    p.add_argument("--m-test", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel factor: shard FNO channel dims over a 'model' "
                        "mesh axis of this many ranks; the batch shards over the "
                        "remaining ranks (data axis). Default: registry config (1).")
    p.add_argument("--force", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="the device to run the stage on (default: cuda)")
    args = p.parse_args(argv)
    spec = SUITES[args.suite]
    if args.stage != "datagen" and args.model not in spec.models:
        p.error(
            f"unknown model {args.model!r} for suite {args.suite!r}; "
            f"choose from: {', '.join(sorted(spec.models))}"
        )
    if args.stage != "train" and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        p.error(f"--stage {args.stage} runs in one process; only the train stage runs "
                "across ranks")
    os.makedirs(os.path.join(args.workdir, "logs"), exist_ok=True)
    return {"datagen": stage_datagen, "train": stage_train, "eval": stage_eval,
            "time-error": stage_time_error}[args.stage](spec, args)


if __name__ == "__main__":
    main()
