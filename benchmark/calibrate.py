"""Readings from which a cell's limits are set (``benchmark/limits/<cell>.json``): the
numbers that decide ``correct`` for the program's timed path on many seeds, and for the
control (the reference with TF32 on, the nearest precision below float32 with TF32 off)
and planted faults on a few, all in one process and with no measured window.

    python3 -m benchmark.calibrate --workload fpe2d_unet.train --seeds 1 2 3 --faults 2

Prints one JSON line a seed. Training cells read the loop's checked steps (one epoch of
``train_model``); eval cells ``sample_calls`` calls of ``predict_fields``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import tempfile
import time

import torch

from benchmark import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3,
                    help="read the control and the faults on the first this many seeds")
    ap.add_argument("--detail", type=int, default=0,
                    help="training cells: the losses, the worst leaves and float64 readings "
                         "on the first this many seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[calibrate] no CUDA card", file=sys.stderr)
        return 2
    spec = common.benchmark_spec()
    cell, config, traffic, limits = common.cell_files(spec, args.workload)
    driver = importlib.import_module(f"benchmark.traffic.{traffic['driver']}")
    for i, seed in enumerate(args.seeds):
        with tempfile.TemporaryDirectory(prefix="calibrate_") as tmp:
            r = common.Run(cell=cell, config=config, traffic=traffic, limits=limits, seed=seed,
                           seconds=0.0, trace=False, device=torch.device("cuda", 0), tmpdir=tmp,
                           t_start=time.perf_counter(), flops=common.flops_module(config))
            common.set_precision(config)
            t0 = time.perf_counter()
            if traffic["driver"] == "train_loop":
                out = driver.first_steps_numbers(r, ("tf32", "half_batch") if i < args.faults else (),
                                                 detail=i < args.detail)
            else:
                out = driver.calibrate(r, traffic["sample_calls"], tf32=i < args.faults)
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
        common.release(r.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
