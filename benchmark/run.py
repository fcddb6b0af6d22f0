"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic and limits are found by name from
``BENCHMARK.json`` (``benchmark/configs``, ``benchmark/traffic``, ``benchmark/limits``).
The traffic file names the driver under ``benchmark/traffic`` that sets up the program,
warms it, runs the window and checks its output against the plain reference. With
``--trace 0`` the result carries the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, each read by ``benchmark/metrics/<metric>.py``.

The run exits non-zero and prints no result without as many CUDA cards as the cell
asks for, or when the process holds a module of JAX or of the JAX package.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import torch  # noqa: E402

from benchmark import check, common  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "blindno")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX's or the JAX package's, compared
    whole (``blindno_torch`` is the port, not ``blindno``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` False) or per-layer metrics: those that
    list the cell, or, without a list, those of every cell that reports what they move."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def reader(name: str):
    path = common.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def execute(r: common.Run, spec: dict) -> dict:
    """Drive the cell and assemble its result (without printing it)."""
    driver = importlib.import_module(f"benchmark.traffic.{r.traffic['driver']}")
    common.stage(r, "imports")
    common.set_precision(r.config)
    out = driver.run(r)
    correct, checks = check.verdict(out["numbers"], r.limits)
    metrics = {}
    for m in cell_metrics(spec, r.cell["name"], r.trace):
        value = out["metrics"].get(m["name"]) if not r.trace else reader(m["name"])(r)
        if value is None and not r.trace:
            raise RuntimeError(f"the driver measured no {m['name']}")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": out["device"]}
    if r.trace:
        from benchmark.readers import run_trace

        t = run_trace(r)
        if t is not None:
            result["device"].update(busy_s=t.busy_s(), window_s=t.window_s)
            result["breakdown"] = {"device_ops": [list(kv) for kv in t.device_ops()],
                                   "idle_gaps": [list(kv) for kv in t.idle_gaps()]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = common.benchmark_spec()
    cell, config, traffic, limits = common.cell_files(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[bench] {args.workload} needs {cell['chips']} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    # one host thread for torch's own CPU work: the cells' host time is the program's
    # enqueue, which other threads of the process would only contend with
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        r = common.Run(cell=cell, config=config, traffic=traffic, limits=limits, seed=args.seed,
                       seconds=args.seconds, trace=bool(args.trace),
                       device=torch.device("cuda", 0), tmpdir=tmp, t_start=T_START,
                       flops=common.flops_module(config))
        result = execute(r, spec)
    bad = forbidden_modules()
    if bad:
        print(f"[bench] the run loaded {bad}: the port must not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
