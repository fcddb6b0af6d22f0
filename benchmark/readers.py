"""What the per-layer readers under ``metrics/`` share: the trace a run wrote, and the
configuration's analytic operations. A reader returns None where it finds nothing to
read, and the harness then leaves its metric out."""
from __future__ import annotations

import math

from benchmark import flops, trace
from benchmark.kernel_bounds import PEAK_F32_FLOP_S, layer_bound


def run_trace(r):
    """The run's profiler trace, read once; None where the run wrote none."""
    if "trace" not in r.facts:
        d = r.facts.get("trace_dir")
        r.facts["trace"] = trace.load_dir(d) if d else None
    return r.facts["trace"]


def model_ops(r, batch):
    return r.flops.model_ops(r.config, batch, r.config["snapshots"])


def idle_pct(r):
    t = run_trace(r)
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def is_fno2d(name):
    return trace.kernel_name(name).startswith("fno2d_")


def fno2d_roofline_pct(r, batch):
    """The least time of the traced ``fno2d_layer`` calls (one a launch of its first
    stage, at the configuration's layer shapes in order) over the device time of the
    ``fno2d_*`` kernels."""
    t = run_trace(r)
    if t is None:
        return None
    calls = sum(trace.kernel_name(n).startswith("fno2d_forward_transform") for _, _, n in t.device)
    shapes = model_ops(r, batch)[1]
    if not calls or not shapes or calls % len(shapes):
        return None
    bound_s = sum(layer_bound(shapes[i % len(shapes)], True)["bound_ms"] for i in range(calls)) / 1e3
    return 100.0 * bound_s / t.busy_s(is_fno2d)


def train_mfu_pct(r):
    """Operations of the window's unprofiled epochs (their steps, and the eval's
    forwards in an eval epoch) over their time, over the f32 peak."""
    f = r.facts
    w0, last, t_end = f["window"]
    ops = model_ops(r, f["batch"])[0]
    step, fwd = flops.train_flops(ops), flops.forward_flops(ops)
    eval_batches = math.ceil(f["n_test"] / f["batch"])
    every = r.config["train"]["save_interval"]
    work = seconds = 0.0
    for e in range(w0, last + 1):
        if e == f["profiled_epoch"]:
            continue
        seconds += (f["stamps"][e + 1] if e < last else t_end) - f["stamps"][e]
        work += step * f["steps"] + (fwd * eval_batches if e % every == 0 else 0.0)
    if seconds <= 0:
        return None
    return 100.0 * work / seconds / PEAK_F32_FLOP_S


def eval_mfu_pct(r):
    f = r.facts
    fwd = flops.forward_flops(model_ops(r, f["batch"])[0])
    return 100.0 * fwd * f["calls"] / f["window_s"] / PEAK_F32_FLOP_S
