"""Traffic driver ``predict_closed``: one caller in a closed loop, each call
the program's ``predict_fields(model, sets, grid, batch=batch)`` on the next ``batch``
sets of a seeded host test archive of the configuration's ``m_test`` sets, as the suite's
eval stage reconstructs them; cyclically over the archive.

Set-up makes the model and the archive and warms ``warm_calls`` calls. The window runs
calls until ``--seconds`` have passed and closes with the last call's return. A
reservoir of ``sample_calls`` calls, drawn from the seed, keeps their outputs, which the
reference checks once the window has closed. A traced run then profiles ``trace_calls``
more calls.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import check, common
from benchmark.reference import models
from benchmark.reference.train import predict

WEIGHTS, ARCHIVE, SAMPLE = 1, 4, 5  # seed streams


def setup(r: common.Run):
    cfg = r.config
    weights = common.draw_leaves(models.leaves(cfg), common.generator(r.seed, WEIGHTS, r.device),
                                 r.device)
    model = common.build_model(cfg, weights, r.device)
    sets, _ = common.archive(cfg, cfg["m_test"], r.seed, ARCHIVE, r.device)
    return model, weights, sets, common.grid(cfg)


def calls_on(sets, batch):
    """The archive's rows of call k: the next ``batch`` sets, cyclically."""
    m = sets.shape[0]

    def rows(k):
        s = (k * batch) % m
        return sets[s:s + batch] if s + batch <= m else np.concatenate([sets[s:], sets[:s + batch - m]])

    return rows


def profile_calls(model, rows, grid, batch, n, first, directory, device):
    from torch.profiler import ProfilerActivity, profile

    from blindno_torch.eval.field_eval import predict_fields

    os.makedirs(directory, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        for k in range(first, first + n):
            predict_fields(model, rows(k), grid, batch=batch, device=device)
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))


def run(r: common.Run) -> dict:
    from blindno_torch.eval.field_eval import predict_fields

    tr = r.traffic
    batch = tr["batch"]
    model, weights, sets, grid = setup(r)
    common.stage(r, "model, weights and archive")
    rows = calls_on(sets, batch)
    for k in range(tr["warm_calls"]):
        predict_fields(model, rows(k), grid, batch=batch, device=r.device)
    if r.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(r.device)
    common.stage(r, "warm calls")
    rng = np.random.default_rng(common.seed_of(r.seed, SAMPLE))
    kept, latencies = [], []
    t0 = time.perf_counter()
    setup_s = t0 - r.t_start
    k = tr["warm_calls"]
    now = t0
    while now - t0 < r.seconds:
        t = time.perf_counter()
        out = predict_fields(model, rows(k), grid, batch=batch, device=r.device)
        now = time.perf_counter()
        latencies.append(now - t)
        n = len(latencies)
        # reservoir sampling: every call is kept with the same chance
        if n <= tr["sample_calls"]:
            kept.append((k, out))
        else:
            j = int(rng.integers(0, n))
            if j < tr["sample_calls"]:
                kept[j] = (k, out)
        k += 1
    window_s = now - t0
    device = common.device_info(r.device, r.cell["chips"])
    trace_dir = None
    if r.trace:
        trace_dir = os.path.join(r.tmpdir, "profile")
        profile_calls(model, rows, grid, batch, tr["trace_calls"], k, trace_dir, r.device)
    del model
    common.release(r.device)
    kept.sort(key=lambda kv: kv[0])
    pred = np.concatenate([out for _, out in kept])
    ref = predict(r.config, weights, np.concatenate([rows(c) for c, _ in kept]), grid, r.device,
                  batch)
    numbers = check.eval_numbers(pred, ref)
    calls = len(latencies)
    r.facts.update(kind="eval", calls=calls, batch=batch, window_s=window_s,
                   trace_dir=trace_dir, trace_calls=tr["trace_calls"])
    print(f"[bench] {calls} predict_fields calls in {window_s:.3f} s", flush=True)
    return {"metrics": {"eval_sets_per_s": calls * batch / window_s,
                        "eval_p95_ms": 1e3 * float(np.percentile(latencies, 95)),
                        "setup_s": setup_s},
            "attempted": calls, "failed": 0, "numbers": numbers, "device": device}


def calibrate(r: common.Run, n_calls: int, tf32: bool) -> dict:
    """The program's outputs of ``n_calls`` calls against the reference's, and (with
    ``tf32``) the reference computed with TF32 on against the plain reference."""
    from blindno_torch.eval.field_eval import predict_fields

    batch = r.traffic["batch"]
    model, weights, sets, grid = setup(r)
    rows = calls_on(sets, batch)
    pred = np.concatenate([predict_fields(model, rows(k), grid, batch=batch, device=r.device)
                           for k in range(n_calls)])
    del model
    common.release(r.device)
    inputs = np.concatenate([rows(k) for k in range(n_calls)])
    ref = predict(r.config, weights, inputs, grid, r.device, batch)
    out = {"program": check.eval_numbers(pred, ref)}
    if tf32:
        common.set_precision(r.config, True)
        try:
            out["tf32"] = check.eval_numbers(predict(r.config, weights, inputs, grid, r.device,
                                                     batch), ref)
        finally:
            common.set_precision(r.config)
    return out
