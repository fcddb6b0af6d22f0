"""What every cell shares: the run's arguments and files, seeded weights and archives
made on the device, and the device's description.

Nothing here imports the program at module level: a driver imports what it drives.
"""
from __future__ import annotations

import gc
import importlib
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
CHUNK_SETS = 64  # sets drawn on the device per call while an archive is made


def load_json(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclass
class Run:
    """One run of one cell: its entries in BENCHMARK.json, its configuration and traffic
    files, the arguments, and what the driver records for the readers."""

    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    tmpdir: str
    t_start: float
    flops: object = None  # the configuration's module of analytic operations
    facts: dict = field(default_factory=dict)  # what the readers read


def cell_files(spec: dict, name: str) -> tuple[dict, dict, dict, dict]:
    """(cell, configuration, traffic, limits) of the cell ``name``, each found by its
    name in BENCHMARK.json."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(ROOT / entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{name}.json")
    return cell, config, traffic, limits


def flops_module(config: dict):
    return importlib.import_module(f"benchmark.configs.{config['name']}")


def seed_of(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of draws of the run's ``seed``."""
    return int(np.random.SeedSequence([seed, *stream]).generate_state(2, np.uint64)[0] >> 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed, stream))


def draw_leaves(leaves: dict, gen: torch.Generator, device) -> dict:
    """Seeded float32 tensors for the model's leaves (``{name: (shape, kind)}``), from
    one uniform draw over all of them on ``device``: He-uniform weights (bound
    sqrt(6 / fan_in)), biases and means in +/-0.1, norm scales 1 +/- 0.1, running
    variances in [0.5, 1.5), spectral weights U[0, 1) / (Cin * Cout) as published, and
    zero batch counts."""
    sizes = [math.prod(shape) for shape, _ in leaves.values()]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, (shape, kind)), n in zip(leaves.items(), sizes):
        v = u[off:off + n].reshape(shape)
        off += n
        if kind in ("weight", "frozen_weight"):
            t = (2 * v - 1) * math.sqrt(6.0 / math.prod(shape[1:]))
        elif kind == "weight_transposed":
            t = (2 * v - 1) * math.sqrt(6.0 / shape[0])
        elif kind in ("bias", "frozen_bias", "scalar", "running_mean"):
            t = (2 * v - 1) * 0.1
        elif kind == "norm_weight":
            t = 1 + (2 * v - 1) * 0.1
        elif kind == "running_var":
            t = 0.5 + v
        elif kind == "spectral":
            t = v / (shape[0] * shape[1])
        elif kind == "count":
            t = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            raise ValueError(f"leaf {name}: unknown kind {kind!r}")
        out[name] = t.clone()
    return out


def archive(config: dict, m: int, seed: int, stream: int, device) -> tuple[np.ndarray, np.ndarray]:
    """A host archive of ``m`` standardized sets, drawn N(0, 1) on ``device`` from the
    seed, :data:`CHUNK_SETS` sets a call: snapshots (m, L, H, W) and targets
    (m, H, W, F), float32."""
    gen = generator(seed, stream, device)
    h, w = config["grid"]["shape"]
    inputs = np.empty((m, config["snapshots"], h, w), np.float32)
    targets = np.empty((m, h, w, config["fields"]), np.float32)
    for s in range(0, m, CHUNK_SETS):
        n = min(CHUNK_SETS, m - s)
        inputs[s:s + n] = torch.randn((n, *inputs.shape[1:]), generator=gen, device=device).cpu().numpy()
        targets[s:s + n] = torch.randn((n, *targets.shape[1:]), generator=gen, device=device).cpu().numpy()
    return inputs, targets


def grid(config: dict) -> np.ndarray:
    """The suite's grid (H, W, 2): linspace(low, high) on each axis, ``ij`` order."""
    h, w = config["grid"]["shape"]
    lo, hi = config["grid"]["low"], config["grid"]["high"]
    gx, gy = np.meshgrid(np.linspace(lo, hi, h, dtype=np.float32),
                         np.linspace(lo, hi, w, dtype=np.float32), indexing="ij")
    return np.stack([gx, gy], axis=2)


def build_model(config: dict, weights: dict, device):
    """The program's model of the configuration, with the benchmark's weights loaded
    (every leaf, strictly), in eval mode on ``device``."""
    module, cls = config["model"]["class"].rsplit(".", 1)
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config["model"]["kwargs"].items()}
    model = getattr(importlib.import_module(module), cls)(**kwargs, device=device)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def set_precision(config: dict, tf32: bool = False):
    """The configuration's precision: float32 with TF32 off for matmul and cuDNN (the
    control turns it on)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def device_info(device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def stage(r: "Run", name: str):
    """Note on standard error how long the run has taken by the end of set-up stage
    ``name``: where set-up time goes."""
    print(f"[setup] {name} {time.perf_counter() - r.t_start:.3f} s", file=sys.stderr, flush=True)


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def release(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
