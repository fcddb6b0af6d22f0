"""Training throughput of the fpe2d and 1-D models on a CUDA card (counterpart of
``bench.py``'s timed loop, which stays as it is).

``python3 -m blindno_torch.tools.bench_train [--model
nio|unet|fno|attn|fno_attn|trans|trans_attn]`` builds the model, by default ``NIOFP2D`` at
``bench.py``'s config (width 12, 32 modes, 25 basis functions, 100 neurons, 3 layers);
``--model attn`` is ``NIOAttn2D`` at the same config, ``--model fno`` and ``--model
fno_attn`` the FNO-branch ``NIOFNO2D`` and ``NIOFNOAttn2D``, ``--model trans`` and
``--model trans_attn`` the Transolver NIOs ``NIOTrans2D`` and ``NIOTransAttn2D`` (width
12, 32 modes, 3 layers, the Transolver's defaults; ``blindno/suites/registry.py:195-201``),
and ``--model unet`` the fpe2d suite's BlinDNO UNet (``PermInvUNetAttn``: depth 4, width 12, 32 modes;
``blindno/suites/registry.py:196-198``); weights from seed 0. It draws the batch as
``bench.py:128-139`` does (B=4 sets of L=100 snapshots of a 61x61 grid, targets and
inputs standard normal from numpy seed 0, the grid on [-1, 1]^2), and times the
training step of :mod:`blindno_torch.train.step` in float32, in bfloat16 under JAX's
default policy ``all`` and, for the two models with an Encoder2D (``nio``, ``attn``),
in bfloat16 ``encoder_bn32`` (the policy casts only the batch of the others):
each mode from fresh weights, 3 warm-up steps and then the timed steps with a
synchronize before each clock read, every step with a fresh set subsample. Beside each
mode's figure, ``steps_per_sec_scanned_<mode>`` is the same step as
``TrainConfig(epoch_scan=True)`` runs it, the counterpart of ``bench.py``'s
``steps_per_sec_scanned`` (its step body scanned over the step keys with no dispatch per
step, ``bench.py:232-263``): the epoch program of :mod:`blindno_torch.train.scan` over
the batch, one CUDA graph of the step replayed once a step
(:func:`scanned_steps_per_sec`). TF32 stays off, as the reference runs its products at
float32 HIGHEST. It prints one JSON line.

``--suite fpe1d`` or ``--suite gpe1d`` times the 1-D suite's NIO, FNO-branch NIO and
UNet (``--model nio|fno|unet`` picks one) in float32 as the suites registry builds them,
on a batch of the suite's size (:data:`BATCHES_1D`: 32 sets of 100 snapshots of 80
points, or of 101 of 128; numpy seed 0, the grid on [0, 1]).
``chip_smoke.py`` calls :func:`steps_per_sec`, :func:`scanned_steps_per_sec`,
:func:`fresh_model` and :func:`bench_batch`.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

CONFIG = dict(width=12, modes=32, n_basis=25, neurons=100, fno_layers=3)  # bench.py:127
UNET_CONFIG = dict(input_size=(61, 61), depth=4, width=12, fno_modes=32, head_dims=(1, 1),
                   subsample=True)  # blindno/suites/registry.py:196-198
# blindno/suites/registry.py:195,199-201: the FNO-branch and Transolver NIOs
FNO_CONFIG = dict(width=12, modes=32, fno_layers=3)
BATCH = dict(b=4, l=100, n=61)                                            # bench.py:133-135
# compute mode -> (compute_dtype, amp_policy) of train_step
MODES = {"f32": (None, "encoder_bn32"), "bf16_encoder_bn32": ("bfloat16", "encoder_bn32"),
         "bf16_all": ("bfloat16", "all")}
ENCODER_MODES, OTHER_MODES = ("f32", "bf16_encoder_bn32", "bf16_all"), ("f32", "bf16_all")
# --model -> (class name, config, compute modes)
MODELS = {"nio": ("NIOFP2D", CONFIG, ENCODER_MODES),
          "unet": ("PermInvUNetAttn", UNET_CONFIG, OTHER_MODES),
          "fno": ("NIOFNO2D", FNO_CONFIG, OTHER_MODES),
          "attn": ("NIOAttn2D", CONFIG, ENCODER_MODES),
          "fno_attn": ("NIOFNOAttn2D", FNO_CONFIG, OTHER_MODES),
          "trans": ("NIOTrans2D", FNO_CONFIG, OTHER_MODES),
          "trans_attn": ("NIOTransAttn2D", FNO_CONFIG, OTHER_MODES)}
# the 1-D suites' training batches (blindno/suites/registry.py:77-159: batch 32; fpe1d
# sets of 100 snapshots of 80 points and two target fields, gpe1d 101 snapshots of 128
# points and one field) and the models timed on them
BATCHES_1D = {"fpe1d": dict(b=32, l=100, n=80, fields=2),
              "gpe1d": dict(b=32, l=101, n=128, fields=1)}
MODELS_1D = ("nio", "fno", "unet")
WARMUP, STEPS = 3, 10


def bench_batch(device, suite="fpe2d"):
    """``bench.py``'s batch: x (B, L, n, n), y (B, n, n, 2), grid (n, n, 2); or a 1-D
    suite's: x (B, L, n), y (B, n, fields), grid (n, 1)."""
    rng = np.random.default_rng(0)
    if suite in BATCHES_1D:
        b, l, n, fields = BATCHES_1D[suite].values()
        x = rng.standard_normal((b, l, n)).astype(np.float32)
        y = rng.standard_normal((b, n, fields)).astype(np.float32)
        grid = np.linspace(0.0, 1.0, n, dtype=np.float32).reshape(n, 1)
        return tuple(torch.tensor(a, device=device) for a in (x, y, grid))
    b, l, n = BATCH["b"], BATCH["l"], BATCH["n"]
    x = rng.standard_normal((b, l, n, n)).astype(np.float32)
    y = rng.standard_normal((b, n, n, 2)).astype(np.float32)
    gx, gy = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n), indexing="ij")
    grid = np.stack([gx, gy], 2).astype(np.float32)
    return tuple(torch.tensor(a, device=device) for a in (x, y, grid))


def fresh_model(device, model="nio", suite="fpe2d"):
    """The model of :data:`MODELS` at its config, or a 1-D suite's model as the suites
    registry builds it; weights from seed 0, in train mode."""
    g = torch.Generator().manual_seed(0)
    if suite in BATCHES_1D:
        from blindno_torch.suites.registry import SUITES

        return SUITES[suite].models[model](generator=g, device=device).train()
    from blindno_torch.models import blindno_unet, nio2d

    name, config, _ = MODELS[model]
    cls = getattr(blindno_unet if model == "unet" else nio2d, name)
    return cls(**config, generator=g, device=device).train()


def steps_per_sec(compute_dtype=None, model="nio", suite="fpe2d", amp_policy="encoder_bn32",
                  figures=False):
    """Training steps per second of ``model`` (a key of :data:`MODELS`, or of a 1-D
    suite's models) on the card in one mode, from fresh weights: WARMUP steps, then STEPS
    timed on the host clock between two synchronizes. With ``figures``, returns (steps
    per second, the host's ms to enqueue one step, the step)."""
    from blindno_torch.train.step import make_optimizer, train_step

    model = fresh_model("cuda", model, suite)
    opt = make_optimizer(model)
    x, y, grid = bench_batch("cuda", suite)
    gen = torch.Generator(device="cuda").manual_seed(1)
    step = lambda: train_step(model, opt, x, y, grid, generator=gen, compute_dtype=compute_dtype,
                              amp_policy=amp_policy)
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        loss = step()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not torch.isfinite(loss):
        raise RuntimeError(f"bench_train: {compute_dtype or 'float32'} loss is {loss.item()}")
    if figures:
        return STEPS / wall, 1e3 * enqueue / STEPS, step
    return STEPS / wall


def scanned_steps_per_sec(compute_dtype=None, model="nio", suite="fpe2d",
                          amp_policy="encoder_bn32", figures=False):
    """Training steps per second of the step of :func:`steps_per_sec` as
    ``TrainConfig(epoch_scan=True)`` runs it on the card: the epoch program
    (:class:`~blindno_torch.train.scan.EpochProgram`) over the batch alone, each step
    gathering it whole at the program's counter, a fresh set subsample a step from the
    graph's registered generator. One epoch of STEPS steps warms up, captures and
    replays; the next epoch's STEPS replays are timed on the host clock between two
    synchronizes. With ``figures``, returns (steps per second, the host's ms to enqueue
    one replayed step, a function that runs one more replayed epoch)."""
    from blindno_torch.train.scan import EpochProgram
    from blindno_torch.train.step import make_optimizer

    net = fresh_model("cuda", model, suite)
    opt = make_optimizer(net)
    x, y, grid = bench_batch("cuda", suite)
    gen = torch.Generator(device="cuda").manual_seed(1)
    program = EpochProgram(net, opt, x, y, grid, STEPS, x.shape[0], compute_dtype=compute_dtype,
                           amp_policy=amp_policy, generator=gen)
    positions = np.tile(np.arange(x.shape[0]), (STEPS, 1))

    def epoch():
        program.load(positions, None, None, opt.defaults["lr"])
        return program.run()

    epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = epoch()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not torch.isfinite(loss):
        raise RuntimeError(f"bench_train: scanned {compute_dtype or 'float32'} loss is {loss.item()}")
    if program.replays != 2 * STEPS - 1:
        raise RuntimeError(f"bench_train: {program.replays} replays, want {2 * STEPS - 1}")
    if figures:
        return STEPS / wall, 1e3 * enqueue / STEPS, epoch
    return STEPS / wall


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--suite", choices=["fpe2d", *BATCHES_1D], default="fpe2d")
    p.add_argument("--model", choices=sorted(MODELS), default=None,
                   help="default: nio for fpe2d, each of nio, fno and unet for a 1-D suite")
    args = p.parse_args()
    if args.suite in BATCHES_1D and args.model not in (None, *MODELS_1D):
        p.error(f"--suite {args.suite} times --model nio, fno or unet")
    if not torch.cuda.is_available():
        raise SystemExit("bench_train: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    name, power = (s.strip() for s in smi.stdout.strip().splitlines()[0].split(","))
    if args.suite in BATCHES_1D:
        models = [args.model] if args.model else list(MODELS_1D)
        result = {m: steps_per_sec(None, m, args.suite) for m in models}
        scanned = {m: scanned_steps_per_sec(None, m, args.suite) for m in models}
        print(json.dumps({"steps_per_sec_f32": result, "steps_per_sec_scanned_f32": scanned,
                          "suite": args.suite,
                          "batch": BATCHES_1D[args.suite], "timed_steps": STEPS,
                          "device": name, "power_limit": power}), flush=True)
        return
    args.model = args.model or "nio"
    cls_name, config, modes = MODELS[args.model]
    result = {}
    for mode in modes:
        compute_dtype, policy = MODES[mode]
        result[f"steps_per_sec_{mode}"] = steps_per_sec(compute_dtype, args.model,
                                                        amp_policy=policy)
        result[f"steps_per_sec_scanned_{mode}"] = scanned_steps_per_sec(
            compute_dtype, args.model, amp_policy=policy)
    print(json.dumps({**result, "model": args.model, "class": cls_name, "config": config,
                      "batch": BATCH, "timed_steps": STEPS, "device": name,
                      "power_limit": power}), flush=True)


if __name__ == "__main__":
    main()
