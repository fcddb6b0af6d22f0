"""Traffic driver ``train_loop``: one training run through the program's ``train_model``
on a seeded archive, the way ``python -m blindno_torch.suites.run --stage train`` runs
it, with the configuration's ``TrainConfig``.

The harness hands ``train_model`` its own ``draws(epoch, steps)``: each epoch's batches
(positions in the train split), D4 elements and set subsamples, from the seed, so that
the reference can replay them. A draw also stamps the epoch's start. The window opens at
the first epoch after ``warm_epochs`` and closes at the first eval epoch (every
``save_interval``-th) whose record comes at or past ``--seconds``: the harness then
writes ``TrainConfig.stop_file`` and the loop returns after that epoch. The window holds
whole epochs, each eval in it whole.

The first ``checked_steps`` steps are read as the optimizer takes them: a forward hook
reads each step's loss back from the gradient of the model's output (the loop keeps no
step's loss), and an optimizer hook reads the first gradient from Adam's first moment
and the weights after the last checked step. After the window the reference replays
those steps (:func:`benchmark.reference.train.replay`).
"""
from __future__ import annotations

import os
import time

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from benchmark import check, common
from benchmark.reference import models
from benchmark.reference.train import replay, train_split

WEIGHTS, ARCHIVE, DRAWS = 1, 2, 3  # seed streams
# the epoch that TrainConfig.profile_dir traces: train_model's start_epoch + 2, in a run
# that starts at epoch 1
PROFILED_EPOCH = 3


class Draws:
    """The loop's draws from the seed: per epoch a permutation of the train split cut
    into full batches, one D4 element a step, and each step's subsample (L indices drawn
    with replacement, an effective length uniform in [l_min, L)), copied to the device
    once an epoch. Calls ``on_epoch(epoch)`` as each epoch starts."""

    def __init__(self, seed, n_train, batch, n_elements, l_max, l_min, device, on_epoch):
        self.seed, self.n_train, self.batch = seed, n_train, batch
        self.n_elements, self.l_max, self.l_min = n_elements, l_max, l_min
        self.device, self.on_epoch = device, on_epoch
        self.first = None

    def host(self, epoch, steps):
        g = torch.Generator().manual_seed(common.seed_of(self.seed, DRAWS, epoch))
        positions = torch.randperm(self.n_train, generator=g)[: steps * self.batch]
        elements = torch.randint(0, max(self.n_elements, 1), (steps,), generator=g)
        l_eff = torch.randint(self.l_min, max(self.l_max, self.l_min + 1), (steps,), generator=g)
        indices = torch.randint(0, self.l_max, (steps, self.l_max), generator=g)
        masks = torch.arange(self.l_max)[None, :] < l_eff[:, None]
        return positions.reshape(steps, self.batch), elements, indices, masks

    def __call__(self, epoch, steps):
        self.on_epoch(epoch)
        positions, elements, indices, masks = self.host(epoch, steps)
        if self.first is None:
            self.first = (positions, elements, indices, masks)
        idx, msk = indices.to(self.device), masks.to(self.device)
        subs = [(idx[i], msk[i]) for i in range(steps)]
        return positions, (elements.tolist() if self.n_elements else None), subs


class FirstSteps:
    """Reads the program's first ``n`` steps (see the module note)."""

    def __init__(self, model, n):
        self.n = n
        self.names = {id(p): k for k, p in model.named_parameters()}
        self.losses, self.grads, self.params, self.steps = [], None, None, 0
        self.hooks = [model.register_forward_hook(self._forward),
                      register_optimizer_step_post_hook(self._step)]

    def _forward(self, module, args, out):
        if module.training and torch.is_grad_enabled() and len(self.losses) < self.n:
            half = out.numel() / 2
            self.losses.append(None)
            k = len(self.losses) - 1

            def read(grad):
                # d mean((out - y)^2) / d out = 2 (out - y) / N
                self.losses[k] = (grad.double() * half).square().mean()

            out.register_hook(read)

    def _step(self, opt, args, kwargs):
        params = [p for group in opt.param_groups for p in group["params"]]
        if not params or id(params[0]) not in self.names or self.steps >= self.n:
            return
        self.steps += 1
        if self.steps == 1:
            # Adam's first moment after one step is (1 - b1) g; a step that left the
            # state unchanged left none, and reads as a zero gradient
            beta1 = opt.param_groups[0]["betas"][0]
            self.grads = {self.names[id(p)]: (opt.state[p]["exp_avg"].detach() / (1 - beta1)
                                              if "exp_avg" in opt.state[p]
                                              else torch.zeros_like(p))
                          for p in params}
        if self.steps == self.n:
            self.params = {self.names[id(p)]: p.detach().clone() for p in params}

    def done(self):
        return self.steps >= self.n

    def remove(self):
        for h in self.hooks:
            h.remove()
        self.hooks = []

    def result(self, weights):
        if not self.done() or any(v is None for v in self.losses):
            raise RuntimeError(f"the program took {self.steps} of the {self.n} checked steps")
        return {"losses": [float(v) for v in self.losses], "grads": self.grads,
                "change": {k: v - weights[k] for k, v in self.params.items()}}


def setup(r: common.Run):
    """The configuration's model with seeded weights, its archive and grid."""
    cfg = r.config
    weights = common.draw_leaves(models.leaves(cfg), common.generator(r.seed, WEIGHTS, r.device),
                                 r.device)
    model = common.build_model(cfg, weights, r.device)
    inputs, targets = common.archive(cfg, cfg["m_train"], r.seed, ARCHIVE, r.device)
    return model, weights, inputs, targets, common.grid(cfg)


def train_config(r: common.Run, epochs: int, stop_file=None, profile_dir=None):
    from blindno_torch.train.loop import TrainConfig

    t = r.config["train"]
    return TrainConfig(epochs=epochs, batch_size=t["batch_size"], lr=t["lr"],
                       lr_step_epochs=t["lr_step_epochs"], lr_gamma=t["lr_gamma"],
                       save_interval=t["save_interval"], split_seed=t["split_seed"],
                       train_frac=t["train_frac"], reference_denominator=t["reference_denominator"],
                       compress_inputs=t["compress_inputs"], augment=t["augment"],
                       stop_file=stop_file, profile_dir=profile_dir, resume=False)


def warm_eval(model, config, batch, grid, device):
    """One eval-mode forward at the test batches' shape, so that the loop's first eval
    finds its kernels built and its algorithms chosen."""
    h, w = config["grid"]["shape"]
    x = torch.zeros((batch, config["snapshots"], h, w), device=device)
    with torch.inference_mode():
        model(x, torch.as_tensor(grid, device=device))
    common.synchronize(device)


def drive(r: common.Run, epochs: int, window: bool):
    """Set up and run ``train_model``: to the end of the window (``window``), or for
    ``epochs`` epochs. Returns what the readers and the check need."""
    from blindno_torch.data.datasets import SetToFieldData
    from blindno_torch.train.loop import train_model

    cfg, tr = r.config, r.traffic
    t = cfg["train"]
    model, weights, inputs, targets, grid = setup(r)
    common.stage(r, "model, weights and archive")
    n_train = len(train_split(inputs.shape[0], t["train_frac"], t["split_seed"]))
    steps = n_train // t["batch_size"]
    warm_eval(model, cfg, t["batch_size"], grid, r.device)
    first = FirstSteps(model, tr["checked_steps"])
    stamps, records = {}, []
    stop_file = os.path.join(r.tmpdir, "stop")
    profile_dir = os.path.join(r.tmpdir, "profile") if r.trace else None
    window_epoch = tr["warm_epochs"] + 1
    state = {"end": None}

    def on_epoch(epoch):
        stamps[epoch] = time.perf_counter()
        if epoch <= window_epoch:
            common.stage(r, f"epoch {epoch} starts")
        if first.done():
            first.remove()

    def progress(record):
        records.append(record)
        now = time.perf_counter()
        if (window and window_epoch in stamps and record["epoch"] >= window_epoch
                and now - stamps[window_epoch] >= r.seconds and state["end"] is None):
            state["end"] = (record["epoch"], now)
            with open(stop_file, "w"):
                pass

    draws = Draws(r.seed, n_train, t["batch_size"], 8 if t["augment"] == "d4_scalar" else 0,
                  cfg["snapshots"], cfg["model"]["kwargs"]["l_min"], r.device, on_epoch)
    if r.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(r.device)
    train_model(model, SetToFieldData(inputs, targets), grid,
                train_config(r, epochs, stop_file, profile_dir),
                progress=progress, device=r.device, draws=draws)
    first.remove()
    device = common.device_info(r.device, r.cell["chips"])
    program = first.result(weights)
    del model
    common.release(r.device)
    return dict(weights=weights, inputs=inputs, targets=targets, grid=grid, steps=steps,
                n_test=inputs.shape[0] - n_train,
                stamps=stamps, records=records, end=state["end"], device=device,
                program=program, first_draws=draws.first, window_epoch=window_epoch,
                profile_dir=profile_dir)


def reference_numbers(r: common.Run, d: dict, tf32=False, keep=None,
                      dtype=torch.float32) -> dict:
    """The reference's steps on the run's first draws (with TF32 on for the control, or
    a batch cut by ``keep``), and their numbers against the program's."""
    n = r.traffic["checked_steps"]
    common.set_precision(r.config, tf32)
    try:
        ref = replay(r.config, d["weights"], d["inputs"], d["targets"], d["grid"],
                     [t[:n] for t in d["first_draws"]], r.device, keep=keep, dtype=dtype)
    finally:
        common.set_precision(r.config)
    return ref


def run(r: common.Run) -> dict:
    d = drive(r, epochs=10**6, window=True)
    if d["end"] is None:
        raise RuntimeError("the loop returned before the window closed")
    w0, (last_epoch, t_end) = d["window_epoch"], d["end"]
    t = r.config["train"]
    epochs = last_epoch - w0 + 1
    window_s = t_end - d["stamps"][w0]
    sets = epochs * d["steps"] * t["batch_size"]
    ref = reference_numbers(r, d)
    numbers = check.train_numbers(d["program"], ref)
    r.facts.update(kind="train", records=[x for x in d["records"] if x["epoch"] >= w0],
                   stamps=d["stamps"], window=(w0, last_epoch, t_end), steps=d["steps"],
                   batch=t["batch_size"], n_test=d["n_test"],
                   profiled_epoch=PROFILED_EPOCH if r.trace else None,
                   trace_dir=d["profile_dir"])
    return {"metrics": {"train_sets_per_s": sets / window_s,
                        "setup_s": d["stamps"][w0] - r.t_start},
            "attempted": epochs * d["steps"], "failed": 0, "numbers": numbers,
            "device": d["device"]}


def first_steps_numbers(r: common.Run, faults=(), detail=False) -> dict:
    """The program's checked steps against the reference, on one epoch of the cell's
    set-up (no window); then, for the control and each fault named in ``faults``
    (``"tf32"``, ``"half_batch"``), the reference so run against the plain reference;
    with ``detail``, each side's losses and worst leaves, and the program and the plain
    reference against the reference in float64."""
    d = drive(r, epochs=1, window=False)
    ref = reference_numbers(r, d)
    out = {"program": check.train_numbers(d["program"], ref)}
    if detail:
        out["losses"] = {"program": d["program"]["losses"], "reference": ref["losses"]}
        ref64 = reference_numbers(r, d, dtype=torch.float64)
        out["worst"] = {"grads": check.worst_leaves(d["program"], ref, "grads"),
                        "change": check.worst_leaves(d["program"], ref, "change",
                                                     names=check.moved(ref))}
        # the worst compared leaves' gradient share, and their change in float64
        names = [k for k, _, _ in out["worst"]["change"]]
        out["grad_share"] = check.grad_shares(ref, names)
        out["change_f64"] = {k: float(ref64["change"][k].norm()) for k in names}
        out["program_vs_f64"] = check.train_numbers(d["program"], ref64)
        out["reference_vs_f64"] = check.train_numbers(ref, ref64)
    for fault in faults:
        if fault == "tf32":
            other = reference_numbers(r, d, tf32=True)
        elif fault == "half_batch":
            other = reference_numbers(r, d, keep=lambda x, y: (x[: len(x) // 2], y[: len(y) // 2]))
        else:
            raise ValueError(f"unknown fault {fault!r}")
        out[fault] = check.train_numbers(other, ref)
        if detail:
            out["losses"][fault] = other["losses"]
    return out
