"""The training loop (counterpart of ``blindno/train/loop.py``): Adam with StepLR(100
epochs, x0.5) on the global step, MSE, symmetry augmentation, periodic per-field rel-L2
test metrics, best and resume checkpoints, early stop, preemption and a divergence
guard.

The train and test splits live on the device as whole tensors (bfloat16 inputs under
``compress_inputs``; targets float32); each batch is an ``index_select`` on the device,
cast back to float32. Nothing is copied from the host inside an epoch and nothing is
read back before its end: the epoch's order and its group elements are drawn at its
start from a CPU generator, the set subsamples from a generator on the device, and
the step losses are stacked and read once. Each step's body is
:func:`blindno_torch.train.step.train_step`.

With ``epoch_scan=True`` each epoch is one program over static device buffers instead,
as JAX's ``lax.scan`` epoch (:mod:`blindno_torch.train.scan`): on a CUDA card, after the
run's first step (its first eleven across ranks), one captured CUDA graph of the step
replayed once a step; on the CPU (``device="cpu"``) the same program uncaptured. It
takes the per-step loop's draws and updates and saves the same checkpoints, in one
process or across ranks (on the card over NCCL, whose collectives the graph captures).

Run as several ranks (torchrun's ``WORLD_SIZE`` > 1, or in a process group already up),
the loop trains data- and tensor-parallel as JAX's does on a ``(data, model)`` mesh
(``blindno/train/loop.py:275-295``): the model is sharded and wrapped by
:func:`blindno_torch.parallel.distribute`, every rank draws the same batches, group
elements and set subsamples from the same seed and takes its rows of each batch, the
step losses and eval sums are reduced over ``data``, and rank 0's findings (the losses,
the stop file) decide for every rank. Checkpoints hold the whole, unsharded state, and
only rank 0 writes them and the log. At tp=1 the data axis is JAX's ``data_mesh`` rule,
the most ranks that divide the batch: the ranks past it idle until the run ends and
return rank 0's result (:class:`blindno_torch.parallel.mesh.TrainingRanks`), as JAX leaves
those devices out of its mesh.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field as dc_field, replace
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from blindno_torch import default_device
from blindno_torch.convert import adam_from_optax, adam_to_optax
from blindno_torch.data.datasets import SetToFieldData, eval_batches, train_test_split
from blindno_torch.eval.metrics import relative_l2_per_field
from blindno_torch.parallel import distribute, undistribute
from blindno_torch.parallel.mesh import (TrainingRanks, data_parallel_size, init_distributed,
                                         is_distributed, world_size)
from blindno_torch.parallel.tp import gather_state
from blindno_torch.train import checkpoint
from blindno_torch.train.scan import EpochProgram, on_stream
from blindno_torch.train.step import (AMP_POLICIES, COMPUTE_DTYPES, check_compute_dtype,
                                      make_optimizer, train_step)
from blindno_torch.utils.logging import MetricsLogger, trace


@dataclass
class TrainConfig:
    """The JAX package's fields and defaults (``blindno/train/loop.py:38-139``, where
    each field's note is). ``compute_dtype`` None, ``"float32"``, ``"bfloat16"`` or
    ``"float16"`` trains every model under any of the three ``amp_policy`` values
    (:mod:`blindno_torch.train.step`); ``epoch_scan=True`` runs each epoch as one program
    (:mod:`blindno_torch.train.scan`). The port refuses what JAX refuses too (another
    ``compute_dtype`` or ``amp_policy``), the float16 step of a model whose set attention
    masks its keys, where JAX's step gives NaN
    (:func:`~blindno_torch.train.step.float16_refusal`), and ``epoch_scan`` in a process
    group whose collectives a CUDA graph cannot capture (gloo's, on a card); ``tp`` must
    divide the ranks, and with ``tp`` > 1 the rest of them (the ``data`` axis) the batch,
    as JAX's mesh rules ask (:func:`_check_world`)."""

    epochs: int = 400
    batch_size: int = 32
    lr: float = 1e-3
    lr_step_epochs: int = 100
    lr_gamma: float = 0.5
    save_interval: int = 10
    seed: int = 0
    split_seed: int = 0
    train_frac: float = 0.8
    reference_denominator: bool = True
    log_path: str | None = None
    ckpt_dir: str | None = None
    epoch_scan: bool = False
    # resume from {ckpt_dir}/resume.msgpack (or an earlier port version's resume.pt, the
    # newer) when present, else warm-restart from best_*
    resume: bool = True
    # graceful preemption: if this file appears, finish the epoch, save resume state
    # and return
    stop_file: str | None = None
    # store the device-resident input snapshots in bfloat16 (targets stay float32;
    # every batch is cast back to float32 right after the gather)
    compress_inputs: bool = False
    tp: int = 1
    # "d4_scalar", "c4_vector" or "flip1d": one random group element per step
    # (uniform, identity included); eval is never augmented
    augment: str | None = None
    compute_dtype: str | None = None
    amp_policy: str = "all"
    # end the run when the best test loss has not improved for this many epochs
    early_stop_patience: int | None = None
    # write one torch.profiler trace of epoch start_epoch+2 under this directory
    profile_dir: str | None = None


@dataclass
class TrainResult:
    """``params`` are the model's named parameters, ``batch_stats`` its named buffers
    (the BatchNorm running statistics), each a dict of detached tensors."""

    params: Any
    batch_stats: Any
    best_params: Any
    best_batch_stats: Any
    best_test_loss: float
    history: list = dc_field(default_factory=list)
    # True when the run ended on its own terms (all epochs, or early-stop patience
    # exhausted) rather than by preemption or divergence
    finished: bool = False


def _rotate_vec2(y, k: int):
    """Rotate the last-axis (vx, vy) components by k * 90 deg CCW: (vx,vy)->(-vy,vx)."""
    for _ in range(k % 4):
        y = torch.stack([-y[..., 1], y[..., 0]], dim=-1)
    return y


def make_augment(kind: str | None):
    """Batch-transform branches for TrainConfig.augment, one per group element, in the
    JAX package's order (``blindno/eval/field_eval.py:tta_indices`` depends on it).

    Returns a list of fns (x: (B,L,H,W), y: (B,H,W,F)) -> (x, y). Orientation
    convention: grid axis 0 is x, axis 1 is y; a +90 deg rotation is ``torch.rot90``
    with k=1 on the spatial axes and mixes vector components by (vx, vy) -> (-vy, vx).
    D4 element i is rot^(i % 4) after a reflection y -> -y when i >= 4.
    """
    if kind is None:
        return None

    def mk(k: int, flip: bool, vector: bool):
        def f(x, y):
            if flip:  # reflection y -> -y (axis 1 of the grid)
                x = torch.flip(x, (3,))
                y = torch.flip(y, (2,))
            x = torch.rot90(x, k, (2, 3))
            y = torch.rot90(y, k, (1, 2))
            if vector:
                y = _rotate_vec2(y, k)
            return x, y

        return f

    if kind == "d4_scalar":
        return [mk(k, fl, False) for fl in (False, True) for k in range(4)]
    if kind == "c4_vector":
        return [mk(k, False, True) for k in range(4)]
    if kind == "flip1d":
        return [
            lambda x, y: (x, y),
            lambda x, y: (torch.flip(x, (2,)), torch.flip(y, (1,))),
        ]
    raise ValueError(f"unknown augment kind: {kind!r}")


def step_lr(lr: float, gamma: float, step_epochs: int, steps_per_epoch: int):
    """torch StepLR(step_size, gamma) as a function of the global step."""

    def schedule(step):
        epoch = step // max(steps_per_epoch, 1)
        return lr * gamma ** (epoch // step_epochs)

    return schedule


def _check_config(cfg: TrainConfig):
    if cfg.compute_dtype is not None and (cfg.compute_dtype not in COMPUTE_DTYPES
                                          or cfg.amp_policy not in AMP_POLICIES):
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r} with amp_policy="
                         f"{cfg.amp_policy!r}: JAX refuses it too; the compute dtypes are "
                         f"{list(COMPUTE_DTYPES)} and the amp policies {AMP_POLICIES}")


def _split_to_device(arr, idx, dtype, device):
    """``arr[idx]`` as one tensor of ``dtype`` on ``device``, copied 64 samples at a time
    so that neither side holds a second float32 copy of the split."""
    out = torch.empty((len(idx), *arr.shape[1:]), dtype=dtype, device=device)
    for s in range(0, len(idx), 64):
        out[s:s + 64].copy_(torch.from_numpy(np.ascontiguousarray(arr[idx[s:s + 64]], np.float32)))
    return out


def _state(model, gathered=False):
    """(params, batch_stats) of ``model``: its named parameters and named buffers; with
    ``gathered``, as one process holds them (a collective over the ``model`` axis)."""
    if not gathered:
        return (dict(model.named_parameters()), dict(model.named_buffers()))
    return _split(model, gather_state(model))


def _split(model, state: dict):
    """A state dict of ``model`` as (params, batch_stats)."""
    names = dict(model.named_parameters())
    return ({k: state[k] for k in names}, {k: v for k, v in state.items() if k not in names})


def _check_world(cfg: TrainConfig) -> int:
    """The ``data`` axis' size, by JAX's rules (``blindno/train/loop.py:275-283``). At
    tp=1, ``data_mesh(batch_size=...)``'s: the most ranks that divide the batch, the
    others left idle. With tp > 1 every rank trains, and ``ValueError`` is raised unless
    ``tp`` divides the ranks and the data axis the batch, where JAX refuses too."""
    world = world_size()
    if cfg.tp < 1 or world % cfg.tp:
        raise ValueError(f"tp={cfg.tp}: {world} rank(s) not divisible by tp (the model axis)")
    if cfg.tp == 1:
        return data_parallel_size(world, cfg.batch_size)
    n_data = world // cfg.tp
    if cfg.batch_size % n_data:
        fit = data_parallel_size(n_data, cfg.batch_size)
        raise ValueError(f"batch_size={cfg.batch_size} not divisible by the data axis "
                         f"({n_data} = {world} ranks / tp={cfg.tp}), which JAX refuses too; "
                         f"run {fit * cfg.tp} ranks (data axis {fit})")
    return n_data


def _check_scan_backend(device):
    """Raise ``ValueError`` where ``epoch_scan`` cannot run in the process group: on a
    CUDA card the program captures the step in a CUDA graph, the step's collectives
    with it, and only NCCL's collectives can be captured."""
    backend = dist.get_backend()
    if device.type == "cuda" and "nccl" not in backend:
        raise ValueError(
            f"epoch_scan=True on a CUDA card captures the training step, its collectives "
            f"included, in a CUDA graph; the process group's {backend!r} collectives cannot "
            "be captured (gloo runs them on the host). Run the ranks over NCCL, one card "
            "a rank, or train with epoch_scan=False")


def _from_rank0(values, device, group) -> np.ndarray:
    """``values`` as rank 0 holds them, on every rank of ``group``: what rank 0 found
    decides for all (a rank that decided alone would leave the others waiting in a
    collective)."""
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.broadcast(t, 0, group=group)
    return t.cpu().numpy()


def _copy(tree: dict) -> dict:
    return {k: v.detach().clone() for k, v in tree.items()}


def _on(res: TrainResult, device) -> TrainResult:
    """``res`` with its tensors on ``device``."""
    move = lambda tree: {k: v.to(device) for k, v in tree.items()}
    return replace(res, params=move(res.params), batch_stats=move(res.batch_stats),
                   best_params=move(res.best_params),
                   best_batch_stats=move(res.best_batch_stats))


def _segment_seed(seed: int, start_epoch: int) -> int:
    """The run's seed, folded with ``start_epoch`` for a resumed segment, as JAX folds
    its key (``blindno/train/loop.py:334``)."""
    if start_epoch == 1:
        return seed
    return int(np.random.SeedSequence([seed, start_epoch]).generate_state(1)[0])


def _seeded_draws(host: torch.Generator, n_train: int, batch_size: int, n_elements: int):
    """The loop's default source of draws: per epoch, a permutation of the train split
    cut into full batches, and one group element per step, from the CPU generator
    ``host``. The set subsamples are left to the model (``None``): it draws them from
    the loop's device generator."""

    def draw(epoch: int, steps: int):
        perm = torch.randperm(n_train, generator=host)
        batch_idx = perm[: steps * batch_size].reshape(steps, batch_size)
        elements = (torch.randint(0, n_elements, (steps,), generator=host).tolist()
                    if n_elements else None)
        return batch_idx, elements, None

    return draw


def train_model(model, data: SetToFieldData, grid, cfg: TrainConfig, *,
                progress: Callable | None = None, device=None,
                draws: Callable | None = None) -> TrainResult:
    """Full training run of ``model`` (an ``nn.Module`` taking ``(x, grid, generator=...,
    subsample=...)`` in train mode, such as ``NIOFP2D`` or ``PermInvUNetAttn``), which moves to ``device``
    (CUDA unless the caller passes another) and is trained in place; it is left in eval
    mode.

    ``draws(epoch, steps)`` may replace the seeded draws (:func:`_seeded_draws`): it
    returns the epoch's batches as train-split positions (steps, batch_size), each
    step's group element (or ``None`` without augmentation) and each step's set
    subsample ``(indices, mask)`` (or ``None``, for the model to draw).

    In a process group, a rank past the ranks that train (:func:`_check_world`) is idle:
    it copies no data to its device and joins no collective of the training, and once the
    run ends it returns rank 0's result on its device, its ``model`` holding the final
    state. It raises ``RuntimeError`` where a training rank fails.
    """
    _check_config(cfg)
    check_compute_dtype(model, cfg.compute_dtype, cfg.amp_policy)
    distributed = is_distributed()
    n_data = _check_world(cfg)
    aug_fns = make_augment(cfg.augment)
    if cfg.augment == "flip1d":
        if data.inputs.ndim != 3:
            raise ValueError(
                f"augment='flip1d' needs (B, L, Nx) inputs, got {data.inputs.shape}")
    elif aug_fns is not None and (
        data.inputs.ndim != 4 or data.inputs.shape[2] != data.inputs.shape[3]
    ):
        raise ValueError(
            f"augment={cfg.augment!r} needs square (B, L, H, W) inputs, "
            f"got {data.inputs.shape}")
    dev = init_distributed(device=device) if distributed else default_device(device)
    if not distributed:
        return _train(model, data, grid, cfg, dev, None, n_data, aug_fns, progress, draws)
    if cfg.epoch_scan:
        _check_scan_backend(dev)
    ranks = TrainingRanks(n_data * cfg.tp, cfg.tp, dev.type)
    if ranks.idle:
        res = _on(ranks.result(), dev)
        model.to(dev).load_state_dict({**res.params, **res.batch_stats})
        model.eval()
        return res
    try:
        res = _train(model, data, grid, cfg, dev, ranks, n_data, aug_fns, progress, draws)
    except BaseException as exc:
        ranks.fail(exc)
        raise
    ranks.end(lambda: _on(res, "cpu"))
    return res


def _train(model, data, grid, cfg, dev, ranks, n_data, aug_fns, progress, draws):
    """:func:`train_model` on a training rank (``ranks``, its ``TrainingRanks``) or in one
    process (``ranks`` None), on ``dev`` with a data axis of ``n_data``."""
    distributed = ranks is not None
    model.to(dev)
    n = data.inputs.shape[0]
    train_idx, test_idx = train_test_split(n, cfg.train_frac, cfg.split_seed)
    in_dtype = torch.bfloat16 if cfg.compress_inputs else torch.float32
    x_train = _split_to_device(data.inputs, train_idx, in_dtype, dev)
    y_train = _split_to_device(data.targets, train_idx, torch.float32, dev)
    x_test = _split_to_device(data.inputs, test_idx, in_dtype, dev)
    y_test = _split_to_device(data.targets, test_idx, torch.float32, dev)
    grid = torch.as_tensor(np.asarray(grid, np.float32), device=dev)

    steps_per_epoch = train_idx.shape[0] // cfg.batch_size
    if steps_per_epoch == 0:
        raise ValueError(
            f"batch_size={cfg.batch_size} exceeds the train split "
            f"({train_idx.shape[0]} samples) — no steps would run; lower batch_size or add data"
        )
    schedule = step_lr(cfg.lr, cfg.lr_gamma, cfg.lr_step_epochs, steps_per_epoch)
    opt = make_optimizer(model, cfg.lr)
    trainable = [k for k, p in model.named_parameters() if p.requires_grad]  # opt's order

    start_epoch = 1
    best_loss = float("inf")
    if cfg.resume and cfg.ckpt_dir:
        # read to the host: ``load_state_dict`` copies the params and moves Adam's
        # moments to the parameters' device, and leaves each ``step`` where it is read,
        # on the host as Adam keeps it (on the card, Adam would read it back with a
        # synchronization per parameter and step); ``step`` carries the schedule on.
        # resume.msgpack comes with optax's Adam state, mapped onto this optimizer
        restored = checkpoint.load_resume(cfg.ckpt_dir)
        if restored is not None:
            model.load_state_dict({**restored["params"], **restored["batch_stats"]})
            opt_state = restored["opt_state"]
            if os.path.basename(restored["path"]) == checkpoint.RESUME:
                opt_state = adam_from_optax(opt_state, trainable, opt.state_dict()["param_groups"])
            opt.load_state_dict(opt_state)
            start_epoch = int(restored["epoch"]) + 1
            best_loss = float(restored["best_loss"])
            print(f"[train] resumed from {restored['path']} at epoch {start_epoch} "
                  f"(best {best_loss:.6f})")
        else:
            # no resume file (only best_* survives, the port's or JAX's): warm restart
            # from the best checkpoint with zero Adam moments and the step count
            # advanced, so the StepLR schedule and Adam's bias correction continue where
            # the run was
            best = checkpoint.load_best_as_warm_restart(cfg.ckpt_dir, *_state(model))
            if best is not None and best["epoch"] >= 1:
                model.load_state_dict({**best["params"], **best["batch_stats"]})
                start_epoch = best["epoch"] + 1
                best_loss = best["test_loss"]
                done_steps = (start_epoch - 1) * steps_per_epoch
                for group in opt.param_groups:
                    for p in group["params"]:
                        opt.state[p] = {"step": torch.tensor(float(done_steps)),
                                        "exp_avg": torch.zeros_like(p),
                                        "exp_avg_sq": torch.zeros_like(p)}
                print(f"[train] no {checkpoint.RESUME} or {checkpoint.OLD_RESUME}; warm "
                      f"restart from best_* at "
                      f"epoch {best['epoch']} (best {best_loss:.6f}; Adam moments "
                      f"reset, lr schedule advanced to step {done_steps})")

    # on the card the epoch program runs on a stream of its own, and DDP is built on it
    stream = torch.cuda.Stream(dev) if cfg.epoch_scan and dev.type == "cuda" else None
    net, rows, share, train_group = model, slice(None), cfg.batch_size, None
    if distributed:
        mesh, train_group = ranks.mesh, ranks.group
        with on_stream(stream):
            net = distribute(model, mesh, opt, train_group)
        data_group = mesh.get_group("data")
        share = cfg.batch_size // n_data
        rows = slice(mesh.get_local_rank("data") * share, (mesh.get_local_rank("data") + 1) * share)

    # every rank draws from the same seed: the same batches, elements and subsamples
    seed = _segment_seed(cfg.seed, start_epoch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if draws is None:
        draws = _seeded_draws(torch.Generator().manual_seed(seed), train_idx.shape[0],
                             cfg.batch_size, len(aug_fns) if aug_fns else 0)

    def evaluate():
        """Sum over the test split of the per-field rel-L2, padded batches masked."""
        model.eval()
        with torch.inference_mode():
            sums = 0.0
            for idx, mask in test_batches:
                out = model(x_test.index_select(0, idx).float(), grid)
                errs = relative_l2_per_field(out, y_test.index_select(0, idx),
                                             cfg.reference_denominator)
                sums = sums + (errs * mask[:, None]).sum(0)
            if distributed:
                dist.all_reduce(sums, group=data_group)
                # float32, the dtype one process divides and sums them in
                sums = _from_rank0(sums.tolist(), dev, train_group).astype(np.float32)
            else:
                sums = sums.cpu().numpy()
        model.train()
        return sums

    program = None
    if cfg.epoch_scan:
        program = EpochProgram(net, opt, x_train, y_train, grid, steps_per_epoch, share,
                               aug_fns, compute_dtype=cfg.compute_dtype,
                               amp_policy=cfg.amp_policy, generator=gen, stream=stream)

    def resume_state():
        """(params, batch_stats, optax's Adam state) as one process holds them; optax's
        state from either form of Adam, the program's capturable one too."""
        opt_state = opt.state_dict()
        if distributed:
            full, opt_state = gather_state(model, opt, opt_state)
            params, stats = _split(model, full)
        else:
            params, stats = _state(model)
        return params, stats, adam_to_optax(opt_state, params, trainable)

    def stop_requested():
        found = os.path.exists(cfg.stop_file)
        return bool(_from_rank0([float(found)], dev, train_group)[0]) if distributed else found

    logger = MetricsLogger(cfg.log_path)
    best_params, best_stats = map(_copy, _state(model, distributed))
    history = []
    n_test = test_idx.shape[0]
    test_batches = [(torch.as_tensor(i[rows], device=dev), torch.as_tensor(m[rows], device=dev))
                    for i, m in eval_batches(n_test, cfg.batch_size)]

    best_epoch = start_epoch - 1
    finished = True  # any break below (divergence/preemption) flips it
    global_step = (start_epoch - 1) * steps_per_epoch
    net.train()
    for epoch in range(start_epoch, cfg.epochs + 1):
        # one steady-state epoch (after the first two) traced, SURVEY 5.1 hook
        with trace(cfg.profile_dir if epoch == start_epoch + 2 else None):
            batch_idx, elements, subsamples = draws(epoch, steps_per_epoch)
            batch_idx = torch.as_tensor(batch_idx, dtype=torch.long)[:, rows]
            if program is not None:
                program.load(batch_idx, elements, subsamples, schedule(global_step))
                t0 = time.perf_counter()
                train_loss = program.run()
                global_step += steps_per_epoch
            else:
                batch_idx = batch_idx.to(dev)
                t0 = time.perf_counter()
                losses = []
                for i in range(steps_per_epoch):
                    xb = x_train.index_select(0, batch_idx[i]).float()
                    yb = y_train.index_select(0, batch_idx[i])
                    if aug_fns is not None:
                        xb, yb = aug_fns[elements[i]](xb, yb)
                    for group in opt.param_groups:
                        group["lr"] = schedule(global_step)
                    losses.append(train_step(
                        net, opt, xb, yb, grid, compute_dtype=cfg.compute_dtype,
                        amp_policy=cfg.amp_policy,
                        generator=None if subsamples else gen,
                        subsample=subsamples[i] if subsamples else None))
                    global_step += 1
                train_loss = torch.stack(losses).mean()
            if distributed:
                dist.all_reduce(train_loss, group=data_group)
                train_loss = _from_rank0([train_loss.item() / n_data], dev, train_group)[0]
            train_loss = float(train_loss)
            dt = time.perf_counter() - t0

            if not np.isfinite(train_loss):
                # divergence guard: stop immediately; the last finite resume state (if
                # any) is what a future invocation continues from
                logger.log({"event": "diverged", "epoch": epoch, "train_loss": train_loss})
                finished = False
                break

            if epoch % cfg.save_interval == 0 or epoch == cfg.epochs:
                field_means = evaluate() / n_test
                test_loss = float(field_means.sum())
                record = {
                    "epoch": epoch,
                    "train_loss": train_loss,
                    "test_loss": test_loss,
                    "field_rel_l2": field_means.tolist(),
                    "steps_per_sec": steps_per_epoch / dt,
                }
                history.append(record)
                logger.log(record)
                if progress:
                    progress(record)
                if not np.isfinite(test_loss):
                    # never checkpoint a poisoned state
                    logger.log({"event": "diverged", "epoch": epoch, "test_loss": test_loss})
                    finished = False
                    break
                if test_loss < best_loss:
                    best_loss = test_loss
                    best_epoch = epoch
                    best_params, best_stats = map(_copy, _state(model, distributed))
                    if cfg.ckpt_dir:
                        checkpoint.save_best(cfg.ckpt_dir, best_params, best_stats, epoch,
                                             best_loss, group=train_group)
                if cfg.ckpt_dir:
                    checkpoint.save_resume(cfg.ckpt_dir, *resume_state(), epoch, best_loss,
                                           group=train_group)
                if (cfg.early_stop_patience is not None
                        and epoch - best_epoch >= cfg.early_stop_patience):
                    logger.log({"event": "early_stop", "epoch": epoch,
                                "best_epoch": best_epoch, "best_loss": best_loss})
                    break

            if cfg.stop_file and stop_requested():
                if cfg.ckpt_dir:
                    checkpoint.save_resume(cfg.ckpt_dir, *resume_state(), epoch, best_loss,
                                           group=train_group)
                logger.log({"event": "preempted", "epoch": epoch})
                finished = False
                break

    logger.close()
    if distributed:
        undistribute(net)
    model.eval()
    params, stats = map(_copy, _state(model))
    return TrainResult(params, stats, best_params, best_stats, best_loss, history,
                       finished=finished)
