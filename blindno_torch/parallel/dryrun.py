"""A data- and tensor-parallel step against a single process's (counterpart of
``__graft_entry__.py:dryrun_multichip``), and the rank functions that run it.

:func:`dryrun_multigpu` spawns ``n`` ranks (:func:`~blindno_torch.parallel.mesh.run_ranks`)
and runs one full training step (loss, gradients, Adam update) of a small flagship
``PermInvUNetAttn`` on a ``(data, model)`` mesh, then checks that the sharded loss is
the single process's. The rank functions take their model as ``(class, kwargs)`` and
its state and inputs as numpy arrays, and return what they computed as one process
holds it (gradients and state gathered over ``model``): the CPU tests hold them against
JAX, and ``chip_smoke.py`` against the single-process step on the card.
:func:`train_model_ranks` runs the training loop on every rank, with its draws injected
where the caller gives them and, with ``record``, an account of each epoch program
(:func:`recorded_programs`). This module imports neither JAX nor anything of the JAX
package, so a spawned rank does not either.
"""
from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from blindno_torch.parallel import distribute, prepare
from blindno_torch.parallel.mesh import data_model_mesh, init_distributed, run_ranks, shard_batch
from blindno_torch.parallel.tp import gather_grads, gather_state

DRYRUN_MODEL = dict(input_size=(16, 16), depth=2, base_ch=1, width=4, fno_modes=4,
                    fno_layers=2, head_dims=(1, 1), subsample=True, l_min=2)
DRYRUN_TOL = 1e-5
KERNELS = ("fno1d_layer", "spectral_conv1d", "fno2d_layer", "spectral_conv2d")


def kernel_wrappers() -> dict:
    """Each kernel's wrapper by name; each counts its launches in ``launches``."""
    from blindno_torch.ops import spectral_cuda

    return {name: getattr(spectral_cuda, f"{name}_cuda") for name in KERNELS}


def full_precision():
    """A ``RankPool`` initializer for ranks on the card: TF32 off for matmuls and cuDNN,
    and cuDNN's deterministic algorithms, so that the ranks compute as a reference
    process held to them does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def built(factory, state, device):
    """``cls(**kwargs)`` of ``factory = (cls, kwargs)`` or ``(cls, kwargs, parts)``, each
    submodule that ``parts`` names (``{"deeponet.branch": (cls, kwargs)}``) replaced by a
    new one, with ``state`` (numpy arrays by name) loaded, on ``device``."""
    cls, kwargs, *parts = factory
    model = cls(**kwargs)
    for path, (part_cls, part_kwargs) in (parts[0] if parts else {}).items():
        parent, _, name = path.rpartition(".")
        setattr(model.get_submodule(parent), name, part_cls(**part_kwargs))
    model.to(device)
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    return model


def _mesh(n_model, device):
    dev = init_distributed(device=device)
    return dev, data_model_mesh(n_model, dev.type)


def _cpu(tree):
    """Copies on the CPU: later steps change the tensors in place."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def module_grads(factory, state, x, upstream, n_model, device="cpu"):
    """Rank function: the module in train mode on this rank's rows of ``x``, its
    BatchNorms synced over ``data`` and its FNO layers sharded over ``model``, and the
    backward of ``sum(out * upstream)`` (this rank's rows of it). Returns the rows' output
    and input gradient, each parameter's gradient (this rank's own sum, gathered over
    ``model``) and the buffers after the step."""
    dev, mesh = _mesh(n_model, device)
    model = prepare(built(factory, state, dev).train(), mesh)
    xs = shard_batch(torch.from_numpy(x), mesh).to(dev).requires_grad_()
    out = model(xs)
    (out * shard_batch(torch.from_numpy(upstream), mesh).to(dev)).sum().backward()
    return dict(out=out.detach().cpu(), dx=xs.grad.cpu(), grads=_cpu(gather_grads(model)),
                buffers=_cpu(dict(model.named_buffers())), place=mesh.get_coordinate())


def shard_roundtrip(factory, state, n_model, device="cpu"):
    """Rank function: the model's FNO layers sharded over ``model`` with Adam moments
    ``exp_avg = 2 * param``, then gathered. Returns the number of FNOs sharded, this
    rank's parameter shapes, and the gathered state and ``exp_avg`` by name."""
    from blindno_torch.parallel.tp import shard_fno_layers
    from blindno_torch.train.step import make_optimizer

    dev, mesh = _mesh(n_model, device)
    model = built(factory, state, dev)
    opt = make_optimizer(model)
    trained = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
    for _, p in trained:
        opt.state[p] = {"step": torch.tensor(1.0), "exp_avg": 2 * p.detach(),
                        "exp_avg_sq": p.detach() ** 2}
    sharded = shard_fno_layers(model, mesh.get_group("model"), opt)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    full, opt_state = gather_state(model, opt)
    return dict(sharded=sharded, shapes=shapes, state=_cpu(full), place=mesh.get_coordinate(),
                exp_avg={trained[i][0]: s["exp_avg"].cpu() for i, s in opt_state["state"].items()})


def train_step_ranks(factory, state, x, y, grid, draw, n_model, device="cpu", seed=2,
                     timed_steps=0, record_shapes=False):
    """Rank function: one ``train_step`` (fresh Adam) of the distributed model on this
    rank's rows of the batch, the set subsample ``draw = (indices, mask)`` injected or,
    with ``draw=None``, drawn from a generator seeded ``seed`` (the same on every rank).
    Returns the loss averaged over ``data``, the gradients and the state after the step
    gathered over ``model``, this rank's launches of each kernel in the step (and with
    ``record_shapes`` the (x shape, Cout) of each ``fno2d_layer`` launch), and, after
    ``timed_steps`` more steps on the same batch, their rate; with the seconds this rank
    took to set up (mesh, model, ``distribute``), for the checked step and to gather."""
    from blindno_torch.ops import spectral_cuda
    from blindno_torch.train.step import make_optimizer, train_step

    clock = [time.perf_counter()]
    lap = lambda: clock.append(time.perf_counter()) or clock[-1] - clock[-2]
    dev, mesh = _mesh(n_model, device)
    model = built(factory, state, dev)
    opt = make_optimizer(model)
    net = distribute(model, mesh, opt).train()
    xs, ys = (shard_batch(torch.from_numpy(a), mesh).to(dev) for a in (x, y))
    g = torch.from_numpy(grid).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    wrappers = kernel_wrappers()
    shapes, launch2d = [], spectral_cuda._launch2d
    if record_shapes:
        spectral_cuda._launch2d = lambda name, x, wr, *a: (
            shapes.append((tuple(x.shape), wr.shape[1])) or launch2d(name, x, wr, *a))
    for w in wrappers.values():
        w.launches = 0
    step = lambda: train_step(net, opt, xs, ys, g, generator=gen, subsample=draw)
    seconds = dict(setup=lap())
    loss = step()
    launches = {name: w.launches for name, w in wrappers.items()}
    spectral_cuda._launch2d = launch2d
    dist.all_reduce(loss, group=mesh.get_group("data"))
    loss = float(loss) / mesh.size(0)
    seconds["checked_step"] = lap()
    result = dict(loss=loss, grads=_cpu(gather_grads(model)), state=_cpu(gather_state(model)),
                  launches=launches, shapes=shapes, place=mesh.get_coordinate(),
                  seconds=seconds)
    seconds["gather"] = lap()
    if timed_steps:
        step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        result["steps_per_sec"] = timed_steps / (time.perf_counter() - t0)
    return result


def train_model_ranks(factory, state, data, grid, cfg, device="cpu", draws=None,
                      record=False):
    """Rank function: :func:`blindno_torch.train.loop.train_model` of the model on every
    rank (the loop finds the process group up and trains distributed). ``draws``, a table
    ``{epoch: (batch_idx, elements, subsamples)}`` as the loop's ``draws`` hook returns
    them, replaces the seeded draws. Returns the ``TrainResult``; with ``record``, a dict
    of it (``result``), each kernel's launches in the run (``launches``), the account
    of its epoch programs (``programs``, :func:`recorded_programs`) and the seconds
    ``train_model`` took (``train_s``)."""
    from blindno_torch.train.loop import train_model

    dev = init_distributed(device=device)
    hook = None if draws is None else lambda epoch, steps: draws[epoch]
    run = lambda: train_model(built(factory, state, "cpu"), data, grid, cfg, device=dev,
                              draws=hook)
    if not record:
        return run()
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with recorded_programs() as programs:
        result = run()
    return dict(result=result, launches={k: w.launches for k, w in wrappers.items()},
                programs=programs, train_s=time.perf_counter() - t0)


def raised(fn, *args):
    """Rank function: ``fn(*args)``, returning the exception it raised (None where it
    returned) in place of raising it, so that a caller reads what every rank raised where
    the pool would stop at the first."""
    try:
        fn(*args)
    except Exception as exc:
        return exc
    return None


COLLECTIVES = ("allreduce", "allgather", "all_reduce", "all_gather")


@contextlib.contextmanager
def recorded_programs():
    """Within the block, each epoch program that ``train_model`` builds keeps an account
    of its run, one dict a program in the list that the block gets:

    - ``eager_steps`` and ``replays``;
    - ``captured``: each kernel wrapper's calls while the step was captured (they execute
      nothing; each replay executes them);
    - ``collectives_captured``: the collective operations that ``torch.profiler`` saw
      issued while a distributed step was captured, by name, so run inside every replay
      (None for a step of one process, whose capture is not traced);
    - ``replayed``: for each wholly replayed epoch, run under
      ``torch.cuda.set_sync_debug_mode("error")`` (so with no host synchronization), its
      host ms a step (to enqueue the replays) and its steps/s (to the card's end of the
      epoch).
    """
    from torch.profiler import ProfilerActivity, profile

    from blindno_torch.train import loop, scan

    records = []

    class Recorded(scan.EpochProgram):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.record = dict(eager_steps=0, replays=0, captured=None,
                               collectives_captured=None, replayed=[])
            records.append(self.record)

        def _capture(self):
            before = {k: w.launches for k, w in kernel_wrappers().items()}
            if dist.is_initialized():
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    super()._capture()
                self.record["collectives_captured"] = dict(collections.Counter(
                    name for name in (e.name() for e in prof.profiler.kineto_results.events())
                    if name.startswith("c10d::") and any(c in name for c in COLLECTIVES)))
            else:
                super()._capture()
            self.record["captured"] = {k: w.launches - before[k]
                                       for k, w in kernel_wrappers().items()}

        def run(self):
            if self.graph is None:
                out = super().run()
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = super().run()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                host = time.perf_counter() - t0
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                self.record["replayed"].append(dict(host_ms_a_step=1e3 * host / self.steps,
                                                    steps_per_sec=self.steps / wall))
            self.record.update(eager_steps=self.eager_steps, replays=self.replays)
            return out

    saved = loop.EpochProgram
    loop.EpochProgram = Recorded
    try:
        yield records
    finally:
        loop.EpochProgram = saved


def dryrun_multigpu(n_ranks: int, device="cpu", timeout: float = 300.0) -> dict:
    """One full training step (loss, gradients, Adam update) of a small flagship
    ``PermInvUNetAttn`` (16x16, depth 2, width 4, 4 modes, ``l_min=2``) on a mesh of
    ``(n // 2, 2)`` ranks when n >= 4 is even, else ``(n, 1)``, over spawned ranks on
    ``device``; raises ``RuntimeError`` unless its loss is a single process's within
    1e-5. Returns both losses and the mesh's shape."""
    from blindno_torch.models.blindno_unet import PermInvUNetAttn
    from blindno_torch.train.step import make_optimizer, train_step

    n_model = 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1
    n_data = n_ranks // n_model
    factory = (PermInvUNetAttn, dict(DRYRUN_MODEL, device="cpu"))  # weights from seed 0
    rng = np.random.default_rng(0)
    batch = max(n_data, 2) * 2
    x = rng.standard_normal((batch, 8, 16, 16)).astype(np.float32)
    y = rng.standard_normal((batch, 16, 16, 2)).astype(np.float32)
    grid = np.zeros((16, 16, 2), np.float32)  # the UNet ignores its grid
    state = {k: v.numpy() for k, v in built(factory, None, "cpu").state_dict().items()}

    dev = torch.device(device)
    model = built(factory, state, dev).train()
    ref = float(train_step(model, make_optimizer(model), torch.from_numpy(x).to(dev),
                           torch.from_numpy(y).to(dev), torch.from_numpy(grid).to(dev),
                           generator=torch.Generator(device=dev).manual_seed(2)))
    ranks = run_ranks(train_step_ranks, n_ranks, factory, state, x, y, grid, None, n_model,
                      device, device=device, timeout=timeout)
    loss = ranks[0]["loss"]
    if not (np.isfinite(loss) and abs(loss - ref) <= DRYRUN_TOL * max(1.0, abs(ref))):
        raise RuntimeError(f"sharded loss {loss} != single-process loss {ref} "
                           f"(mesh {n_data}x{n_model}, tolerance {DRYRUN_TOL})")
    return dict(loss=loss, loss_single=ref, mesh=(n_data, n_model))
