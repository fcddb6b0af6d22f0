"""Process groups, the ``(data, model)`` device mesh and the rank launcher (counterpart of
``blindno/parallel/mesh.py``).

JAX runs one jitted program on a mesh of 1 or N devices and XLA adds the collectives.
The port runs one process per rank instead: :func:`init_distributed` joins the process
group (torchrun's ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, or an explicit
``file://`` store), :func:`data_model_mesh` lays the ranks out as JAX's
``devices.reshape(n // n_model, n_model)`` does, and the training loop adds the
collectives itself (:mod:`blindno_torch.parallel.tp`,
:class:`blindno_torch.nn.torch_layers.BatchNorm2d`, ``DistributedDataParallel``).
Where JAX's ``data_mesh`` leaves devices out of its mesh, :class:`TrainingRanks` leaves
the ranks past the training ones idle until the run ends. :func:`run_ranks` spawns a
group of ranks on one host, for the CPU tests, the dry run and ``chip_smoke.py``.
"""
from __future__ import annotations

import datetime
import io
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from blindno_torch import default_device


def world_size() -> int:
    """The ranks of the process group that is up, else torchrun's ``WORLD_SIZE`` (1 when
    unset)."""
    return dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", 1))


def is_distributed() -> bool:
    """Whether this process is one rank of several, or runs in a process group already
    up (a group of one included)."""
    return dist.is_initialized() or world_size() > 1


def init_distributed(backend: str | None = None, init_method: str | None = None,
                     device=None, timeout: float | None = None) -> torch.device:
    """Join the process group (once) and return this rank's device.

    The rank and world size come from torchrun's ``RANK`` and ``WORLD_SIZE``; the store
    is ``init_method`` (e.g. ``file:///tmp/store``), else torchrun's ``env://``. The
    device is ``device`` (CUDA unless the caller asks otherwise), and on CUDA the card
    ``LOCAL_RANK % device_count``, made current. The backend is ``backend``, else
    ``nccl`` on CUDA and ``gloo`` on the CPU; ``timeout``, in seconds, bounds a
    collective and the store's waits (torch's default unless given)."""
    dev = default_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method=init_method or "env://",
                                rank=int(os.environ.get("RANK", 0)), world_size=world_size(),
                                **({} if timeout is None else
                                   {"timeout": datetime.timedelta(seconds=timeout)}))
    return dev


def data_parallel_size(world: int, batch_size: int) -> int:
    """JAX's ``data_mesh(batch_size=...)`` rule (``blindno/parallel/mesh.py:19-28``): the
    largest rank count <= ``world`` that divides ``batch_size``."""
    n = world
    while n > 1 and batch_size % n:
        n -= 1
    return n


def mesh_layout(world: int, n_model: int = 1) -> np.ndarray:
    """The ranks laid out as JAX's ``data_model_mesh`` lays out its devices
    (``blindno/parallel/mesh.py:31-35``): ``arange(world).reshape(world // n_model,
    n_model)``, so rank r sits at ``(r // n_model, r % n_model)``. Raises ``ValueError``
    when ``n_model`` does not divide ``world``, where JAX's assert fails."""
    if n_model < 1 or world % n_model:
        raise ValueError(f"{world} rank(s) not divisible by tp={n_model} (the model axis)")
    return np.arange(world).reshape(world // n_model, n_model)


def data_model_mesh(n_model: int = 1, device_type: str = "cuda", n_ranks: int | None = None):
    """The process group's first ``n_ranks`` ranks (all of them unless given) as a
    ``DeviceMesh`` with axes ``("data", "model")``, laid out by :func:`mesh_layout`. Every
    rank of the group makes it, in the same order of meshes: a rank past ``n_ranks``
    joins the creation of its groups and gets none, and no coordinate
    (``get_coordinate()`` is None)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, mesh_layout(n_ranks or world_size(), n_model),
                      mesh_dim_names=("data", "model"))


def shard_batch(x, mesh):
    """This rank's rows of the global batch ``x``: the ``data`` axis' contiguous block, as
    JAX's ``P("data")`` sharding places them. Raises ``ValueError`` unless the axis
    divides the batch."""
    n, i = mesh.size(0), mesh.get_local_rank("data")
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} not divisible by the data axis ({n})")
    rows = x.shape[0] // n
    return x[i * rows:(i + 1) * rows]


def replicate(module, group=None):
    """Broadcast every parameter and buffer of ``module`` from rank 0 over ``group`` (the
    world unless given), in place, one flat broadcast per dtype; returns ``module``."""
    items = list(module.parameters()) + list(module.buffers())
    with torch.no_grad():
        for dtype in sorted({t.dtype for t in items}, key=str):  # one order on every rank
            same = [t for t in items if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in same])
            dist.broadcast(flat, 0, group=group)
            for t, part in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(part.view_as(t))
    return module


def is_main_process() -> bool:
    """Rank 0, or the only process (reference: ``accelerator.is_local_main_process``)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(group=None):
    """Wait for every rank of ``group`` (the world unless given); nothing to wait for in a
    single process."""
    if dist.is_initialized():
        dist.barrier(group)


class TrainingRanks:
    """One run's split of the process group, as JAX's ``data_mesh`` splits its devices
    (``blindno/parallel/mesh.py:19-28``): the first ``n_train`` ranks train on a
    ``(data, model)`` mesh of their own (:func:`data_model_mesh`), and the ranks past them
    are idle until the run ends, when rank 0 hands them its result. Every rank of the
    group makes one for each run, in the same order.

    An idle rank copies nothing to its device, joins no collective of the training and
    polls the group's store until rank 0 says the run ended (:meth:`end`) or a training
    rank says it failed (:meth:`fail`): no process-group timeout ends the wait, however
    long the run. It then takes rank 0's result through a gloo group of rank 0 and the
    idle ranks (:meth:`result`), so no NCCL communicator joins them.

    ``group`` is the group of every training rank on a training rank: the world where
    none idles, else the ``data`` axis (ranks idle only where tp is 1)."""

    POLL_S = 0.05
    # the store's key of the ranks that joined the group's runs, and the prefix of each
    # run's keys
    KEY = "blindno_torch/train_model/joined"

    def __init__(self, n_train: int, n_model: int, device_type: str):
        world, self.rank = world_size(), dist.get_rank()
        self.store = dist.distributed_c10d._get_default_store()
        # this run's keys, the same on every rank: a count of the ranks that joined the
        # group's runs, and a barrier, so that no rank joins the next run before every
        # rank joined this one
        joined = self.store.add(self.KEY, 1)
        self.key = f"{self.KEY}/{(joined - 1) // world}"
        self.store.add(self.key, 1)
        self._poll(lambda: int(self.store.add(self.key, 0)) == world)
        self.idle = self.rank >= n_train
        self.mesh = data_model_mesh(n_model, device_type, n_train)
        self.group = None if n_train == world or self.idle else self.mesh.get_group("data")
        self.results = (dist.new_group([0, *range(n_train, world)], backend="gloo")
                        if n_train < world else None)

    def _poll(self, done):
        while not done():
            time.sleep(self.POLL_S)

    def fail(self, exc: BaseException):
        """On a training rank that raised ``exc``: tell the idle ranks."""
        self.store.set(f"{self.key}/failed", f"rank {self.rank}: {type(exc).__name__}: {exc}")

    def end(self, result):
        """On a training rank whose run ended. Rank 0 tells the idle ranks, hands them
        ``result()`` (picklable, its tensors on the CPU; called only where ranks idle) and
        waits until every one has it."""
        if self.rank != 0:
            return
        self.store.set(f"{self.key}/ended", "1")
        if self.results is not None:
            dist.broadcast_object_list([result()], 0, group=self.results)
            dist.barrier(self.results)

    def result(self):
        """On an idle rank: wait for the run's end, and return rank 0's result. Raises
        ``RuntimeError`` naming the failure where a training rank failed."""
        ended, failed = f"{self.key}/ended", f"{self.key}/failed"
        self._poll(lambda: self.store.check([ended]) or self.store.check([failed]))
        if not self.store.check([ended]):
            raise RuntimeError(f"the training ranks failed: {self.store.get(failed).decode()}")
        box = [None]
        dist.broadcast_object_list(box, 0, group=self.results)
        dist.barrier(self.results)
        return box[0]


# ------------------------------------------------------------------ the rank launcher

# a numpy array at least this large travels to the ranks through a file, not the pipe:
# on an 8-core host, 120 MB took 0.59 s through the pipe and 0.10 s as a file
FILE_ARRAY_BYTES = 1 << 20


def _mapped(path):
    """The array that :class:`_JobPickler` saved at ``path``, memory-mapped copy on write."""
    return np.load(path, mmap_mode="c")


class _JobPickler(pickle.Pickler):
    """Pickles a job, saving each numpy array of FILE_ARRAY_BYTES or more to a ``.npy`` file
    named ``prefix`` + a number, which every rank maps."""

    def __init__(self, file, prefix):
        super().__init__(file, pickle.HIGHEST_PROTOCOL)
        self.prefix, self.saved = prefix, []

    def reducer_override(self, obj):
        if not (isinstance(obj, np.ndarray) and obj.nbytes >= FILE_ARRAY_BYTES):
            return NotImplemented
        path = f"{self.prefix}{len(self.saved)}.npy"
        np.save(path, obj)
        self.saved.append(path)
        return _mapped, (path,)


def _worker(jobs, workdir, initializer):
    """A spawned worker: on one torch thread and after ``initializer()``, run each job
    that arrives as one rank of a new process group (a ``file://`` store in
    ``workdir``), leave its result or its traceback in ``workdir``, and leave the group.
    A job that fails ends the worker: the other ranks of its group may be waiting for
    it."""
    torch.set_num_threads(1)
    if initializer is not None:
        initializer()
    while (job := jobs.get()) is not None:
        tag, payload, rank, world, device, backend, group_timeout = job
        fn, args = pickle.loads(payload)
        out = os.path.join(workdir, f"{tag}.{rank}")
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
        try:
            init_distributed(backend, f"file://{os.path.join(workdir, f'{tag}.store')}", device,
                             group_timeout)
            torch.save(fn(*args), out + ".tmp")
            os.replace(out + ".tmp", out + ".pt")
        except BaseException:
            with open(out + ".err", "w") as f:
                f.write(traceback.format_exc())
            raise
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


class RankPool:
    """``size`` spawned worker processes that run groups of ranks on this host, one group
    at a time: :meth:`run` makes workers 0 to ``world - 1`` the ranks of a new process
    group. The workers import torch once, so a run after the first starts in well under
    a second. ``initializer``, a picklable function, runs first in each worker (to set
    the backends' flags, say). Use it as a context manager; a run that fails or times
    out closes the pool."""

    def __init__(self, size: int, initializer=None):
        self.workdir = tempfile.mkdtemp(prefix="ranks_")
        ctx = multiprocessing.get_context("spawn")
        self.queues = [ctx.SimpleQueue() for _ in range(size)]
        self.procs = [ctx.Process(target=_worker, args=(q, self.workdir, initializer),
                                  daemon=True) for q in self.queues]
        self.runs = 0
        for p in self.procs:
            p.start()

    def run(self, fn, world: int, *args, device="cpu", backend: str | None = None,
            timeout: float = 300.0, group_timeout: float | None = None):
        """``fn(*args)`` in ``world`` ranks and their results, rank by rank.

        ``fn`` must be importable without JAX (a spawned worker imports its module) and
        its arguments and result picklable; pass arrays as numpy. Each rank runs on
        ``device`` (on CUDA the card ``rank % device_count``) over ``backend``
        (:func:`init_distributed`'s default unless given), in a process group whose
        ``timeout`` is ``group_timeout`` seconds (torch's default unless given). Raises
        ``RuntimeError`` with the traceback of the first rank that fails and
        ``TimeoutError`` after ``timeout`` seconds; either way every worker is stopped
        first."""
        if world > len(self.procs):
            raise ValueError(f"{world} ranks asked of a pool of {len(self.procs)}")
        tag, self.runs = f"run{self.runs}", self.runs + 1
        buffer = io.BytesIO()
        pickler = _JobPickler(buffer, os.path.join(self.workdir, f"{tag}.arg"))
        pickler.dump((fn, args))
        for rank in range(world):
            self.queues[rank].put((tag, buffer.getvalue(), rank, world, device, backend,
                                   group_timeout))
        files = [os.path.join(self.workdir, f"{tag}.{r}") for r in range(world)]
        deadline = time.monotonic() + timeout
        try:
            while not all(os.path.exists(f + ".pt") for f in files):
                for r, f in enumerate(files):  # the others may wait for it: stop them
                    if os.path.exists(f + ".err") or self.procs[r].exitcode is not None:
                        time.sleep(0.2)  # its traceback is written before it exits
                        text = open(f + ".err").read() if os.path.exists(f + ".err") else ""
                        raise RuntimeError(f"rank {r} of {world} ({fn.__name__}) failed "
                                           f"(exit {self.procs[r].exitcode}):\n{text}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} still running after "
                                       f"{timeout} s")
                time.sleep(0.01)
        except BaseException:
            self.close()
            raise
        results = [torch.load(f + ".pt", weights_only=False) for f in files]
        for path in pickler.saved:
            os.remove(path)
        return results

    def close(self):
        """Stop every worker (those that do not finish at once are killed) and remove the
        pool's files."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        shutil.rmtree(self.workdir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_ranks(fn, world: int, *args, device="cpu", backend: str | None = None,
              timeout: float = 300.0):
    """:meth:`RankPool.run` in a pool of ``world`` workers of its own."""
    with RankPool(world) as pool:
        return pool.run(fn, world, *args, device=device, backend=backend, timeout=timeout)
