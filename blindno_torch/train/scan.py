"""One training epoch as one program over static device buffers: the port of JAX's
``TrainConfig(epoch_scan=True)`` (``blindno/train/loop.py:396-415,464-468``), where the
epoch is one ``lax.scan`` over its steps and the host dispatches nothing per step.

At the epoch's start the host fills the program's buffers once: the batches as
train-split positions (steps, batch), each step's group element, the injected set
subsamples where a ``draws`` hook gives them, and Adam's learning rate. Each step then
reads its row of those at a step counter on the device: it gathers its batch with
``index_select``, applies its group element, takes the training step
(:func:`~blindno_torch.train.step.step_body`), writes its loss into a loss buffer and
advances the counter. Nothing in a step depends on the host.

On a CUDA card the step is captured once in a CUDA graph and each later step is one
``replay()``: the host does nothing else per step. The segment's first step runs
eagerly on the capture's stream first (:data:`WARMUP_STEPS`): it makes Adam's state,
the kernels' library and DFT matrices and cuBLAS's workspace, none of which may be made
inside a capture. That step is one of the run's own, so the run takes exactly the
updates of the per-step loop. The set subsamples are drawn on the device from the
loop's generator, which is registered with the graph: each replay advances it as an
eager step does, and draws what an eager step would draw. A capture or a replay that
fails raises; nothing falls back to the per-step loop. On the CPU every step runs the
same body eagerly, with no graph.

Across ranks the program runs each rank's rows of every batch, and its step is the
distributed one: DDP's gradient all-reduce over ``data``, the synced BatchNorm's
all-gather and all-reduce, and at ``tp > 1`` the column-parallel FNO layers'
collectives. On the card they are captured with the step, over NCCL (one card a rank),
and run inside each replay. A DDP step is captured after :data:`DDP_WARMUP_STEPS`
eager ones, on the stream that DDP was built on (:func:`on_stream`), as PyTorch's notes
on CUDA graphs ask of DDP; the capture then falls in a later epoch than the first, and
:meth:`EpochProgram.load` refills in place every buffer that the graph reads. (On the
H100 with torch 2.11, a one-rank DDP step captured after 10 eager steps, or with DDP
built on another stream than the capture's, invalidated the capture; after 11 it held.)

The group element is a device index into tables of the group's spatial permutations
and, for ``c4_vector``, of its component permutations and signs (:class:`GroupTables`),
as ``lax.switch`` picks JAX's branch on the device. A permutation moves values and
negates some, so a gathered batch equals the one ``make_augment``'s branch makes bit
for bit.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from blindno_torch.train.step import make_capturable, step_body

# eager steps that a run's program takes before it captures its step
WARMUP_STEPS = 1
# ... where the step is DDP's: its reducer rebuilds its buckets in its second iteration
# and times its first ten, which its next forward reads back; PyTorch's notes on CUDA
# graphs ask for 11 eager iterations before a DDP step is captured
DDP_WARMUP_STEPS = 11


@contextlib.contextmanager
def on_stream(stream):
    """The block on the CUDA ``stream``, ordered after the work already queued on the
    current stream and before the work queued on it after the block; a no-op where
    ``stream`` is None."""
    if stream is None:
        yield
        return
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        yield
    torch.cuda.current_stream(stream.device).wait_stream(stream)


class GroupTables:
    """The group elements of one ``make_augment`` kind as tables on the device: for each
    element, the permutation of the snapshots' flattened spatial points, that of the
    targets' points and, where an element mixes the target's components (``c4_vector``),
    each output component's source component and sign. Built by applying each branch to
    fields that hold their own indices, so the tables are the branches' own.

    ``x_spatial`` is the snapshots' spatial shape, ``fields`` the targets' last axis."""

    def __init__(self, fns, x_spatial, fields: int, device):
        s = math.prod(x_spatial)
        x = torch.arange(s, dtype=torch.float64).view(1, 1, *x_spatial)
        # each target entry codes its flat (point, component) index + 1; a sign survives
        y = (torch.arange(s * fields, dtype=torch.float64) + 1).view(1, *x_spatial, fields)
        xperm, yperm, comp, sign = [], [], [], []
        for fn in fns:
            xo, yo = fn(x, y)
            xperm.append(xo.reshape(s).long())
            v = yo.reshape(s, fields)
            src = v.abs().long() - 1
            point, channel, sg = src // fields, src % fields, torch.sign(v)
            if not ((point == point[:, :1]).all() and (channel == channel[:1]).all()
                    and (sg == sg[:1]).all()):
                raise ValueError("a group element mixes the targets' components by point")
            yperm.append(point[:, 0])
            comp.append(channel[0])
            sign.append(sg[0])
        to = lambda ts, dtype: torch.stack(ts).to(device=device, dtype=dtype)
        self.xperm, self.yperm = to(xperm, torch.long), to(yperm, torch.long)
        self.mixes = not all(torch.equal(c, torch.arange(fields)) and bool((g == 1).all())
                             for c, g in zip(comp, sign))
        self.comp, self.sign = to(comp, torch.long), to(sign, torch.float32)

    def apply(self, x, y, element):
        """x (B, L, *spatial) and y (B, *spatial, F) under the group element that the
        (1,) long tensor ``element`` on the device names."""
        x = x.flatten(2).index_select(2, self.xperm.index_select(0, element).view(-1))
        yf = y.flatten(1, -2).index_select(1, self.yperm.index_select(0, element).view(-1))
        if self.mixes:
            yf = (yf.index_select(2, self.comp.index_select(0, element).view(-1))
                  * self.sign.index_select(0, element).to(yf.dtype))
        return x.view(x.shape[:2] + y.shape[1:-1]), yf.view(y.shape)


class EpochProgram:
    """The epoch program of ``train_model(..., TrainConfig(epoch_scan=True))`` for one
    process or one rank: ``model`` (in train mode; across ranks the distributed model)
    and ``optimizer`` train on the device-resident split ``x_all`` (N, L, *spatial) and
    ``y_all`` (N, *spatial, F), ``steps`` steps of ``batch_size`` rows (this rank's) an
    epoch, under the ``make_augment`` branches ``augment_fns`` (or None), in
    ``compute_dtype`` under ``amp_policy``, the set subsamples drawn from ``generator``
    unless injected. On a CUDA card it turns ``optimizer`` into its capturable form
    (:func:`~blindno_torch.train.step.make_capturable`) and runs on ``stream`` (a new
    one if None).

    Per epoch: :meth:`load` its draws and learning rate, :meth:`run` it, read
    :attr:`losses`."""

    def __init__(self, model, optimizer, x_all, y_all, grid, steps: int, batch_size: int,
                 augment_fns=None, *, compute_dtype=None, amp_policy="all", generator=None,
                 stream=None):
        dev = x_all.device
        self.model, self.optimizer, self.x_all, self.y_all, self.grid = (
            model, optimizer, x_all, y_all, grid)
        self.steps, self.generator = steps, generator
        self.step_kwargs = dict(compute_dtype=compute_dtype, amp_policy=amp_policy)
        self.positions = torch.zeros((steps, batch_size), dtype=torch.long, device=dev)
        self.elements = torch.zeros((steps,), dtype=torch.long, device=dev)
        self.counter = torch.zeros((1,), dtype=torch.long, device=dev)
        self.losses = torch.zeros((steps,), dtype=torch.float32, device=dev)
        self.tables = (None if augment_fns is None else
                       GroupTables(augment_fns, x_all.shape[2:], y_all.shape[-1], dev))
        self.sub_indices = self.sub_masks = None
        self.captures = dev.type == "cuda"
        if self.captures:
            self.lr = make_capturable(optimizer)
            self.stream = stream or torch.cuda.Stream(dev)
        self.warmup = (DDP_WARMUP_STEPS if isinstance(model, DistributedDataParallel)
                       else WARMUP_STEPS)
        self.graph = None
        self.eager_steps = self.replays = 0

    def load(self, batch_idx, elements, subsamples, lr: float):
        """Fill the buffers with one epoch's draws (as ``train_model``'s ``draws`` gives
        them, the batches cut to this rank's rows) and set Adam's learning rate to
        ``lr``; the counter restarts at 0."""
        self.positions.copy_(torch.as_tensor(batch_idx, dtype=torch.long))
        if self.tables is not None:
            self.elements.copy_(torch.as_tensor(elements, dtype=torch.long))
        injected = bool(subsamples)
        if self.graph is not None and injected != (self.sub_indices is not None):
            raise ValueError("epoch_scan: the draws hook changed whether it injects the set "
                             "subsamples after the step was captured")
        if not injected:
            self.sub_indices = self.sub_masks = None
        else:
            idx = torch.as_tensor(np.stack([np.asarray(s[0]) for s in subsamples]), dtype=torch.long)
            mask = torch.as_tensor(np.stack([np.asarray(s[1], np.float32) for s in subsamples]))
            if self.graph is None:
                self.sub_indices, self.sub_masks = (t.to(self.x_all.device) for t in (idx, mask))
            else:  # the captured step reads these buffers: refill them in place
                self.sub_indices.copy_(idx)
                self.sub_masks.copy_(mask)
        if self.captures:
            self.lr.fill_(lr)
        else:
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.counter.zero_()

    def _step(self):
        """One step at the counter: what the graph captures."""
        at = self.counter
        rows = self.positions.index_select(0, at).view(-1)
        xb, yb = self.x_all.index_select(0, rows).float(), self.y_all.index_select(0, rows)
        if self.tables is not None:
            xb, yb = self.tables.apply(xb, yb, self.elements.index_select(0, at))
        subsample = None
        if self.sub_indices is not None:
            subsample = (self.sub_indices.index_select(0, at).view(-1),
                         self.sub_masks.index_select(0, at).view(-1))
        loss = step_body(self.model, self.optimizer, xb, yb, self.grid,
                         generator=None if subsample else self.generator,
                         subsample=subsample, **self.step_kwargs)
        self.losses.index_copy_(0, at, loss.view(1))
        self.counter.add_(1)

    def _eager(self):
        self.optimizer.zero_grad(set_to_none=True)
        self._step()
        self.eager_steps += 1

    def _capture(self):
        """Capture one step on the program's stream; it has not run yet."""
        self.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        if self.sub_indices is None and self.generator is not None:
            graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph, stream=self.stream):
            self._step()
        self.graph = graph

    def run(self):
        """The epoch's steps. Returns the mean of their losses, a 0-d tensor on the
        device, not synchronized."""
        if not self.captures:
            for _ in range(self.steps):
                self._eager()
            return self.losses.mean()
        for _ in range(self.steps):
            if self.graph is None and self.eager_steps < self.warmup:
                with on_stream(self.stream):
                    self._eager()
                continue
            if self.graph is None:
                self._capture()
            self.graph.replay()
            self.replays += 1
        return self.losses.mean()
