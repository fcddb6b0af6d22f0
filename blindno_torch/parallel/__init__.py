"""Data- and tensor-parallel training across ranks (counterpart of ``blindno/parallel``).

JAX runs the same jitted step on a mesh of 1 or N devices: batches shard over ``data``,
with ``tp > 1`` weights shard their out-channels over ``model``, and XLA adds the
collectives, so the layout changes and the maths does not. The port keeps that rule in
eager PyTorch with one process per rank (:mod:`~blindno_torch.parallel.mesh`):

- the model is wrapped in ``DistributedDataParallel`` over the ``data`` group, whose
  gradient average is the global batch's mean where every rank holds as many rows;
- BatchNorm takes its statistics over the whole ``data`` group
  (:class:`~blindno_torch.nn.torch_layers.BatchNorm2d`'s ``sync_group``), as the jitted
  step takes them over the global batch;
- the FNO layers run column-parallel over ``model`` (:mod:`~blindno_torch.parallel.tp`).
"""
from __future__ import annotations

import warnings

from torch.nn.parallel import DistributedDataParallel

from blindno_torch.nn.torch_layers import _FlaxRunningVar
from blindno_torch.parallel.mesh import replicate
from blindno_torch.parallel.tp import shard_fno_layers, unshard_fno_layers


def prepare(model, mesh, optimizer=None, group=None):
    """``model`` (on this rank's device) made one rank's part of the ``mesh``: its state
    broadcast from rank 0 over ``group``, the mesh's ranks (the world unless given), its
    BatchNorms synced over ``data`` when that axis has more than one rank, and its FNO
    layers sharded over ``model`` (with ``optimizer``'s Adam moments). Returns
    ``model``."""
    replicate(model, group)
    if mesh.size(0) > 1:
        for m in model.modules():
            if isinstance(m, _FlaxRunningVar):
                m.sync_group = mesh.get_group("data")
    shard_fno_layers(model, mesh.get_group("model"), optimizer)
    return model


def distribute(model, mesh, optimizer=None, group=None) -> DistributedDataParallel:
    """:func:`prepare`'s model wrapped in ``DistributedDataParallel`` over ``data``.
    Buffers are not broadcast in the forward: the synced BatchNorm keeps them equal."""
    model = prepare(model, mesh, optimizer, group)
    with warnings.catch_warnings():  # newer torch renames the option; the old name holds
        warnings.simplefilter("ignore", FutureWarning)
        return DistributedDataParallel(model, process_group=mesh.get_group("data"),
                                       broadcast_buffers=False)


def undistribute(model):
    """The model inside :func:`distribute`'s wrapper, whole again: its FNO layers
    gathered and its BatchNorms local. A collective over ``model``."""
    model = getattr(model, "module", model)
    unshard_fno_layers(model)
    for m in model.modules():
        if isinstance(m, _FlaxRunningVar):
            m.sync_group = None
    return model
