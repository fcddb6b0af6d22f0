"""Tensor parallelism over the ``model`` mesh axis: column-parallel FNO layers
(counterpart of ``blindno/parallel/tp.py``).

JAX places every weight's out-channel axis over ``model`` and lets XLA add the
collectives. The port shards what the CLI promises to shard, the FNO layers' channels
(``blindno/suites/run.py:111-114``): in each ``FNO1d`` and ``FNO2d`` (the NIO heads, the
UNet's heads, the FNO-branch's inner FNO) every layer's spectral weights are cut on
axis 1 (out) and its pointwise ``weight`` and ``bias`` on axis 0 (out); each rank keeps
its slice as the parameter. An FNO whose width the axis does not divide stays
replicated, as JAX leaves such an array (``blindno/parallel/tp.py:24-30``); so does
every other parameter.

A sharded layer runs as Megatron's column-parallel layer: :class:`CopyToModel` (the
identity forward, the sum of the ranks' ``dx`` over ``model`` backward), the layer's
kernel on the rank's ``(Cin, Cout/tp)`` slice, and :class:`GatherFromModel` (the slices
gathered along the channels forward, the rank's slice of the gradient backward). Every
rank of a ``model`` group so holds the same activations and, for a replicated
parameter, the same gradient.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class CopyToModel(torch.autograd.Function):
    """The identity forward; the sum of ``dx`` over the ``model`` group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, dx):
        dx = dx.contiguous()
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


class GatherFromModel(torch.autograd.Function):
    """The ranks' channel slices (axis 1) gathered in rank order forward; this rank's
    slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[1]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, dy):
        lo = dist.get_rank(ctx.group) * ctx.width
        return dy[:, lo:lo + ctx.width].contiguous(), None


def column_parallel(layer, x, group, wr, wi, pk, pb, **kwargs):
    """``layer(x, wr, wi, pk, pb, **kwargs)`` on this rank's output slice, gathered."""
    return GatherFromModel.apply(layer(CopyToModel.apply(x, group), wr, wi, pk, pb, **kwargs),
                                 group)


def _fnos(model):
    """The FNO1d and FNO2d modules of ``model``: those with a ``tp_group`` slot."""
    return [m for m in model.modules() if hasattr(m, "tp_group")]


def _layer_params(fno):
    """(parameter, out axis) of every layer of ``fno``."""
    out = []
    for sc, pc in zip(fno.spectral, fno.pointwise):
        out += [(sc.weights_re, 1), (sc.weights_im, 1), (pc.weight, 0), (pc.bias, 0)]
    return out


def shard_fno_layers(model, group, optimizer=None) -> int:
    """Cut the layers of every FNO of ``model`` whose width the ``model`` group's size
    divides to this rank's out-channel slice, in place (the parameters stay the same
    objects), with their Adam moments in ``optimizer`` where it has any. Returns the
    number of FNOs sharded."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if size == 1:
        return 0
    sharded = 0
    for fno in _fnos(model):
        if fno.spectral[0].weights_re.shape[1] % size:
            continue  # stays replicated
        for p, axis in _layer_params(fno):
            width = p.shape[axis] // size
            cut = lambda t: t.narrow(axis, rank * width, width).clone()
            p.data = cut(p.data)
            p.tp = (group, axis)
            state = optimizer.state.get(p, {}) if optimizer is not None else {}
            for key in ("exp_avg", "exp_avg_sq"):
                if key in state:
                    state[key] = cut(state[key])
        fno.tp_group = group
        sharded += 1
    return sharded


def _gathered(t, p):
    """``t`` (a slice laid out as parameter ``p``) gathered over ``p``'s group, or ``t``
    where ``p`` is not sharded."""
    if getattr(p, "tp", None) is None:
        return t
    group, axis = p.tp
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.detach().contiguous(), group=group)
    return torch.cat(parts, dim=axis)


def _unwrapped(model):
    return getattr(model, "module", model)  # DistributedDataParallel holds the model


def gather_state(model, optimizer=None, opt_state=None):
    """The full ``state_dict`` of a model whose FNO layers may be sharded, and with
    ``optimizer``, also its full ``state_dict`` (Adam's moments gathered), or that of
    ``opt_state``, the state dict the caller saves for it; both as a single process would
    have them. A collective: every rank of the group calls it."""
    model = _unwrapped(model)
    params = dict(model.named_parameters())
    state = {k: _gathered(v, params[k]) if k in params else v
             for k, v in model.state_dict().items()}
    if optimizer is None:
        return state
    opt = optimizer.state_dict() if opt_state is None else opt_state
    ordered = [p for g in optimizer.param_groups for p in g["params"]]
    opt["state"] = {i: {k: _gathered(v, ordered[i]) if k in ("exp_avg", "exp_avg_sq") else v
                        for k, v in s.items()} for i, s in opt["state"].items()}
    return state, opt


def gather_grads(model) -> dict:
    """Every parameter's gradient, gathered where the parameter is sharded."""
    return {k: _gathered(p.grad, p) for k, p in _unwrapped(model).named_parameters()
            if p.grad is not None}


def unshard_fno_layers(model):
    """Undo :func:`shard_fno_layers`: every sharded parameter gathered back in place."""
    model = _unwrapped(model)
    for p in model.parameters():
        if getattr(p, "tp", None) is not None:
            p.data = _gathered(p.data, p)
            p.tp = None
    for fno in _fnos(model):
        fno.tp_group = None
