"""Set operations of the NIO family (counterpart of ``blindno/nn/setops.py``): train-time
set subsampling, masked means, set self-attention and the two fusions, over the mean
field and over all tokens (frozen unless ``trainable``, as in JAX)."""
from __future__ import annotations

import math

import torch
from torch import nn

from blindno_torch.nn.torch_layers import LayerNorm, promoted
from blindno_torch.utils import torch_init as tinit

NEG_INF = -1e9  # the key mask's additive term, JAX's (not -inf)


def subsample_set(x, l_min: int = 50, generator: torch.Generator | None = None,
                  indices=None, mask=None):
    """Train-time random set subsample with the JAX package's semantics
    (``blindno/nn/setops.py:33-54``): L_max indices drawn with replacement, an effective
    length L ~ U{l_min, ..., L_max-1} (L = l_min where l_min >= L_max, as JAX clamps), and
    the mask ``arange(L_max) < L``. All L_max gathered snapshots go on to the encoder, so
    BatchNorm's batch statistics cover all of them; only the means are masked.

    x: (B, L_max, ...). Returns the gathered x and the (L_max,) mask in x's dtype (as
    JAX casts it), both on x's device. The draw is taken from ``generator`` on its own device. A caller that must
    reproduce another framework's draw passes ``indices`` (L_max,) and ``mask`` (L_max,)
    instead.
    """
    l_max = x.shape[1]
    if indices is None:
        if generator is None or mask is not None:
            raise ValueError("subsample_set: pass a torch.Generator, or both indices and mask")
        dev = generator.device
        l_eff = torch.randint(l_min, max(l_max, l_min + 1), (), generator=generator, device=dev)
        indices = torch.randint(0, l_max, (l_max,), generator=generator, device=dev)
        mask = torch.arange(l_max, device=dev) < l_eff
    elif mask is None:
        raise ValueError("subsample_set: injected indices need their mask")
    indices = torch.as_tensor(indices, device=x.device)
    mask = torch.as_tensor(mask, device=x.device).to(x.dtype)
    if indices.shape != (l_max,) or mask.shape != (l_max,):
        raise ValueError(f"subsample_set: want indices and mask of shape ({l_max},), got "
                         f"{tuple(indices.shape)} and {tuple(mask.shape)}")
    return x.index_select(1, indices), mask


def train_subsample(model, x, generator=None, subsample=None):
    """A model's set subsample in train mode (:func:`subsample_set` with the model's
    ``l_min``, drawn from ``generator`` or the injected ``subsample=(indices, mask)``),
    and the set as it is with no mask in eval mode. Returns (x, mask or None)."""
    if model.training:
        return subsample_set(x, model.l_min, generator, *(subsample or ()))
    return x, None


def masked_mean(x, mask, axis: int = 1):
    """Mean over the set axis counting only mask==1 entries. mask: (L,) or (B, L)."""
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    if mask.dim() == 2:
        shape[0] = x.shape[0]
    m = mask.reshape(shape)
    return (x * m).sum(axis) / m.sum(axis).clamp_min(1.0)


def set_self_attention(x_flat, mask=None):
    """Unparameterized Q=K=V self-attention over a token set, as JAX computes it: scores
    ``x xᵀ / sqrt(D)``, ``NEG_INF`` added to the scores of masked-out keys, a softmax
    over the keys, and the weights times x. x_flat: (B, T, D); mask: (T,) or (B, T). The
    products are full float32 where TF32 is off for matmul, torch's default (JAX computes
    them at ``Precision.HIGHEST``)."""
    scores = x_flat @ x_flat.transpose(1, 2) / math.sqrt(x_flat.shape[-1])
    if mask is not None:
        key_mask = mask.reshape(1, 1, -1) if mask.dim() == 1 else mask[:, None, :]
        scores = scores + (1.0 - key_mask) * NEG_INF
    return torch.matmul(*promoted(torch.softmax(scores, dim=-1), x_flat))


class TemporalSelfAttention(nn.Module):
    """Set self-attention over flattened (C x spatial) tokens, plus the residual, then a
    LayerNorm over D = C·prod(spatial) (eps 1e-5). Input and output (B, T, C, *spatial).

    The tokens are flattened in the JAX package's channel-last order (spatial, then
    channel), so the LayerNorm's (D,) weight and bias are the flax checkpoint's as they
    stand; a channel-first flatten would need them permuted, which flax's init (ones and
    zeros) would not show.
    """

    def __init__(self, channels: int, spatial):
        super().__init__()
        self.norm = LayerNorm(channels * math.prod(spatial), eps=1e-5)

    def forward(self, x, mask=None):
        b, t, c = x.shape[:3]
        flat = x.movedim(2, -1).reshape(b, t, -1)
        out = self.norm(set_self_attention(flat, mask) + flat)
        return out.reshape(b, t, *x.shape[3:], c).movedim(-1, 2)


class MeanFieldFusion(nn.Module):
    """The reference's "fc0 weight surgery" as the affine map it computes:
    ``grid_feats @ W[:, :gc]^T + mean_L(snap_feats)[..., None] * W[:, gc] + b``.

    The reference only ever touches these weights through ``.data``, so they stay at
    their random init: by default (``trainable=False``, JAX's ``stop_gradient``) they are
    parameters with ``requires_grad=False``; ``trainable=True``, JAX's improvement flag,
    lets them train.
    grid_feats: (B, *spatial, gc); snap_feats: (B, L, *spatial) -> (B, *spatial, width).
    """

    def __init__(self, width: int, grid_channels: int, generator: torch.Generator,
                 trainable: bool = False):
        super().__init__()
        cin = grid_channels + 1
        self.grid_channels = grid_channels
        self.weight = nn.Parameter(torch.empty(width, cin), requires_grad=trainable)
        self.bias = nn.Parameter(torch.empty(width), requires_grad=trainable)
        tinit.torch_default_(self, cin, generator)

    def forward(self, grid_feats, snap_feats, mask=None):
        mean = snap_feats.mean(1) if mask is None else masked_mean(snap_feats, mask, 1)
        gc = self.grid_channels
        grid_feats, weight = promoted(grid_feats, self.weight)
        out = grid_feats @ weight[:, :gc].T + mean[..., None] * weight[:, gc]
        return out + self.bias


class TokenMeanFusion(nn.Module):
    """The fusion of the FNO-branch attention NIO (``blindno/nn/setops.py:142-167``): a
    Linear(1 -> width), frozen unless ``trainable``, applied to the mean over ALL T
    tokens, ``mean_T(tokens)[..., None] * W[:, 0] + b``. The first ``n_always`` tokens
    (the grid tokens) always count; ``mask`` (L,) covers the T - n_always tokens after
    them. tokens: (B, T, *spatial) -> (B, *spatial, width)."""

    def __init__(self, width: int, n_always: int, generator: torch.Generator,
                 trainable: bool = False):
        super().__init__()
        self.n_always = n_always
        self.weight = nn.Parameter(torch.empty(width, 1), requires_grad=trainable)
        self.bias = nn.Parameter(torch.empty(width), requires_grad=trainable)
        tinit.torch_default_(self, 1, generator)

    def forward(self, tokens, mask=None):
        if mask is None:
            mean = tokens.mean(1)
        else:
            mean = masked_mean(tokens, torch.cat([mask.new_ones(self.n_always), mask]), 1)
        return mean[..., None] * self.weight[:, 0] + self.bias
