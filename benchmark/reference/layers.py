"""Plain PyTorch layers of the reference models, float32, and the helpers that name a
model's leaves. Nothing here imports the program or the JAX package."""
from __future__ import annotations

import torch
import torch.nn.functional as F

# the kinds of leaf that train (the rest are statistics or frozen)
TRAINED = {"weight", "weight_transposed", "bias", "norm_weight", "spectral", "scalar"}


def conv_leaves(out, cin, kernel):
    return {"weight": ((out, cin, *kernel), "weight"), "bias": ((out,), "bias")}


def norm_leaves(dim, running=False):
    d = {"weight": ((dim,), "norm_weight"), "bias": ((dim,), "bias")}
    if running:
        d.update(running_mean=((dim,), "running_mean"), running_var=((dim,), "running_var"),
                 num_batches_tracked=((), "count"))
    return d


def prefixed(prefix, d):
    return {f"{prefix}.{k}": v for k, v in d.items()}


def fno_head_leaves(prefix, width, modes, layers, out_dim):
    out = {}
    out.update(prefixed(f"{prefix}.fc0", conv_leaves(width, width, ())))
    for j in range(layers):
        out[f"{prefix}.spectral.{j}.weights_re"] = ((width, width, 2 * modes, modes), "spectral")
        out[f"{prefix}.spectral.{j}.weights_im"] = ((width, width, 2 * modes, modes), "spectral")
    for j in range(layers):
        out.update(prefixed(f"{prefix}.pointwise.{j}", conv_leaves(width, width, ())))
    out.update(prefixed(f"{prefix}.fc1", conv_leaves(128, width, ())))
    out.update(prefixed(f"{prefix}.fc2", conv_leaves(out_dim, 128, ())))
    return out




def leaky_relu(x, slope):
    return torch.where(x >= 0, x, slope * x)


def layer_norm(x, w, b, eps):
    """Over the last axis, two-pass: ``(x - mean) / sqrt(mean((x - mean)^2) + eps)``."""
    xc = x - x.mean(-1, keepdim=True)
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * w + b


def batch_norm(x, p, prefix, train):
    """Over every axis but 1: batch statistics in train mode, running ones in eval."""
    if train:
        return F.batch_norm(x, None, None, p[f"{prefix}.weight"], p[f"{prefix}.bias"], True,
                            0.0, 1e-5)
    return F.batch_norm(x, p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"],
                        p[f"{prefix}.weight"], p[f"{prefix}.bias"], False, 0.0, 1e-5)


def linear(x, p, prefix):
    return F.linear(x, p[f"{prefix}.weight"], p[f"{prefix}.bias"])


def masked_mean(x, mask):
    """Mean over axis 1 of the entries whose mask is 1; a plain mean without a mask."""
    if mask is None:
        return x.mean(1)
    m = mask.reshape([1, -1] + [1] * (x.dim() - 2))
    return (x * m).sum(1) / m.sum(1).clamp_min(1.0)


def spectral_conv2d(x, wr, wi):
    """rfft2, the +/- row blocks of the first m1 rows times the first m2 columns mixed
    per mode over the channels, irfft2. x (B, C, H, W); wr, wi (C, O, 2*m1, m2)."""
    b, _, h, w = x.shape
    m1, m2 = wr.shape[2] // 2, wr.shape[3]
    wc = torch.complex(wr, wi)
    xf = torch.fft.rfft2(x)
    full = torch.zeros(b, wr.shape[1], h, w // 2 + 1, dtype=xf.dtype, device=x.device)
    full[:, :, :m1, :m2] = torch.einsum("bikm,iokm->bokm", xf[:, :, :m1, :m2], wc[:, :, :m1])
    full[:, :, h - m1:, :m2] = torch.einsum("bikm,iokm->bokm", xf[:, :, h - m1:, :m2],
                                            wc[:, :, m1:])
    return torch.fft.irfft2(full, s=(h, w))


def fno2d(x, p, prefix, layers, padding_frac):
    """(B, H, W, C) -> (B, H, W, out): lift, the layers on the grid padded at the far
    end of each axis, gelu between them, the crop and the 128-wide projection."""
    h, w = x.shape[1:3]
    x = linear(x, p, f"{prefix}.fc0").permute(0, 3, 1, 2)
    x = F.pad(x, (0, int(round(w * padding_frac)), 0, int(round(h * padding_frac))))
    for j in range(layers):
        y = spectral_conv2d(x, p[f"{prefix}.spectral.{j}.weights_re"],
                            p[f"{prefix}.spectral.{j}.weights_im"])
        y = (y + torch.einsum("bchw,oc->bohw", x, p[f"{prefix}.pointwise.{j}.weight"])
             + p[f"{prefix}.pointwise.{j}.bias"].reshape(1, -1, 1, 1))
        x = F.gelu(y) if j < layers - 1 else y
    x = x[..., :h, :w].permute(0, 2, 3, 1)
    return linear(F.gelu(linear(x, p, f"{prefix}.fc1")), p, f"{prefix}.fc2")


def heads(feats, p, kw):
    return torch.cat([fno2d(feats, p, f"heads.{k}", kw["fno_layers"], kw["padding_frac"])
                      for k in range(len(kw["head_dims"]))], dim=-1)

