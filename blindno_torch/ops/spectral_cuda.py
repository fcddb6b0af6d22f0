"""The FNO layers' CUDA kernels and their wrappers (counterpart of
``blindno/ops/spectral_pallas.py``).

- :func:`fno1d_layer_cuda` replaces ``fno1d_layer_pallas`` and :func:`fno2d_layer_cuda`
  replaces ``fno2d_layer_pallas``: spectral conv, pointwise term, bias and optional
  exact gelu in one kernel (``csrc/fno1d_layer.cu``, ``csrc/fno2d_layer.cu``).
- :func:`spectral_conv1d_cuda` and :func:`spectral_conv2d_cuda` replace
  ``spectral_conv1d_pallas`` and ``spectral_conv2d_pallas``: the same kernels with the
  epilogue switched off.

A wrapper given a CPU tensor runs the kernel's plain PyTorch version; given a CUDA
tensor it launches the kernel or raises. Each wrapper counts its kernel launches in
its ``launches`` attribute. :func:`fno1d_layer_cuda` and :func:`fno2d_layer_cuda` are
differentiable: where autograd needs a gradient through one, its linear part runs as
:class:`FNO1dLinear` or :class:`FNO2dLinear` (the kernel with no activation forward,
``fno1d_layer_backward_plain`` or ``fno2d_layer_backward_plain`` backward) and gelu
follows outside, as ``blindno/ops/fno_layer.py:78-83,137-142`` has it. The two spectral
convolutions are forward only, as in JAX (``blindno/ops/config.py:5``): they raise when
autograd would need a gradient through them.

The kernels take float32 only, as the TPU kernels do. A wrapper given bfloat16 or
float16 operands (the training step's low-precision modes) raises them to float32, runs
the same float32 kernel (or plain version), and returns the output in the dtype that
jnp's promotion gives the operands, as the JAX package's einsum chain returns it
(``blindno/ops/spectral.py``); :class:`FNO1dLinear` and :class:`FNO2dLinear` return each
gradient in its input's dtype. The chain in JAX rounds each stage to the low dtype, the
kernel keeps float32 inside: that gap lies within the low dtype's rounding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from blindno_torch.ops import _build
from blindno_torch.ops.fno_layer import (fno1d_layer_backward_plain, fno1d_layer_plain,
                                         fno2d_layer_backward_plain, fno2d_layer_plain)
from blindno_torch.ops.spectral import dft_matrices_2d, spectral_conv1d, spectral_conv2d

_INT_MAX = 2**31 - 1
_F32 = torch.float32
_LOW = (torch.bfloat16, torch.float16)


def _dtype(*tensors):
    """The dtype jnp's promotion gives the operands (None entries skipped)."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        if t is not None and t.dtype is not dtype:
            dtype = torch.promote_types(dtype, t.dtype)
    return dtype


def _f32(*tensors):
    """The operands with bfloat16 and float16 raised to float32; any other is passed as
    it is (a float64 one reaches the plain version, or the kernel's refusal)."""
    return tuple(t.float() if t is not None and t.dtype in _LOW else t for t in tensors)


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _forward_only(name, *tensors):
    if _needs_grad(*tensors):
        raise RuntimeError(f"{name} is forward only and has no backward yet; call it under "
                           "torch.no_grad() or torch.inference_mode()")


def _check_tensors(name, x, wr, wi, pk, pb):
    """Device, dtype and contiguity; ``pk`` may have any strides. Returns x's device
    index. Called on every launch, so it asks each tensor as little as it can."""
    if not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {x.device}")
    dev = x.get_device()
    for k, t in (("x", x), ("wr", wr), ("wi", wi), ("pk", pk), ("pb", pb)):
        if t is None:
            continue
        if t.dtype is not _F32 or t.get_device() != dev:
            raise ValueError(f"{name}: {k} must be float32 on {x.device}, "
                             f"got {t.dtype} on {t.device}")
        if k != "pk" and not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    return dev


def _check_pointwise(name, c, cout, pk, pb):
    if pk is not None and (pk.shape != (c, cout) or pb.shape != (cout,)):
        raise ValueError(f"{name}: want pk ({c}, {cout}) and pb ({cout},), "
                         f"got {tuple(pk.shape)}, {tuple(pb.shape)}")


def _check_indexing(name, *numels):
    if max(numels) > _INT_MAX:
        raise ValueError(f"{name}: tensors too large for the kernel's 32-bit indexing")


def _raise_on_error(lib, name, err):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err} "
                           f"({lib.blindno_error_string(err).decode()})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check2d(name, x, wr, wi, pk, pb):
    """The 2-D kernel's checks; returns x's device index."""
    dev = _check_tensors(name, x, wr, wi, pk, pb)
    if x.dim() != 4 or wr.dim() != 4 or wr.shape != wi.shape:
        raise ValueError(f"{name}: want x (B, C, H, W) and wr, wi (C, Cout, 2*m1, m2) of one "
                         f"shape, got {tuple(x.shape)}, {tuple(wr.shape)}, {tuple(wi.shape)}")
    b, c, h, w = x.shape
    if wr.shape[0] != c or wr.shape[2] % 2 or wr.shape[2] == 0 or wr.shape[3] == 0:
        raise ValueError(f"{name}: weights {tuple(wr.shape)} do not fit x {tuple(x.shape)}")
    cout = wr.shape[1]
    _check_pointwise(name, c, cout, pk, pb)
    _check_indexing(name, x.numel(), b * cout * h * w, wr.numel(),
                    2 * b * c * wr.shape[2] * wr.shape[3], 2 * b * cout * h * wr.shape[3])
    return dev


def _launch2d(name, x, wr, wi, pk, pb, epilogue):
    dev = _check2d(name, x, wr, wi, pk, pb)
    lib = _build.library()
    b, c, h, w = x.shape
    cout, k, m2 = wr.shape[1:]
    mats = dft_matrices_2d(h, w, k // 2, m2, x.dtype, x.device)
    # scratch of the kernel's three stages: the spectrum (m2, B*C, 2*m1, re/im) and the
    # inverse-H output Z (B, Cout, H, m2, re/im)
    spec = x.new_empty((m2, b * c, k, 2))
    z = x.new_empty((b, cout, h, m2, 2))
    out = x.new_empty((b, cout, h, w))
    pk_si, pk_so = pk.stride() if pk is not None else (0, 0)
    err = lib.fno2d_layer_forward(
        _ptr(x), *map(_ptr, mats), _ptr(wr), _ptr(wi), _ptr(pk), pk_si, pk_so, _ptr(pb),
        _ptr(spec), _ptr(z), _ptr(out), b, c, cout, h, w, k // 2, m2, epilogue, dev,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(lib, name, err)
    return out


def _launch1d(name, x, wr, wi, pk, pb, dc_half, epilogue):
    dev = _check_tensors(name, x, wr, wi, pk, pb)
    xs, ws = x.shape, wr.shape
    if len(xs) != 3 or len(ws) != 3 or ws != wi.shape:
        raise ValueError(f"{name}: want x (B, C, N) and wr, wi (C, Cout, modes) of one shape, "
                         f"got {tuple(xs)}, {tuple(ws)}, {tuple(wi.shape)}")
    b, c, n = xs
    cin, cout, modes = ws
    if cin != c or c == 0 or not 1 <= modes <= n // 2 + 1:
        raise ValueError(f"{name}: weights {tuple(ws)} do not fit x {tuple(xs)} "
                         f"(want {c} input channels and 1 <= modes <= N//2+1)")
    _check_pointwise(name, c, cout, pk, pb)
    _check_indexing(name, b * c * n, b * cout * n, cin * cout * modes)
    out = torch.empty_like(x) if cout == c else x.new_empty((b, cout, n))
    if pk is None:
        pk_ptr = pb_ptr = pk_si = pk_so = 0
    else:
        pk_ptr, pb_ptr = pk.data_ptr(), pb.data_ptr()
        pk_si, pk_so = pk.stride()
    lib = _build.library()
    err = lib.fno1d_layer_forward(
        x.data_ptr(), wr.data_ptr(), wi.data_ptr(), pk_ptr, pk_si, pk_so, pb_ptr,
        out.data_ptr(), b, c, cout, n, modes, 1 if dc_half else 0, epilogue, dev,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        _raise_on_error(lib, name, err)
    return out


def _fno1d_layer(x, wr, wi, pk, pb, dc_half, apply_act):
    if x.device.type == "cpu":
        return fno1d_layer_plain(x, wr, wi, pk, pb, dc_half, apply_act)
    out = _launch1d("fno1d_layer_cuda", x, wr, wi, pk, pb, dc_half, 2 if apply_act else 1)
    fno1d_layer_cuda.launches += 1
    return out


class FNO1dLinear(torch.autograd.Function):
    """The FNO1d layer's linear part ``spectral_conv1d(x) + pk^T x + pb`` with its
    gradient (counterpart of ``_linear1d``, ``blindno/ops/fno_layer.py:36-69``): the
    kernel with no activation forward (its plain version on the CPU), and
    :func:`fno1d_layer_backward_plain` backward. ``dc_half`` is not a tensor and gets no
    gradient; ``dpk`` comes back in the layout of the ``pk`` it was given, as in
    :class:`FNO2dLinear`."""

    @staticmethod
    def forward(ctx, x, wr, wi, pk, pb, dc_half):
        ctx.save_for_backward(x, wr, wi, pk)
        ctx.dc_half, ctx.dtypes = dc_half, (x.dtype, wr.dtype, wi.dtype, pk.dtype, pb.dtype)
        u = _fno1d_layer(*_f32(x, wr, wi, pk, pb), dc_half, apply_act=False)
        return u.to(_dtype(x, wr, wi, pk, pb))

    @staticmethod
    def backward(ctx, du):
        x, wr, wi, pk, du = _f32(*ctx.saved_tensors, du)
        grads = fno1d_layer_backward_plain(x, wr, wi, pk, du.contiguous(), ctx.dc_half)
        return (*(g.to(d) for g, d in zip(grads, ctx.dtypes)), None)


def fno1d_layer_cuda(x, wr, wi, pk, pb, dc_half: bool = True, apply_act: bool = True):
    """One FNO1d layer. x: (B, Cin, N); wr/wi: (Cin, Cout, modes); pk: (Cin, Cout)
    (any strides); pb: (Cout,); float32, or a low precision computed in float32 (see the
    module note). ``dc_half`` halves the DC coefficient before the mix. Returns
    (B, Cout, N).

    Under no_grad or inference_mode, one call with gelu fused into the kernel's
    epilogue; where autograd needs a gradient, :class:`FNO1dLinear` and gelu after it."""
    if _needs_grad(x, wr, wi, pk, pb):
        u = FNO1dLinear.apply(x, wr, wi, pk, pb, dc_half)
        return F.gelu(u) if apply_act else u
    out = _fno1d_layer(*_f32(x, wr, wi, pk, pb), dc_half, apply_act)
    return out.to(_dtype(x, wr, wi, pk, pb))


def spectral_conv1d_cuda(x, wr, wi, dc_half: bool = True):
    """Spectral convolution alone. x: (B, Cin, N); wr/wi: (Cin, Cout, modes); float32,
    or a low precision computed in float32."""
    _forward_only("spectral_conv1d_cuda", x, wr, wi)
    dtype, (x, wr, wi) = _dtype(x, wr, wi), _f32(x, wr, wi)
    if x.device.type == "cpu":
        return spectral_conv1d(x, wr, wi, dc_half).to(dtype)
    out = _launch1d("spectral_conv1d_cuda", x, wr, wi, None, None, dc_half, 0)
    spectral_conv1d_cuda.launches += 1
    return out.to(dtype)


def _fno2d_layer(x, wr, wi, pk, pb, apply_act):
    if x.device.type == "cpu":
        return fno2d_layer_plain(x, wr, wi, pk, pb, apply_act)
    out = _launch2d("fno2d_layer_cuda", x, wr, wi, pk, pb, 2 if apply_act else 1)
    fno2d_layer_cuda.launches += 1
    return out


class FNO2dLinear(torch.autograd.Function):
    """The FNO2d layer's linear part ``spectral_conv2d(x) + pk^T x + pb`` with its
    gradient (counterpart of ``_linear2d``, ``blindno/ops/fno_layer.py:88-135``): the
    kernel with no activation forward (its plain version on the CPU), and
    :func:`fno2d_layer_backward_plain` backward. ``dpk`` comes back in the layout of the
    ``pk`` it was given, so a transposed view gets its gradient through autograd."""

    @staticmethod
    def forward(ctx, x, wr, wi, pk, pb):
        ctx.save_for_backward(x, wr, wi, pk)
        ctx.dtypes = (x.dtype, wr.dtype, wi.dtype, pk.dtype, pb.dtype)
        u = _fno2d_layer(*_f32(x, wr, wi, pk, pb), apply_act=False)
        return u.to(_dtype(x, wr, wi, pk, pb))

    @staticmethod
    def backward(ctx, du):
        x, wr, wi, pk, du = _f32(*ctx.saved_tensors, du)
        grads = fno2d_layer_backward_plain(x, wr, wi, pk, du.contiguous())
        return tuple(g.to(d) for g, d in zip(grads, ctx.dtypes))


def fno2d_layer_cuda(x, wr, wi, pk, pb, apply_act: bool = True):
    """One FNO2d layer. x: (B, Cin, H, W); wr/wi: (Cin, Cout, 2*m1, m2); pk: (Cin, Cout)
    (any strides); pb: (Cout,); float32, or a low precision computed in float32 (see the
    module note). Returns (B, Cout, H, W).

    Under no_grad or inference_mode, one call with gelu fused into the kernel's
    epilogue; where autograd needs a gradient, :class:`FNO2dLinear` and gelu after it."""
    if _needs_grad(x, wr, wi, pk, pb):
        u = FNO2dLinear.apply(x, wr, wi, pk, pb)
        return F.gelu(u) if apply_act else u
    out = _fno2d_layer(*_f32(x, wr, wi, pk, pb), apply_act)
    return out.to(_dtype(x, wr, wi, pk, pb))


def spectral_conv2d_cuda(x, wr, wi):
    """Spectral convolution alone. x: (B, Cin, H, W); wr/wi: (Cin, Cout, 2*m1, m2);
    float32, or a low precision computed in float32."""
    _forward_only("spectral_conv2d_cuda", x, wr, wi)
    dtype, (x, wr, wi) = _dtype(x, wr, wi), _f32(x, wr, wi)
    if x.device.type == "cpu":
        return spectral_conv2d(x, wr, wi).to(dtype)
    out = _launch2d("spectral_conv2d_cuda", x, wr, wi, None, None, 0)
    spectral_conv2d_cuda.launches += 1
    return out.to(dtype)


fno1d_layer_cuda.launches = 0
spectral_conv1d_cuda.launches = 0
fno2d_layer_cuda.launches = 0
spectral_conv2d_cuda.launches = 0
