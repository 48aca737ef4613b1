"""Enformer's conv-block prologue, batch norm then the published GELU: the
Hopper kernels, their autograd function and the plain version.

:func:`batchnorm_gelu` computes ``gelu(batch_norm(x))`` over the channels
of a contiguous ``(N, C, L)`` tensor: in training mode the batch's
statistics (over N and L), with the moving averages updated as
``torch.nn.functional.batch_norm`` updates them (``momentum``, the unbiased
variance); in eval mode the moving statistics.  The statistics and the
affine are float32 parameters; the result has ``x``'s dtype.

- On a CUDA tensor it is :class:`BatchNormGelu`, whose forward and backward
  are the launches of ``csrc/batchnorm_gelu.cu``: everything between the
  input and the output in float32, rounded once, and only ``x`` and four
  floats a channel kept for the backward.  It refuses what the kernels do
  not take (a non-contiguous ``x`` or one off a 16-byte boundary, ``L``
  times the element size not a multiple of 16 bytes, a dtype other than
  bf16 or float32) and never falls back; an output gradient that is not
  contiguous or off a 16-byte boundary is copied first.  Its gradients
  cannot be differentiated again.
- On a CPU tensor it is :func:`batchnorm_gelu_plain`: ``F.batch_norm`` then
  :func:`gelu`, in float32 (float64 for a float64 input) and rounded once to
  ``x``'s dtype; on a float32 input, exactly those two ops.

``batchnorm_gelu.launches`` counts kernel launches (3 a training forward, 2
an eval forward, 3 a backward); ``batchnorm_gelu.forward_calls`` and
``batchnorm_gelu.backward_calls`` count the function's calls on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from haplohyped_tpu_torch.ops import _build

#: the published GELU's factor: ``sigmoid(1.702 x) x``
GELU_K = 1.702
#: the kernels' dtype codes
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The published GELU: ``sigmoid(1.702 x) x``."""
    return torch.sigmoid(GELU_K * x) * x


def batchnorm_gelu_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         moving_mean: torch.Tensor, moving_variance: torch.Tensor,
                         training: bool, momentum: float, eps: float) -> torch.Tensor:
    """:func:`batchnorm_gelu` in torch ops, differentiated by autograd."""
    wide = x.to(torch.promote_types(x.dtype, torch.float32))
    y = F.batch_norm(wide, moving_mean, moving_variance, scale, bias, training, momentum, eps)
    return gelu(y).to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_kernel("batchnorm_gelu")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hh_bngelu_parts.argtypes = [i, i, i, i]
    lib.hh_bngelu_parts.restype = i
    lib.hh_bngelu_forward.argtypes = [p, i, i, i, i, p, p, p, p, f, f, i, p, p, p, p]
    lib.hh_bngelu_forward.restype = i
    lib.hh_bngelu_backward.argtypes = [p, p, i, i, i, i, p, i, p, p, p, p, p, p]
    lib.hh_bngelu_backward.restype = i
    lib.hh_bngelu_error_string.argtypes = [i]
    lib.hh_bngelu_error_string.restype = ctypes.c_char_p
    return lib


def load() -> None:
    """Build and load the kernels now (a model on a CUDA device calls this
    at construction, so the first build falls in set-up)."""
    _library()


def _parts(x: torch.Tensor, params: tuple) -> int:
    """Partials a channel of the launch; raise on what the kernels refuse."""
    if x.dim() != 3 or x.dtype not in _DTYPES:
        raise ValueError(f"the kernels take a bf16 or float32 (N, C, L) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the kernels take a contiguous x on a 16-byte boundary")
    N, C, L = x.shape
    for t in params:
        if t.dtype != torch.float32 or t.shape != (C,) or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"parameters and moving statistics must be contiguous float32 "
                             f"({C},) tensors on {x.device}")
    if not x.is_cuda:
        raise ValueError(f"the kernels take a CUDA tensor, got one on {x.device}")
    parts = _library().hh_bngelu_parts(_DTYPES[x.dtype], N, C, L)
    if parts == 0:
        raise ValueError(f"the kernels refuse (N, C, L) = {(N, C, L)} in {x.dtype}: L "
                         f"times the element size must be a multiple of 16 bytes")
    return parts


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"batchnorm_gelu {what} launch failed: "
                           f"{_library().hh_bngelu_error_string(rc).decode()}")


def _forward_kernel(x, scale, bias, moving_mean, moving_variance, training, momentum, eps):
    parts = _parts(x, (scale, bias, moving_mean, moving_variance))
    N, C, L = x.shape
    dev = x.device
    partial = torch.empty((C, parts, 4), dtype=torch.float32, device=dev) if training else None
    coef = torch.empty((C, 4), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().hh_bngelu_forward(
            x.data_ptr(), _DTYPES[x.dtype], N, C, L, scale.data_ptr(), bias.data_ptr(),
            moving_mean.data_ptr(), moving_variance.data_ptr(), momentum, eps, int(training),
            None if partial is None else partial.data_ptr(), coef.data_ptr(), out.data_ptr(),
            stream)
    _check(rc, "forward")
    batchnorm_gelu.launches += 3 if training else 2
    batchnorm_gelu.forward_calls += 1
    return out, coef


def _backward_kernel(x, dz, coef, training):
    parts = _parts(x, ())
    N, C, L = x.shape
    dev = x.device
    if dz.dtype != x.dtype or dz.shape != x.shape or dz.device != x.device:
        raise ValueError(f"the output's gradient is {dz.dtype} {tuple(dz.shape)} on "
                         f"{dz.device}, the input {x.dtype} {tuple(x.shape)} on {x.device}")
    if not dz.is_contiguous() or dz.data_ptr() % 16:
        # the kernels read dz in 16-byte vectors: a fresh contiguous copy is aligned
        dz = dz.clone(memory_format=torch.contiguous_format)
    partial = torch.empty((C, parts, 2), dtype=torch.float32, device=dev)
    gcoef = torch.empty((C, 2), dtype=torch.float32, device=dev)
    dscale = torch.empty(C, dtype=torch.float32, device=dev)
    dbias = torch.empty(C, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().hh_bngelu_backward(
            x.data_ptr(), dz.data_ptr(), _DTYPES[x.dtype], N, C, L, coef.data_ptr(),
            int(training), partial.data_ptr(), gcoef.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), dx.data_ptr(), stream)
    _check(rc, "backward")
    batchnorm_gelu.launches += 3
    batchnorm_gelu.backward_calls += 1
    return dx, dscale, dbias


class BatchNormGelu(torch.autograd.Function):
    """``gelu(batch_norm(x))`` on a CUDA tensor through the kernels, whose
    backward recomputes the normalised value and the GELU's derivative from
    ``x`` and ``coef``.  Its gradients are written by the kernels, so they
    cannot be differentiated again."""

    @staticmethod
    def forward(ctx, x, scale, bias, moving_mean, moving_variance, training, momentum, eps):
        out, coef = _forward_kernel(x, scale, bias, moving_mean, moving_variance, training,
                                    momentum, eps)
        ctx.save_for_backward(x, coef)
        ctx.training = training
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dz):
        x, coef = ctx.saved_tensors
        dx, dscale, dbias = _backward_kernel(x, dz, coef, ctx.training)
        return dx, dscale, dbias, None, None, None, None, None


def batchnorm_gelu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   moving_mean: torch.Tensor, moving_variance: torch.Tensor, training: bool,
                   momentum: float, eps: float) -> torch.Tensor:
    """``gelu(batch_norm(x))`` over the channels of ``(N, C, L)``: the
    kernels on a CUDA tensor, :func:`batchnorm_gelu_plain` on a CPU one."""
    if x.device.type == "cpu":
        return batchnorm_gelu_plain(x, scale, bias, moving_mean, moving_variance, training,
                                    momentum, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no batchnorm_gelu kernel for device {x.device}")
    return BatchNormGelu.apply(x, scale, bias, moving_mean, moving_variance, training,
                               momentum, eps)


batchnorm_gelu.launches = 0
batchnorm_gelu.forward_calls = 0
batchnorm_gelu.backward_calls = 0
