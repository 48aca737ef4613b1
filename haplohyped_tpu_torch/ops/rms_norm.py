"""RMSNorm, and Mamba-2's gated RMSNorm: the Hopper kernels, their autograd
function and the plain version.

:func:`rms_norm` computes, over the last dimension ``D`` of ``x``,
``u * rsqrt(mean(u^2) + eps) * weight`` with ``u = x * silu(gate)`` where a
gate is given (Mamba-2's mixer: ``rmsnorm(y * silu(z)) * w``) and ``u = x``
where not.  With a ``group`` narrower than ``D`` the mean is over each group
of ``group`` consecutive columns on its own (Mamba-2's mixer with several
groups of ``B`` and ``C``); by default over the whole row.  Everything
between the inputs and the output is float32 (float64 for a float64 input),
rounded once to ``x``'s dtype; ``weight`` is the float32 ``(D,)`` parameter,
and its gradient is float32.

- On a CUDA tensor it is :class:`RmsNorm`, whose forward is one launch of
  ``csrc/rms_norm.cu`` and whose backward is two: a row is read once in
  each direction, and only ``x``, ``gate`` (the views the caller holds) and
  one float32 ``rstd`` a row (a group) are kept for the backward.  ``x``, ``gate`` and
  the output's gradient are read through a row stride, so a gate that is a
  column slice of a wider tensor is read in place.  It refuses what the
  kernels do not take (a dtype other than bf16 or float32, ``D`` not a
  multiple of 8 or past 8,192 bf16 or 4,096 float32 elements, rows that are
  not one stride apart with contiguous elements, a row or start off a
  16-byte boundary, a gate of another shape or dtype, a weight that is not
  a contiguous float32 ``(D,)`` tensor; a ``group`` that does not divide
  ``D`` into multiples of 256 bf16 or 128 float32 columns, or a group
  narrower than the row without a gate) and never falls back; an output
  gradient off those rules is copied first.  Its gradients cannot be
  differentiated again.
- On a CPU tensor it is :func:`rms_norm_plain`, the same function in torch
  ops, differentiated by autograd.

``rms_norm.launches`` counts kernel launches (1 a forward, 2 a backward);
``rms_norm.forward_calls``, ``rms_norm.gated_calls`` (forward calls with a
gate) and ``rms_norm.backward_calls`` count the function's calls on the
card.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from haplohyped_tpu_torch.ops import _build

#: the kernels' dtype codes
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float,
                   gate: torch.Tensor | None = None, group: int | None = None) -> torch.Tensor:
    """:func:`rms_norm` in torch ops, differentiated by autograd."""
    u = x.to(torch.promote_types(x.dtype, torch.float32))
    if gate is not None:
        u = u * F.silu(gate.to(u.dtype))
    D = x.shape[-1]
    if group is not None and group != D:
        if D % group:
            raise ValueError(f"a group of {group} does not divide the row of {D}")
        u = u.unflatten(-1, (D // group, group))
        u = (u * torch.rsqrt(u.pow(2).mean(-1, keepdim=True) + eps)).flatten(-2)
        return (u * weight).to(x.dtype)
    return (u * torch.rsqrt(u.pow(2).mean(-1, keepdim=True) + eps) * weight).to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_kernel("rms_norm")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.hh_rmsnorm_parts.argtypes = [i, i, i]
    lib.hh_rmsnorm_parts.restype = i
    lib.hh_rmsnorm_group_ok.argtypes = [i, i, i]
    lib.hh_rmsnorm_group_ok.restype = i
    lib.hh_rmsnorm_forward.argtypes = [p, ll, p, ll, i, i, i, i, p, f, p, p, p]
    lib.hh_rmsnorm_forward.restype = i
    lib.hh_rmsnorm_backward.argtypes = [p, ll, p, ll, p, ll, i, i, i, i, p, p, p, p, p, p, p]
    lib.hh_rmsnorm_backward.restype = i
    lib.hh_rmsnorm_error_string.argtypes = [i]
    lib.hh_rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def load() -> None:
    """Build and load the kernels now (a model on a CUDA device calls this
    at construction, so the first build falls in set-up)."""
    _library()


#: the widest row the kernels hold: 128 threads x 8 vectors of 16 bytes
_MAX_ROW_BYTES = 128 * 8 * 16


def _rows(t: torch.Tensor, what: str) -> tuple[int, int]:
    """``(rows, row stride in elements)`` of ``t`` as rows of its last
    dimension; raise where the kernels cannot read it so."""
    if t.stride(-1) != 1:
        raise ValueError(f"the kernels take {what} with contiguous rows, got strides "
                         f"{t.stride()}")
    stride = t.stride(-2) if t.dim() > 1 else t.shape[-1]
    for k in range(t.dim() - 2):  # the leading dimensions must merge into one of rows
        if t.shape[k] > 1 and t.stride(k) != t.stride(k + 1) * t.shape[k + 1]:
            raise ValueError(f"the kernels take {what} whose rows lie one stride apart, got "
                             f"shape {tuple(t.shape)} and strides {t.stride()}")
    if t.data_ptr() % 16 or stride * t.element_size() % 16:
        raise ValueError(f"the kernels take {what} on a 16-byte boundary with rows a multiple "
                         f"of 16 bytes apart, got a row stride of {stride} elements")
    return t.numel() // t.shape[-1], stride


def _check_inputs(x: torch.Tensor, weight: torch.Tensor, gate: torch.Tensor | None,
                  group: int | None = None):
    """Rows and row strides of ``x`` and ``gate``; raise on what the kernels
    refuse (the device last, so a CPU tensor reaches the checks a card's
    does)."""
    if x.dtype not in _DTYPES or x.dim() < 1:
        raise ValueError(f"the kernels take a bf16 or float32 x of at least one dimension, "
                         f"got {x.dtype} {tuple(x.shape)}")
    D = x.shape[-1]
    if D < 8 or D % 8 or D * x.element_size() > _MAX_ROW_BYTES:
        raise ValueError(f"the kernels take a row width that is a multiple of 8 up to "
                         f"{_MAX_ROW_BYTES // x.element_size()} in {x.dtype}, got {D}")
    if weight.dtype != torch.float32 or weight.shape != (D,) or not weight.is_contiguous() \
            or weight.data_ptr() % 16 or weight.device != x.device:
        raise ValueError(f"the weight must be a contiguous float32 ({D},) tensor on "
                         f"{x.device} on a 16-byte boundary, got {weight.dtype} "
                         f"{tuple(weight.shape)} on {weight.device}")
    if gate is not None and (gate.shape != x.shape or gate.dtype != x.dtype
                             or gate.device != x.device):
        raise ValueError(f"the gate must match x ({x.dtype} {tuple(x.shape)} on {x.device}), "
                         f"got {gate.dtype} {tuple(gate.shape)} on {gate.device}")
    if group is not None and group != D:
        vec = 16 // x.element_size()
        if group < 1 or D % group or group % (32 * vec):
            raise ValueError(f"the kernels take groups of a multiple of {32 * vec} columns "
                             f"that divide the row of {D}, got {group}")
        if gate is None:
            raise ValueError("the kernels take a group narrower than the row only with a gate")
    R, xs = _rows(x, "x")
    gs = _rows(gate, "the gate")[1] if gate is not None else 0
    if not x.is_cuda:
        raise ValueError(f"the kernels take a CUDA tensor, got one on {x.device}")
    if R < 1 or R >= 2**31:
        raise ValueError(f"the kernels take 1 to 2^31 - 1 rows, got {R}")
    return R, xs, gs


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"rms_norm {what} launch failed: "
                           f"{_library().hh_rmsnorm_error_string(rc).decode()}")


def _forward_kernel(x, weight, gate, eps, group):
    R, xs, gs = _check_inputs(x, weight, gate, group)
    D = x.shape[-1]
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rstd = torch.empty(R * (D // group), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _library().hh_rmsnorm_forward(
            x.data_ptr(), xs, None if gate is None else gate.data_ptr(), gs, _DTYPES[x.dtype],
            R, D, group, weight.data_ptr(), eps, out.data_ptr(), rstd.data_ptr(), stream)
    _check(rc, "forward")
    rms_norm.launches += 1
    rms_norm.forward_calls += 1
    rms_norm.gated_calls += gate is not None
    return out, rstd


def _backward_kernel(x, weight, gate, rstd, dout, group):
    R, xs, gs = _check_inputs(x, weight, gate, group)
    D = x.shape[-1]
    if dout.dtype != x.dtype or dout.shape != x.shape or dout.device != x.device:
        raise ValueError(f"the output's gradient is {dout.dtype} {tuple(dout.shape)} on "
                         f"{dout.device}, the input {x.dtype} {tuple(x.shape)} on {x.device}")
    try:
        ds = _rows(dout, "the output's gradient")[1]
    except ValueError:
        # the kernels read dout in 16-byte vectors a row: a fresh contiguous copy is aligned
        dout = dout.clone(memory_format=torch.contiguous_format)
        ds = D
    parts = _library().hh_rmsnorm_parts(_DTYPES[x.dtype], R, D)
    partial = torch.empty((parts, D), dtype=torch.float32, device=x.device)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dg = torch.empty(x.shape, dtype=x.dtype, device=x.device) if gate is not None else None
    dw = torch.empty(D, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _library().hh_rmsnorm_backward(
            x.data_ptr(), xs, None if gate is None else gate.data_ptr(), gs, dout.data_ptr(), ds,
            _DTYPES[x.dtype], R, D, group, weight.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            None if dg is None else dg.data_ptr(), partial.data_ptr(), dw.data_ptr(), stream)
    _check(rc, "backward")
    rms_norm.launches += 2
    rms_norm.backward_calls += 1
    return dx, dw, dg


class RmsNorm(torch.autograd.Function):
    """:func:`rms_norm` on a CUDA tensor through the kernels, whose backward
    recomputes ``u`` and the normalised row from ``x``, ``gate`` and
    ``rstd``.  Its gradients are written by the kernels, so they cannot be
    differentiated again."""

    @staticmethod
    def forward(ctx, x, weight, gate, eps, group):
        out, rstd = _forward_kernel(x, weight, gate, eps, group)
        ctx.group = group
        ctx.save_for_backward(x, weight, gate, rstd)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        x, weight, gate, rstd = ctx.saved_tensors
        dx, dw, dg = _backward_kernel(x, weight, gate, rstd, dout, ctx.group)
        return dx, dw, dg, None, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             gate: torch.Tensor | None = None, group: int | None = None) -> torch.Tensor:
    """``u * rsqrt(mean(u^2) + eps) * weight`` over the last dimension (or
    each ``group`` of its columns), ``u = x * silu(gate)`` or ``x``, in
    ``x``'s dtype: the kernels on a CUDA tensor, :func:`rms_norm_plain` on a
    CPU one."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps, gate, group)
    if x.device.type != "cuda":
        raise ValueError(f"no rms_norm kernel for device {x.device}")
    return RmsNorm.apply(x, weight, gate, eps, x.shape[-1] if group is None else group)


rms_norm.launches = 0
rms_norm.forward_calls = 0
rms_norm.gated_calls = 0
rms_norm.backward_calls = 0
