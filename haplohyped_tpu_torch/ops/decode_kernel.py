"""The Hopper VCF decode kernels and their wrappers.

:func:`decode_frames12_kernel` computes what :func:`haplohyped_tpu_torch.ops.
vcf_decode.decode_frames12_packed` computes, and :func:`decode_frames_kernel`
what :func:`~haplohyped_tpu_torch.ops.vcf_decode.decode_frames_packed`
computes, bit for bit, each in one launch of ``csrc/vcf_decode.cu``.  They
replace the JAX package's Pallas kernels ``haplohyped_tpu/ops/
pallas_decode.py::_decode12_kernel`` and ``::_decode_kernel``.

On a CPU tensor a wrapper runs the plain version.  On a CUDA tensor it
launches the kernel or raises; it never falls back.  An empty frame
launches nothing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from haplohyped_tpu_torch.hostio.frame_format import REC12_SIZE, REC_SIZE
from haplohyped_tpu_torch.ops import _build
from haplohyped_tpu_torch.ops.vcf_decode import (
    decode_frames12_packed,
    decode_frames_packed,
)

#: int32 output columns of each kernel
N_OUT12, N_OUT64 = 3, 7


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_kernel("vcf_decode")
    p = ctypes.c_void_p
    for fn in (lib.hh_decode12, lib.hh_decode64):
        fn.argtypes = [p, ctypes.c_longlong, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
    lib.hh_decode_error_string.argtypes = [ctypes.c_int]
    lib.hh_decode_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, frames: torch.Tensor, width: int, n_out: int, with_sample: bool,
            align: int) -> tuple[torch.Tensor, ...]:
    if frames.dtype != torch.uint8 or frames.dim() != 2 or frames.shape[1] != width:
        raise ValueError(
            f"frames must be (N, {width}) uint8, got {tuple(frames.shape)} {frames.dtype}"
        )
    frames = frames.contiguous()
    if frames.data_ptr() % align:
        raise ValueError(f"{name}: frames must start on a {align}-byte boundary")
    n = frames.shape[0]
    out = torch.empty((n_out, n), dtype=torch.int32, device=frames.device)
    if n == 0:
        return tuple(out)
    lib = _library()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = getattr(lib, name)(frames.data_ptr(), n, int(with_sample), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.hh_decode_error_string(rc).decode()}"
        )
    return tuple(out)


def decode_frames12_kernel(
    frames: torch.Tensor, with_sample: bool = True
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode ``(N, 12)`` uint8 compact frames into ``(start, meta,
    ref_len)`` int32: the Hopper kernel for CUDA tensors, the plain version
    for CPU tensors.  ``decode_frames12_kernel.launches`` counts the
    kernel's launches."""
    if frames.device.type == "cpu":
        return decode_frames12_packed(frames, with_sample)
    if frames.device.type != "cuda":
        raise ValueError(f"no decode12 kernel for device {frames.device}")
    out = _launch("hh_decode12", frames, REC12_SIZE, N_OUT12, with_sample, align=4)
    if frames.shape[0]:
        decode_frames12_kernel.launches += 1
    return out


def decode_frames_kernel(frames: torch.Tensor, with_sample: bool = True) -> tuple[torch.Tensor, ...]:
    """Decode ``(N, 64)`` uint8 frames into the seven int32 columns
    ``(start, stop, ref_char, alt_char, phase1, phase2, flags)``: the Hopper
    kernel for CUDA tensors, the plain version for CPU tensors.
    ``decode_frames_kernel.launches`` counts the kernel's launches."""
    if frames.device.type == "cpu":
        return decode_frames_packed(frames, with_sample)
    if frames.device.type != "cuda":
        raise ValueError(f"no decode64 kernel for device {frames.device}")
    out = _launch("hh_decode64", frames, REC_SIZE, N_OUT64, with_sample, align=16)
    if frames.shape[0]:
        decode_frames_kernel.launches += 1
    return out


decode_frames12_kernel.launches = 0
decode_frames_kernel.launches = 0
