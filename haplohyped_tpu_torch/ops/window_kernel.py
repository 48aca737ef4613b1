"""The Hopper window-encode kernel and its wrapper.

:func:`encode_windows_kernel` computes what :func:`haplohyped_tpu_torch.ops.
haplotype_window.encode_haplotype_windows` computes, bit for bit, in one
launch of ``csrc/window_kernel.cu`` per batch.  It replaces the JAX package's
Pallas kernel ``haplohyped_tpu/ops/pallas_window.py::_window_kernel``.

:func:`build_window_index` prepares, once per dataset and with torch ops on
the device, what the kernel reads besides the genome and cohort tensors: the
packed substitution codes ``sub12 = sub1 | sub2 << 8`` (phase selection does
not depend on the window) and the coarse search grid ``pos[..., ::SP]``.

On a CPU tensor the wrapper runs the plain version.  On a CUDA tensor it
launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from haplohyped_tpu_torch.ops import _build
from haplohyped_tpu_torch.ops.haplotype_window import (
    HaplotypeWindows,
    encode_haplotype_windows,
)

#: coarse-grid stride: the kernel's first search level reads pos[row, ::SP],
#: its second one chunk of SP positions
SP = 512

#: the kernel stages at most this many applied variants per window
K_MAX = 128


class WindowIndex(NamedTuple):
    """Device tensors of one dataset, for the kernel and the plain version."""

    genome: torch.Tensor  # (G,) int8
    offsets: torch.Tensor  # (C,) int32
    pos: torch.Tensor  # (D, C, V) int32, sorted per row, INT32_MAX padded
    ref: torch.Tensor  # (D, C, V) int8
    alt: torch.Tensor  # (D, C, V) int8
    p1: torch.Tensor  # (D, C, V) int8
    p2: torch.Tensor  # (D, C, V) int8
    counts: torch.Tensor  # (D, C) int32
    sub12: torch.Tensor  # (D, C, V) int16 — sub1 | sub2 << 8
    grid: torch.Tensor  # (D, C, ceil(V / SP)) int32 — pos[..., ::SP]

    @property
    def plain_args(self) -> tuple:
        """The plain version's operands, in its argument order."""
        return (self.genome, self.offsets, self.pos, self.ref, self.alt,
                self.p1, self.p2, self.counts)


def build_window_index(genome, offsets, pos, ref, alt, p1, p2, counts) -> WindowIndex:
    """Build the kernel's index with torch ops on the tensors' device.

    Checks once (one device sync) that REF/ALT codes lie in [0, 128), so the
    packed ``sub12`` holds both codes exactly."""
    for name, codes in (("ref", ref), ("alt", alt)):
        if codes.numel():
            lo, hi = (int(v) for v in torch.aminmax(codes))
            if lo < 0 or hi >= 128:
                raise ValueError(f"{name} codes must lie in [0, 128), got [{lo}, {hi}]")
    sub1 = torch.where(p1 == 1, alt, ref).to(torch.int16)
    sub2 = torch.where(p2 == 1, alt, ref).to(torch.int16)
    sub12 = sub1 | (sub2 << 8)
    del sub1, sub2
    grid = pos[..., ::SP].contiguous()
    return WindowIndex(genome, offsets, pos, ref, alt, p1, p2, counts, sub12, grid)


def _check(index: WindowIndex, donor_idx, chrom_idx, start, L: int, K: int, sp: int = SP):
    """Raise on what the kernel does not take; ``sp`` is the grid's stride."""
    dev = start.device
    want = {
        "genome": torch.int8, "offsets": torch.int32, "pos": torch.int32,
        "counts": torch.int32, "sub12": torch.int16, "grid": torch.int32,
    }
    tensors = {name: getattr(index, name) for name in want}
    tensors.update(donor_idx=donor_idx, chrom_idx=chrom_idx, start=start)
    want.update(donor_idx=torch.int32, chrom_idx=torch.int32, start=torch.int32)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, start is on {dev}")
        if t.dtype != want[name]:
            raise TypeError(f"{name} must be {want[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if start.dim() != 1:
        raise ValueError("start must be (B,)")
    D, C, V = index.pos.shape
    B = start.shape[0]
    G = index.genome.shape[0]
    if index.sub12.shape != (D, C, V) or index.counts.shape != (D, C):
        raise ValueError("sub12/counts shapes do not match pos")
    if index.grid.shape != (D, C, -(-V // sp)) or index.offsets.shape != (C,):
        raise ValueError("grid/offsets shapes do not match pos")
    if donor_idx.shape != (B,) or chrom_idx.shape != (B,):
        raise ValueError("donor_idx and chrom_idx must be (B,), like start")
    if not 1 <= K <= K_MAX:
        raise ValueError(f"K={K} outside [1, {K_MAX}]")
    if not 1 <= L <= G:
        raise ValueError(f"L={L} outside [1, G={G}]")
    if V < 1 or D * C * V >= 2**63 or max(V, B) >= 2**31:
        raise ValueError(f"unsupported sizes D={D} C={C} V={V} B={B}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_kernel("window_kernel")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hh_window_encode.argtypes = [
        p, ctypes.c_longlong, p, p, p, p, p, i, i, i, i, i,
        p, p, p, i, i, i, p, p, p, p, p,
    ]
    lib.hh_window_encode.restype = ctypes.c_int
    lib.hh_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hh_cuda_error_string.restype = ctypes.c_char_p
    return lib


def encode_windows_kernel(
    index: WindowIndex,
    donor_idx: torch.Tensor,  # (B,) int32
    chrom_idx: torch.Tensor,  # (B,) int32
    start: torch.Tensor,  # (B,) int32 window start within chrom
    *,
    L: int,
    K: int,
) -> HaplotypeWindows:
    """Encode a batch of windows: the Hopper kernel for CUDA tensors, the
    plain version for CPU tensors.  ``encode_windows_kernel.launches`` counts
    the kernel's launches."""
    if start.device.type == "cpu":
        return encode_haplotype_windows(
            *index.plain_args, donor_idx, chrom_idx, start, L=L, K=K
        )
    if start.device.type != "cuda":
        raise ValueError(f"no window kernel for device {start.device}")
    _check(index, donor_idx, chrom_idx, start, L, K)
    D, C, V = index.pos.shape
    B = start.shape[0]
    hap1 = torch.empty((B, L), dtype=torch.int8, device=start.device)
    hap2 = torch.empty((B, L), dtype=torch.int8, device=start.device)
    n_variants = torch.empty((B,), dtype=torch.int32, device=start.device)
    overflow = torch.empty((B,), dtype=torch.int32, device=start.device)
    if B == 0:
        return HaplotypeWindows(hap1, hap2, n_variants, overflow)
    lib = _library()
    with torch.cuda.device(start.device):
        stream = torch.cuda.current_stream(start.device).cuda_stream
        rc = lib.hh_window_encode(
            index.genome.data_ptr(), index.genome.shape[0],
            index.offsets.data_ptr(), index.pos.data_ptr(),
            index.sub12.data_ptr(), index.grid.data_ptr(),
            index.counts.data_ptr(), D, C, V, index.grid.shape[2], SP,
            donor_idx.data_ptr(), chrom_idx.data_ptr(), start.data_ptr(),
            B, L, K, hap1.data_ptr(), hap2.data_ptr(),
            n_variants.data_ptr(), overflow.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"window kernel launch failed: {lib.hh_cuda_error_string(rc).decode()}"
        )
    encode_windows_kernel.launches += 1
    return HaplotypeWindows(hap1, hap2, n_variants, overflow)


encode_windows_kernel.launches = 0
